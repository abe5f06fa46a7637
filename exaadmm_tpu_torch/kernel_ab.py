"""A/B of the port's kernel sources on one GPU.

    python3 -m exaadmm_tpu_torch.kernel_ab [--arm NAME=DIR ...]
        [--groups 2,4,8] [--out FILE]

Every arm is built with the package's nvcc flags (``ops/_build.py``), one
nvcc process per source, all at once, into ``build/kernel_ab/<arm>/``; the
arms then run on the same batches, each checked against the first arm and
timed in turns (the arms in order, then in reverse; the device time of
each run from ``utils/timing.time_ms``, the mean of the two runs reported).

``--arm NAME=DIR`` adds an arm built from the CUDA sources in DIR, laid out
as ``csrc/`` (the ``.cu`` files of ``SOURCES`` and the headers), for example the
sources of a parent commit unpacked with ``git archive``. ``--groups``
adds one arm per group size G, built from the package's own ``csrc/`` with
``tron_alm::kGroup`` set to G. The first arm is the reference.

Batches (fp64 unless named; "it1" is the first inner iteration with the
prox targets perturbed by N(0, 0.05) from numpy seed 0 and step_cap 50, as
``chip_smoke.py`` phase 2 builds them; "steady" is the batch that follows 25
inner iterations of the main path's driver from its start state):

- branch: synthetic 9241 buses (15,710 lines) it1 in fp64 and fp32 and
  steady at rho (3e3, 3e5); synthetic 2869 buses x 8 periods (39,016 lines)
  it1 and steady at rho (4e2, 4e4); x 24 periods (117,048 lines) it1;
- ramp: synthetic 2869 buses x 8 periods (3,010 lanes) it1 and steady;
- qpsub: the synthetic 9241-bus QP (15,710 lanes) it1 with and without
  line limits, and steady at tron_step_cap 24 (``chip_smoke.py`` phase 6);
- bus scatter: the arc sums of synthetic 9241 buses (31,420 x 8) and of
  synthetic 2869 buses folded over 8 periods (9,754 x 64).

It also checks, on the card, that ``sincos`` gives the bits of ``sin`` and
``cos`` called apart, in fp64 and fp32, over the angle differences of the
branch batches and 2^22 angles spread over [-10, 10].

Prints one line per (batch, arm) and writes every number to FILE
(``build/kernel_ab/result.json`` by default).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops import _build, bus_cuda, tron_cuda
from .utils.timing import time_ms

ROOT = Path(__file__).resolve().parent.parent
AB_ROOT = ROOT / "build" / "kernel_ab"
SOURCES = ("tron_alm_branch", "tron_alm_ramp", "tron_alm_qpsub",
           "bus_scatter")
_GROUP_LINE = re.compile(r"constexpr int kGroup = \d+;")

# sin and cos in one kernel, sincos in another, so that the compiler
# cannot merge the two forms of one argument
_SINCOS_CU = r"""
#include <cuda_runtime.h>
#include <math.h>
__device__ void sc(double v, double* s, double* c) { sincos(v, s, c); }
__device__ void sc(float v, float* s, float* c) { sincosf(v, s, c); }
template <typename T>
__global__ void apart(const T* a, T* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = sin(a[i]);
  out[n + i] = cos(a[i]);
}
template <typename T>
__global__ void together(const T* a, T* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sc(a[i], out + 2 * n + i, out + 3 * n + i);
}
template <typename T>
int run(const void* a, void* out, int n) {
  apart<T><<<(n + 255) / 256, 256>>>((const T*)a, (T*)out, n);
  together<T><<<(n + 255) / 256, 256>>>((const T*)a, (T*)out, n);
  return (int)cudaGetLastError();
}
extern "C" int sincos_f64(const void* a, void* out, int n) {
  return run<double>(a, out, n);
}
extern "C" int sincos_f32(const void* a, void* out, int n) {
  return run<float>(a, out, n);
}
"""


def prepare_arms(arms: list[tuple[str, Path]], groups: list[int]):
    """Source directories of the arms under build/kernel_ab/<arm>/csrc."""
    out = []
    for name, src in arms:
        dst = AB_ROOT / name / "csrc"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        out.append((name, dst))
    for g in groups:
        dst = AB_ROOT / f"G{g}" / "csrc"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(_build.CSRC, dst)
        hdr = dst / "tron_alm.cuh"
        text, n = _GROUP_LINE.subn(f"constexpr int kGroup = {g};",
                                   hdr.read_text())
        if n != 1:
            raise RuntimeError("tron_alm.cuh: no kGroup constant to set")
        hdr.write_text(text)
        out.append((f"G{g}", dst))
    return out


def build_arms(arms) -> dict:
    """Compile every source of every arm (and the sincos check) at once;
    returns {arm: {source: library path}} and prints each kernel's
    registers and spills."""
    nvcc = _build._nvcc()
    procs, libs = [], {}
    (AB_ROOT / "sincos").mkdir(parents=True, exist_ok=True)
    sincos_src = AB_ROOT / "sincos" / "sincos.cu"
    sincos_src.write_text(_SINCOS_CU)
    jobs = [("sincos", "sincos", sincos_src)]
    for arm, src in arms:
        for name in SOURCES:
            jobs.append((arm, name, src / f"{name}.cu"))
    t0 = time.perf_counter()
    for arm, name, src in jobs:
        lib = src.parent.parent / f"lib{name}.so"
        log = src.parent.parent / f"{name}.log"
        f = open(log, "w")
        procs.append((arm, name, lib, log, f, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=f, stderr=subprocess.STDOUT)))
    for arm, name, lib, log, f, proc in procs:
        proc.wait()
        f.close()
        text = log.read_text()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {arm}/{name}:\n{text}")
        libs.setdefault(arm, {})[name] = lib
        if arm != "sincos":
            for ln in text.splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"build {arm} {name}: {ln.strip()}")
    print(f"build: {len(jobs)} sources in {time.perf_counter() - t0:.1f} s")
    return libs


def _load(path: Path, fns: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in fns.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check_sincos(path: Path, angles: torch.Tensor) -> dict:
    """Bitwise comparison of sincos with sin and cos on the card."""
    lib = _load(path, {f: [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       for f in ("sincos_f64", "sincos_f32")})
    out = {}
    for dtype, fn in ((torch.float64, lib.sincos_f64),
                      (torch.float32, lib.sincos_f32)):
        a = angles.to(dtype).contiguous()
        n = a.numel()
        res = torch.empty(4 * n, dtype=dtype, device=a.device)
        err = fn(a.data_ptr(), res.data_ptr(), n)
        if err != 0:
            raise RuntimeError(f"sincos check: CUDA error {err}")
        torch.cuda.synchronize()
        r = res.view(4, n)
        bad = int(((r[0] != r[2]) | (r[1] != r[3])).sum())
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(angles=n, differ=bad)
        print(f"sincos {key}: {bad} of {n} angles differ from sin and cos "
              f"in any bit")
    return out


def _tron_call(lib, inst, args):
    """Run an arm's TRON/ALM entry point on ``args`` (x0, xl, xu, packed
    params, lam0, mu0, active0, opts) as ``tron_cuda`` launches it."""
    x0, xl, xu, P, lam0, mu0, act, opts = args
    B = x0.shape[1]
    x, lam, mu = (torch.empty_like(x0), torch.empty_like(lam0),
                  torch.empty_like(mu0))
    minor = torch.empty(B, dtype=torch.int32, device=x0.device)
    alm = torch.empty(B, dtype=torch.int32, device=x0.device)
    cviol = torch.empty_like(mu0)
    cap = opts["step_cap"]
    if cap is None:
        cap = opts["max_minor"] * opts["max_auglag"]
    fn = getattr(lib, inst.name + tron_cuda._SUFFIX[x0.dtype])
    err = fn(*[t.data_ptr() for t in (x0, xl, xu, P, lam0, mu0, act, x, lam,
                                      mu, minor, alm, cviol)],
             B, opts["gtol"], opts["frtol"], opts["ctol"], opts["mu_max"],
             opts["max_minor"], opts["max_auglag"], cap,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{inst.name}: CUDA error {err}")
    return x, minor, alm


def _scatter_call(lib, args):
    vals, ptr, idx, nseg = args
    out = torch.empty((nseg, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    fn = getattr(lib, bus_cuda._FN[vals.dtype])
    err = fn(vals.data_ptr(), ptr.data_ptr(), idx.data_ptr(), out.data_ptr(),
             nseg, vals.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bus_scatter: CUDA error {err}")
    return out


def _perturb(t: torch.Tensor, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return t + torch.as_tensor(rng.normal(0, 0.05, tuple(t.shape))).to(
        device=t.device, dtype=t.dtype)


def _steady_par():
    """The two-level main path's parameters for up to 25 inner iterations
    from the start state: one outer iteration, no tolerance to stop at."""
    from .utils.environment import Parameters
    return Parameters(verbose=0, outer_iterlim=1, inner_iterlim=25,
                      outer_eps=0.0)


def batches(dev):
    """(label, instance or None, args) of every batch."""
    from .algorithms.admm_one_level import admm_one_level
    from .algorithms.admm_two_level import admm_two_level
    from .models.acopf import branch, kernels
    from .models.acopf import model as M
    from .models.mpacopf import model as MP
    from .models.mpacopf import ramp
    from .models.qpsub import model as Q
    from .models.qpsub.sqp import SqpBasePoint, build_qp_inputs
    from .utils.environment import Parameters
    from .utils.grid_data import build_grid_data
    from .utils.synthetic import synthetic_case, synthetic_load_profile

    big = synthetic_case(9241, seed=0, line_ratio=1.7)
    mp = synthetic_case(2869, seed=0, line_ratio=1.7)
    out = []

    def branch_args(sol, gd, par, it, dtype):
        x0, xl, xu, params, lam0, mu0, act = branch.branch_inputs(
            sol, gd, par, it)
        return (x0, xl, xu, tron_cuda.pack_params(params), lam0, mu0,
                act.to(torch.uint8).contiguous(),
                branch.branch_tolerances(par, dtype))

    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = M.build_model(big, par, dtype=dtype, device=dev)
        sol = M.init_solution(model, 4e2, 4e4)
        sol = sol.replace(v=sol.v.replace(line=_perturb(sol.v.line)))
        key = "f64" if dtype == torch.float64 else "f32"
        out.append((f"branch 9241 it1 {key}", tron_cuda.BRANCH,
                    branch_args(sol, model.grid, par, 1, dtype)))
    par = _steady_par()
    model = M.build_model(big, par, device=dev)
    sol, info = admm_two_level(model, M.init_solution(model, 3e3, 3e5))
    out.append(("branch 9241 steady", tron_cuda.BRANCH, branch_args(
        model.inner_prestep(sol), model.grid, par, info.cumul + 1,
        torch.float64)))
    vals = kernels.bus_arc_values(sol.u, sol.z, sol.l, sol.rho, model.grid)
    gd = model.grid
    out.append(("scatter 9241 arcs", None,
                (vals.contiguous(), gd.arc_ptr, gd.arc_idx, gd.nbus)))

    for T in (8, 24):
        loads = synthetic_load_profile(mp, T, seed=0)
        par = Parameters(verbose=0, tron_step_cap=50)
        model = MP.build_model(mp, par, *loads, end_period=T, device=dev)
        s0 = MP.init_solution(model, 4e2, 4e4)
        ac = s0.acopf
        ac = ac.replace(v=ac.v.replace(line=_perturb(ac.v.line)))
        out.append((f"branch 2869x{T} it1", tron_cuda.BRANCH, branch_args(
            model.flat_lines(ac), model.grid_T, par, 1, torch.float64)))
        if T != 8:
            continue
        v = s0.acopf.v
        s1 = s0.replace(acopf=s0.acopf.replace(
            v=v.replace(gen=_perturb(v.gen))))
        x0, xl, xu, params, lam0, mu0 = ramp.ramp_inputs(s1, model, 1)
        ones = torch.ones(x0.shape[1], dtype=torch.uint8, device=dev)
        out.append(("ramp 2869x8 it1", tron_cuda.RAMP, (
            x0, xl, xu, tron_cuda.pack_ramp_params(params), lam0, mu0, ones,
            ramp.ramp_tolerances(par, torch.float64))))
        par = _steady_par()
        model = MP.build_model(mp, par, *loads, end_period=T, device=dev)
        sol, info = admm_two_level(model, MP.init_solution(model, 4e2, 4e4))
        pre = model.inner_prestep(sol)
        out.append(("branch 2869x8 steady", tron_cuda.BRANCH, branch_args(
            model.flat_lines(pre.acopf), model.grid_T, par, info.cumul + 1,
            torch.float64)))
        x0, xl, xu, params, lam0, mu0 = ramp.ramp_inputs(pre, model,
                                                         info.cumul + 1)
        out.append(("ramp 2869x8 steady", tron_cuda.RAMP, (
            x0, xl, xu, tron_cuda.pack_ramp_params(params), lam0, mu0, ones,
            ramp.ramp_tolerances(par, torch.float64))))
        a = sol.acopf
        vals = kernels.bus_arc_values(a.u, a.z, a.l, a.rho, model.grid)
        folded = vals.permute(1, 0, 2).reshape(vals.shape[1], -1)
        g = model.grid
        out.append(("scatter 2869x8 arcs folded", None,
                    (folded.contiguous(), g.arc_ptr, g.arc_idx, g.nbus)))

    qp = build_qp_inputs(big, build_grid_data(big), SqpBasePoint(
        pg=big.Pg0, qg=big.Qg0, vm=big.Vm, va=big.Va))
    for limits in (True, False):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = Q.build_model(big, par, qp, use_linelimit=limits, device=dev)
        s = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
        b = s.base
        rng = np.random.default_rng(0)

        def noise():
            return torch.as_tensor(rng.normal(0, 0.05, tuple(
                b.l.line.shape))).to(device=dev, dtype=torch.float64)

        s = s.replace(base=b.replace(l=b.l.replace(line=b.l.line + noise()),
                                     v=b.v.replace(line=b.v.line + noise())))
        x0, xl, xu, params, lam0, mu0, act = Q.qpsub_inputs(model, s, 1)
        out.append((f"qpsub 9241 it1{'' if limits else ' no limits'}",
                    tron_cuda.QPSUB, (
                        x0, xl, xu,
                        tron_cuda.pack_qpsub_params(params).contiguous(),
                        lam0, mu0, act.to(torch.uint8).contiguous(),
                        Q.qpsub_tolerances(par, torch.float64, limits))))
    # one-level: 25 iterations of its one loop
    par = Parameters(verbose=0, outer_iterlim=25, outer_eps=0.0,
                     tron_step_cap=24)
    model = Q.build_model(big, par, qp, device=dev)
    sol, info = admm_one_level(model, Q.init_solution(model, 4e3, 4e3))
    x0, xl, xu, params, lam0, mu0, act = Q.qpsub_inputs(
        model.solve_prep(sol), sol, info.cumul + 1)
    out.append(("qpsub 9241 steady", tron_cuda.QPSUB, (
        x0, xl, xu, tron_cuda.pack_qpsub_params(params).contiguous(), lam0,
        mu0, act.to(torch.uint8).contiguous(),
        Q.qpsub_tolerances(par, torch.float64, True))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", action="append", default=[],
                    help="NAME=DIR of CUDA sources laid out as csrc/")
    ap.add_argument("--groups", default="",
                    help="comma-separated group sizes of the package's body")
    ap.add_argument("--out", default=str(AB_ROOT / "result.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    arms = [(a.split("=", 1)[0], Path(a.split("=", 1)[1]))
            for a in args.arm]
    groups = [int(g) for g in args.groups.split(",") if g]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    src_arms = prepare_arms(arms, groups)
    libs = build_arms(src_arms)
    names = [a for a, _ in src_arms]
    loaded = {a: {n: _load(libs[a][n], {
        **{n + s: tron_cuda._SIG for s in ("_f64", "_f32")}}
        if n != "bus_scatter" else {f: bus_cuda._SIG
                                    for f in bus_cuda._FN.values()})
        for n in SOURCES} for a in names}
    result = {"card": card, "arms": names, "batches": {}}

    work = batches(dev)
    angles = [torch.linspace(-10.0, 10.0, 1 << 22, dtype=torch.float64,
                             device=dev)]
    for label, inst, a in work:
        if inst is tron_cuda.BRANCH:
            angles.append((a[0][2] - a[0][3]).to(torch.float64))
    result["sincos"] = check_sincos(libs["sincos"]["sincos"],
                                    torch.cat(angles))

    for label, inst, a in work:
        if inst is None:
            def run(arm, a=a):
                return (_scatter_call(loaded[arm]["bus_scatter"], a),)
            reps = 200
        else:
            def run(arm, a=a, inst=inst):
                return _tron_call(loaded[arm][inst.name], inst, a)
            reps = 10
        outs = {arm: run(arm) for arm in names}
        torch.cuda.synchronize()
        ref = outs[names[0]]
        times = {arm: [] for arm in names}
        for arm in names + names[::-1]:
            times[arm].append(time_ms(lambda arm=arm: run(arm), dev, reps))
        rows = {}
        for arm in names:
            o = outs[arm]
            dx = (o[0] - ref[0]).abs()
            row = {"device_ms": [t[0] for t in times[arm]],
                   "enqueue_ms": [t[1] for t in times[arm]],
                   "max_abs_dx": float(dx.max()) if dx.numel() else 0.0}
            ms = sum(row["device_ms"]) / 2
            line = (f"{label} {arm}: device {ms:.5f} ms (runs "
                    + " / ".join(f"{t:.5f}" for t in row["device_ms"])
                    + f"), enqueue {sum(row['enqueue_ms']) / 2:.5f} ms")
            if inst is None:
                row["elements_differ"] = int((o[0] != ref[0]).sum())
                line += (f"; {row['elements_differ']} sums differ from "
                         f"{names[0]} in any bit")
            else:
                same = (o[1] == ref[1]) & (o[2] == ref[2])
                not_bit = (o[0] != ref[0]).any(dim=0)
                mx = int(o[1].max())
                row.update(lanes=int(o[1].numel()),
                           iters_differ=int((~same).sum()),
                           x_not_bitwise=int(not_bit.sum()),
                           max_minor=mx, us_per_step=ms * 1e3 / max(mx, 1))
                line += (f"; {row['iters_differ']} lanes differ in "
                         f"iterations and {row['x_not_bitwise']} in x from "
                         f"{names[0]} (max |dx| {row['max_abs_dx']:.3e}); "
                         f"max minor {mx}, {row['us_per_step']:.2f} us per "
                         f"step of the slowest lane")
            rows[arm] = row
            print(line)
        result["batches"][label] = rows
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"kernel_ab: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
