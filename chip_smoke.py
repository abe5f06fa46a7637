#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``exaadmm_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--solve]

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda) and
``nvidia-smi``; imports neither jax nor ``exaadmm_tpu``. It builds the four
kernels of the main paths from ``exaadmm_tpu_torch/csrc`` (one nvcc process
per source, all at once) and runs, in order:

0. the card's name and power limit, and the kernels' build (seconds and the
   ``-Xptxas -v`` report);
1. the bus-scatter kernel against its plain version (``index_add_``) on the
   synthetic 9241-bus grid, fp64 and fp32: max relative difference per
   channel (difference over the channel's largest magnitude) <= 1e-13 in
   fp64 and <= 1e-6 in fp32, two kernel runs bit-identical; the device
   time per launch of both (the host queues every rep before the device
   starts, ``utils/timing.py``) beside their host enqueue time per call and
   the kernel's bound (``ops/bounds.py``);
1b. the same scatter over 8 periods folded into the channel axis (the
   multi-period bus update, synthetic 2869 buses), on the arc values and on
   the generator values with the ramp terms blended in: bit-identical to 8
   single-period kernel calls, and within phase 1's thresholds of
   ``index_add_``;
2. the branch TRON/ALM kernel against its plain version on that grid's
   15,710-line batch at the first inner iteration, prox targets perturbed
   from a numpy seed, both at step_cap 50: iteration counts equal on
   >= 99.5 % of lanes and |dx| <= 1e-8 on those lanes in fp64; >= 95 %,
   1e-3 on the agreeing lanes and 5e-3 on all lanes in fp32 (two compilers'
   fp32 rounding may flip a TRON branch decision on a few lanes); then the
   same on the multi-period path's branch batch, the 39,016 lines of
   synthetic 2869 buses tiled over 8 periods. Each TRON line gives the
   lanes that differ, those whose x is not bit-identical, max |dx|, the mean,
   p99 and max minor iterations, the kernel's device time, the us per step
   of the slowest lane (device time over the max minor iterations), its
   host enqueue time and its bound;
2b. the ramp TRON/ALM kernel against its plain version on the 3,010-lane
   ramp batch of synthetic 2869 buses over 8 periods, at the first inner
   iteration, generator prox targets perturbed from a numpy seed, step_cap
   50, with phase 2's thresholds;
2c. the QP-subproblem TRON/ALM kernel against its plain version on the
   15,710-lane batch of the synthetic 9241-bus QP (linearized at the case's
   own operating point) at the first iteration, from ``init_solution`` and
   ``one_level_reset``, l and v of the lines perturbed by N(0, 0.05) from a
   numpy seed, step_cap 50, with phase 2's thresholds; then the same without
   line limits;
3. case9 end to end through ``solve_acopf(..., device="cuda")``, fp64:
   Solved, objective and dispatch in the known bands, outer/cumul beside the
   pins 25/1087 (within 1 outer and 2 %), one TRON launch per inner
   iteration;
3b. case9 over 3 periods, no warm start, through
   ``solve_mpacopf(..., device="cuda")``, fp64: Solved, outer/cumul within
   1 outer and 2 % of the pins 20/1007, objective within 1e-6 relative of
   16015.6958770167, ramp violation <= 1e-3, one ramp and one branch launch
   per inner iteration; and a one-period run of the same entry point, which
   has no ramp batch and must launch no ramp kernel;
3c. the case9 QP (linearized at the base point of
   ``tests/qpsub_fixture.py``) through ``solve_qpsub(..., device="cuda")``,
   fp64, rho (4e3, 4e3), scale 1e-4, outer_eps 2e-6: Solved, outer and
   cumul within 2 % of the pin 5107, objective within 1e-6 relative of
   -21.92744641968529, the SQP outputs' shapes and signs, one QP-subproblem
   TRON launch and two bus launches per iteration;
4. the single-period main path at full size: synthetic 9241 buses, fp64,
   flat start at rho (3e3, 3e5), 3 outer x 100 inner iterations: inner
   iterations per second of the ADMM loop (``info.time_overall``, after the
   model is built) and of the whole call, the final mismatch and the peak
   device memory;
5. the multi-period main path at full width: synthetic 2869 buses (4,877
   lines, 430 generators), 8 periods of the load profile
   ``synthetic_load_profile``, fp64, flat start at rho (4e2, 4e4), 3 outer x
   50 inner iterations with outer_eps 0: the same rates as phase 4, the
   final mismatch, the ramp violation and the peak device memory;
6. the one-level QP-subproblem path at full width: the synthetic 9241-bus
   QP of phase 2c through ``solve_qpsub``, fp64, rho (4e3, 4e3),
   tron_step_cap 24, outer_eps 0, 200 iterations: iterations per second of
   the ADMM loop and of the whole call, the final mismatch, the peak device
   memory and the launch counts.

The kernels' launch counters are zeroed just before phases 4, 5 and 6 and
read just after each; the ``launches`` of a kernel in the JSON line are the
sum over those three runs.

``--profile`` adds a breakdown of one iteration of phase 4's, phase 5's and
phase 6's configuration (host time per hook, device time by kernel, idle
share); ``--solve`` adds the time to tolerance of phase 4's configuration.

Each phase prints one line of numbers; any failure raises, so the script
exits non-zero and prints no result. The line before the last is one JSON
object with each kernel's numbers (phase 1's fp64 scatter and phase 2's,
2b's and 2c's fp64 batches): ``ms`` and ``device_ms`` the device time per
launch, ``enqueue_ms`` the host's time per call, ``plain_ms`` the plain
version's, ``bound_ms`` and ``bound_by`` the least time for the bytes and
operations of that launch, and ``library_ms`` ``index_add_``'s device time
for the scatter (null for the TRON instances, which no library call
computes); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CASE9 = os.path.join(ROOT, "data", "case9.m")
DEMAND9 = os.path.join(ROOT, "data", "case9_demand")
PIN_OUTER, PIN_CUMUL = 25, 1087
MP_PIN_OUTER, MP_PIN_CUMUL, MP_PIN_OBJ = 20, 1007, 16015.6958770167
QP_PIN_ITERS, QP_PIN_OBJ = 5107, -21.92744641968529
QP_ITERS = 200
KERNEL_SOURCES = {
    "tron_alm_branch": ("exaadmm_tpu_torch/csrc/tron_alm_branch.cu",
                        "exaadmm_tpu/ops/tron_pallas.py:42"),
    "tron_alm_ramp": ("exaadmm_tpu_torch/csrc/tron_alm_ramp.cu",
                      "exaadmm_tpu/ops/tron_pallas.py:42"),
    "tron_alm_qpsub": ("exaadmm_tpu_torch/csrc/tron_alm_qpsub.cu",
                       "exaadmm_tpu/ops/tron_pallas.py:42"),
    "bus_scatter": ("exaadmm_tpu_torch/csrc/bus_scatter.cu",
                    "exaadmm_tpu/ops/bus_pallas.py:42"),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase0_device(dev, on_card: bool) -> dict:
    from exaadmm_tpu_torch.ops import _build, bus_cuda, tron_cuda
    info = {"name": str(dev)}
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[dev.index or 0]
        info = {"name": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(), "smi": card}
        print(card)
        print(f"phase 0: device {info['name']!r} count {info['count']} "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        _build.build(KERNEL_SOURCES)
        tron_cuda.library(tron_cuda.BRANCH)
        tron_cuda.library(tron_cuda.RAMP)
        tron_cuda.library(tron_cuda.QPSUB)
        bus_cuda.library()
        print(f"phase 0: built {len(KERNEL_SOURCES)} kernels in parallel in "
              f"{time.perf_counter() - t0:.1f} s")
        for name in KERNEL_SOURCES:
            log = [ln.strip() for ln in _build.build_logs[name].splitlines()
                   if "Compiling entry" in ln or "registers" in ln
                   or "spill" in ln]
            print(f"phase 0: built {name} in "
                  f"{_build.build_seconds[name]:.1f} s")
            for ln in log:
                print(f"  {ln}")
    return info


def phase1_bus(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import kernels
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.ops import bounds, bus_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.timing import time_pair

    out = {}
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        model = M.build_model(data, Parameters(verbose=0), dtype=dtype,
                              device=dev)
        sol = M.init_solution(model, 3e3, 3e5)
        gd = model.grid
        arcs = kernels.bus_arc_values(sol.v, sol.z, sol.l, sol.rho, gd)
        gens = kernels.bus_gen_values(sol.v, sol.z, sol.l, sol.rho)
        worst_rel, worst_abs = 0.0, 0.0
        for vals, ids, ptr, idx in ((arcs, gd.arc_bus, gd.arc_ptr,
                                     gd.arc_idx),
                                    (gens, gd.gen_bus, gd.gen_ptr,
                                     gd.gen_idx)):
            got = bus_cuda.bus_scatter(vals, ids, ptr, idx)
            again = bus_cuda.bus_scatter(vals, ids, ptr, idx)
            ref = bus_cuda.bus_scatter_plain(vals, ids, ptr.shape[0] - 1)
            _check(bool(torch.equal(got, again)),
                   "bus_scatter: two runs differ")
            diff = (got - ref).abs()
            scale = ref.abs().amax(dim=0).clamp_min(
                torch.finfo(dtype).tiny)
            worst_rel = max(worst_rel, float((diff.amax(dim=0) / scale).max()))
            worst_abs = max(worst_abs, float(diff.max()))
        _check(worst_rel <= tol,
               f"bus_scatter {dtype}: rel diff {worst_rel:.3e} > {tol:.0e}")
        (ms, enq), (lib_ms, lib_enq) = time_pair(
            lambda: bus_cuda.bus_scatter(arcs, gd.arc_bus, gd.arc_ptr,
                                         gd.arc_idx),
            lambda: bus_cuda.bus_scatter_plain(arcs, gd.arc_bus, gd.nbus),
            dev, reps=100)
        nb = bounds.scatter_bytes(arcs.shape[0], gd.nbus, arcs.shape[1],
                                  arcs.element_size())
        bound_ms, bound_by = bounds.bound(
            nb["total"], bounds.scatter_ops(arcs.shape[0], arcs.shape[1]),
            arcs.element_size())
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(rel=worst_rel, abs=worst_abs, ms=ms, enqueue_ms=enq,
                        plain_ms=lib_ms, library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        print(f"phase 1: bus_scatter {key} arcs {tuple(arcs.shape)} -> "
              f"{gd.nbus} buses: max rel diff {worst_rel:.3e} (tol {tol:.0e}),"
              f" max abs diff {worst_abs:.3e}, bit-identical reruns; device "
              f"ms per launch: kernel {ms:.5f}, index_add_ with its zeros "
              f"{lib_ms:.5f}, bound {bound_ms:.5f} ({bound_by}, "
              f"{nb['total']} B); host enqueue ms per call: kernel "
              f"{enq:.5f}, index_add_ {lib_enq:.5f}")
    return out


def _tron_vs_plain(label: str, name: str, kernel, plain, act, dtype,
                   dev) -> dict:
    """Run the TRON/ALM kernel ``name`` and its plain version on the same
    batch, hold them to phase 2's thresholds, time both and bound the
    kernel (``ops/bounds.py``, from this batch's iteration counts)."""
    from exaadmm_tpu_torch.ops import bounds
    from exaadmm_tpu_torch.utils.timing import time_ms
    rk = kernel()
    rp = plain()
    _sync(dev)
    a = act.cpu().numpy()
    mk_all = rk.minor_iters.cpu().numpy()
    ak_all = rk.alm_iters.cpu().numpy()
    mk = mk_all[a]
    mp = rp.minor_iters.cpu().numpy()[a]
    ak = ak_all[a]
    ap = rp.alm_iters.cpu().numpy()[a]
    same = (mk == mp) & (ak == ap)
    dx = (rk.x - rp.x).abs().amax(dim=0).cpu().numpy()[a]
    frac = float(same.mean())
    dx_same = float(dx[same].max()) if same.any() else 0.0
    dx_all = float(dx.max())
    _check(bool(np.isfinite(rk.x.cpu().numpy()).all()),
           f"{label}: non-finite x")
    if dtype == torch.float64:
        _check(frac >= 0.995, f"{label} f64: only {frac:.4%} lanes agree")
        _check(dx_same <= 1e-8, f"{label} f64: |dx| {dx_same:.3e} > 1e-8")
    else:
        _check(frac >= 0.95, f"{label} f32: only {frac:.4%} lanes agree")
        _check(dx_same <= 1e-3, f"{label} f32: |dx| {dx_same:.3e} > 1e-3")
        _check(dx_all <= 5e-3, f"{label} f32: |dx| {dx_all:.3e} > 5e-3")
    ms, enq = time_ms(kernel, dev, reps=5, warmup=1)
    plain_ms, _ = time_ms(plain, dev, reps=1, warmup=0, ahead=False)
    B = rk.x.shape[1]
    isz = rk.x.element_size()
    nb = bounds.tron_bytes(name, B, isz)
    ops = bounds.tron_ops(name, mk_all.sum(), ak_all.sum(), B)
    bound_ms, bound_by = bounds.bound(nb["total"], ops, isz)
    max_minor = int(mk.max()) if mk.size else 0
    us_per_step = ms * 1e3 / max(max_minor, 1)
    key = "f64" if dtype == torch.float64 else "f32"
    print(f"{label} {key} B={same.size} step_cap=50: {int((~same).sum())} of "
          f"{same.size} lanes differ in minor/alm iterations ({frac:.4%} "
          f"agree), {int((dx > 0).sum())} lanes with x not bit-identical, max "
          f"|dx| agreeing {dx_same:.3e}, all {dx_all:.3e}; minor iters mean "
          f"{mk.mean():.2f} p99 {np.percentile(mk, 99):.0f} max {max_minor}; "
          f"kernel device {ms:.4f} ms ({us_per_step:.2f} us per step of the "
          f"slowest lane), host enqueue {enq:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {nb['total']} B, {ops:.4g} ops); plain "
          f"{plain_ms:.1f} ms")
    return dict(frac=frac, dx_same=dx_same, dx_all=dx_all, ms=ms,
                enqueue_ms=enq, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase2_tron(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = M.build_model(data, par, dtype=dtype, device=dev)
        sol = M.init_solution(model, 4e2, 4e4)
        # perturb the prox targets so the lanes spread in difficulty
        rng = np.random.default_rng(0)
        noise = torch.as_tensor(rng.normal(0, 0.05, tuple(sol.v.line.shape)))
        sol = sol.replace(v=sol.v.replace(
            line=sol.v.line + noise.to(device=dev, dtype=dtype)))
        x0, xl, xu, params, lam0, mu0, act = branch.branch_inputs(
            sol, model.grid, par, 1)
        opts = branch.branch_tolerances(par, dtype)

        def kernel():
            return tron_cuda.tron_alm_branch(x0, xl, xu, params, lam0, mu0,
                                             active0=act, **opts)

        def plain():
            return tron_cuda.tron_alm_branch_plain(
                x0, xl, xu, params, lam0, mu0, active0=act, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain("phase 2: tron_alm_branch",
                                  "tron_alm_branch", kernel, plain, act,
                                  dtype, dev)
    return out


def _mp_model(dev, data, loads, T: int, dtype, par):
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    return MP.build_model(data, par, *loads, end_period=T, dtype=dtype,
                          device=dev)


def phase2_branch_periods(dev, data, loads, T: int, on_card: bool) -> dict:
    """Phase 2's check on the multi-period path's branch batch: the
    T * nline lines over the tiled grid, as ``update_x`` builds it."""
    from exaadmm_tpu_torch.models.acopf import branch
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = _mp_model(dev, data, loads, T, dtype, par)
        ac = MP.init_solution(model, 4e2, 4e4).acopf
        # perturb the prox targets so the lanes (and periods) differ
        rng = np.random.default_rng(0)
        noise = torch.as_tensor(rng.normal(0, 0.05, tuple(ac.v.line.shape)))
        ac = ac.replace(v=ac.v.replace(
            line=ac.v.line + noise.to(device=dev, dtype=dtype)))
        x0, xl, xu, params, lam0, mu0, act = branch.branch_inputs(
            model.flat_lines(ac), model.grid_T, par, 1)
        opts = branch.branch_tolerances(par, dtype)

        def kernel():
            return tron_cuda.tron_alm_branch(x0, xl, xu, params, lam0, mu0,
                                             active0=act, **opts)

        def plain():
            return tron_cuda.tron_alm_branch_plain(
                x0, xl, xu, params, lam0, mu0, active0=act, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain(
            f"phase 2: tron_alm_branch x {T} periods", "tron_alm_branch",
            kernel, plain, act, dtype, dev)
    return out


def phase1b_bus_periods(dev, data, loads, T: int, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.acopf import kernels
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.ops import bounds, bus_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.timing import time_ms, time_pair

    out = {}
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        model = _mp_model(dev, data, loads, T, dtype, Parameters(verbose=0))
        gd = model.grid
        sol = MP.init_solution(model, 4e2, 4e4)
        ac = sol.acopf
        # periods that differ: the line and generator values perturbed per
        # period; the generator values blend in the next period's ramp terms
        # as the bus update does
        rng = np.random.default_rng(1)

        def perturb(a):
            return a + torch.as_tensor(rng.normal(0, 0.05, tuple(
                a.shape))).to(device=dev, dtype=dtype)

        u = ac.u.replace(line=perturb(ac.v.line), gen=perturb(ac.u.gen))
        arcs = kernels.bus_arc_values(u, ac.z, ac.l, ac.rho, gd)
        gens = kernels.bus_gen_values(u, ac.z, ac.l, ac.rho,
                                      model.next_ramp(sol.ramp))
        rel, worst_abs = 0.0, 0.0
        for what, vals, ids, ptr, idx in (
                ("arcs", arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx),
                ("gens", gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)):
            folded = bus_cuda.bus_scatter_periods(vals, ids, ptr, idx)
            single = torch.stack([bus_cuda.bus_scatter(vals[t], ids, ptr,
                                                       idx)
                                  for t in range(T)])
            ref = torch.stack([bus_cuda.bus_scatter_plain(vals[t], ids,
                                                          gd.nbus)
                               for t in range(T)])
            _check(bool(torch.equal(folded, single)),
                   f"bus_scatter_periods {what}: differs from single-period "
                   f"calls")
            diff = (folded - ref).abs()
            scale = ref.abs().amax(dim=1).clamp_min(torch.finfo(dtype).tiny)
            rel = max(rel, float((diff.amax(dim=1) / scale).max()))
            worst_abs = max(worst_abs, float(diff.max()))
        _check(rel <= tol, f"bus_scatter_periods {dtype}: rel diff "
                           f"{rel:.3e} > {tol:.0e}")
        folded_vals = arcs.permute(1, 0, 2).reshape(arcs.shape[1], -1)
        (ms, enq), (lib_ms, lib_enq) = time_pair(
            lambda: bus_cuda.bus_scatter_periods(arcs, gd.arc_bus, gd.arc_ptr,
                                                 gd.arc_idx),
            lambda: bus_cuda.bus_scatter_plain(folded_vals, gd.arc_bus,
                                               gd.nbus),
            dev, reps=100)
        loop_ms, loop_enq = time_ms(lambda: [bus_cuda.bus_scatter(
            arcs[t], gd.arc_bus, gd.arc_ptr, gd.arc_idx) for t in range(T)],
            dev, reps=100)
        nb = bounds.scatter_bytes(folded_vals.shape[0], gd.nbus,
                                  folded_vals.shape[1], arcs.element_size())
        bound_ms, bound_by = bounds.bound(
            nb["total"], bounds.scatter_ops(*folded_vals.shape),
            arcs.element_size())
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(rel=rel, abs=worst_abs, ms=ms, enqueue_ms=enq,
                        loop_ms=loop_ms, plain_ms=lib_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase 1b: bus_scatter_periods {key} {T} periods, arcs "
              f"{tuple(arcs.shape)} and gens {tuple(gens.shape)} -> "
              f"{gd.nbus} buses: both bit-identical to "
              f"{T} single-period calls, max rel diff to index_add_ "
              f"{rel:.3e} (tol {tol:.0e}); device ms: arcs folded "
              f"{ms:.5f}, {T} calls {loop_ms:.5f}, index_add_ with its zeros "
              f"on the folded rows {lib_ms:.5f}, bound {bound_ms:.5f} "
              f"({bound_by}, {nb['total']} B); host enqueue ms per call: "
              f"folded {enq:.5f}, {T} calls {loop_enq:.5f}, index_add_ "
              f"{lib_enq:.5f}")
    return out


def phase2b_ramp(dev, data, loads, T: int, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.mpacopf import ramp
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    out = {}
    for dtype in (torch.float64, torch.float32):
        par = Parameters(verbose=0, tron_step_cap=50)
        model = _mp_model(dev, data, loads, T, dtype, par)
        sol = MP.init_solution(model, 4e2, 4e4)
        # perturb the generator prox targets so the lanes spread
        rng = np.random.default_rng(0)
        v = sol.acopf.v
        noise = torch.as_tensor(rng.normal(0, 0.05, tuple(v.gen.shape)))
        sol = sol.replace(acopf=sol.acopf.replace(v=v.replace(
            gen=v.gen + noise.to(device=dev, dtype=dtype))))
        x0, xl, xu, params, lam0, mu0 = ramp.ramp_inputs(sol, model, 1)
        opts = ramp.ramp_tolerances(par, dtype)
        act = torch.ones(x0.shape[1], dtype=torch.bool, device=dev)

        def kernel():
            return tron_cuda.tron_alm_ramp(x0, xl, xu, params, lam0, mu0,
                                           **opts)

        def plain():
            return tron_cuda.tron_alm_ramp_plain(x0, xl, xu, params, lam0,
                                                 mu0, **opts)

        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = _tron_vs_plain("phase 2b: tron_alm_ramp", "tron_alm_ramp",
                                  kernel, plain, act, dtype, dev)
    return out


def qp_inputs(data, base=None) -> dict:
    """The QP of ``data`` linearized at ``base`` (an ``SqpBasePoint``), by
    default at the case's own operating point (the JAX package's qpsub
    benchmark, tools/model_bench.py)."""
    from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                    build_qp_inputs)
    from exaadmm_tpu_torch.utils.grid_data import build_grid_data
    if base is None:
        base = SqpBasePoint(pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va)
    return build_qp_inputs(data, build_grid_data(data), base)


def phase2c_qpsub(dev, data, on_card: bool) -> dict:
    from exaadmm_tpu_torch.models.qpsub import model as Q
    from exaadmm_tpu_torch.ops import tron_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

    qp = qp_inputs(data)
    out = {}
    for use_linelimit in (True, False):
        for dtype in (torch.float64, torch.float32):
            par = Parameters(verbose=0, tron_step_cap=50)
            model = Q.build_model(data, par, qp, use_linelimit=use_linelimit,
                                  dtype=dtype, device=dev)
            sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
            # perturb l and v of the lines so the lanes spread in difficulty
            rng = np.random.default_rng(0)
            b = sol.base

            def noise():
                return torch.as_tensor(rng.normal(
                    0, 0.05, tuple(b.l.line.shape))).to(device=dev,
                                                        dtype=dtype)

            sol = sol.replace(base=b.replace(
                l=b.l.replace(line=b.l.line + noise()),
                v=b.v.replace(line=b.v.line + noise())))
            x0, xl, xu, params, lam0, mu0, act = Q.qpsub_inputs(model, sol, 1)
            opts = Q.qpsub_tolerances(par, dtype, use_linelimit)

            def kernel():
                return tron_cuda.tron_alm_qpsub(x0, xl, xu, params, lam0, mu0,
                                                active0=act, **opts)

            def plain():
                return tron_cuda.tron_alm_qpsub_plain(
                    x0, xl, xu, params, lam0, mu0, active0=act, **opts)

            key = ("f64" if dtype == torch.float64 else "f32") + (
                "" if use_linelimit else "_nolimit")
            label = "phase 2c: tron_alm_qpsub" + (
                "" if use_linelimit else " without line limits")
            out[key] = _tron_vs_plain(label, "tron_alm_qpsub", kernel, plain,
                                      act, dtype, dev)
    return out


def phase3_case9(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

    tron_cuda.launches = bus_cuda.launches = 0
    t0 = time.perf_counter()
    res = E.solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-5,
                        outer_iterlim=25, verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    pg = (res.solution.u.gen[:, 0] * 100.0).cpu().numpy()
    print(f"phase 3: case9 {info.status} outer {info.outer} (pin "
          f"{PIN_OUTER}) cumul {info.cumul} (pin {PIN_CUMUL}) obj "
          f"{info.objval!r} pg {np.round(pg, 3).tolist()} in {secs:.2f} s; "
          f"launches tron {tron_cuda.launches} bus {bus_cuda.launches}")
    _check(info.status == "Solved", f"case9: status {info.status}")
    _check(5296.0 <= info.objval <= 5304.5, f"case9: obj {info.objval}")
    _check(bool(np.all(np.abs(pg - np.array([89.8, 134.32, 94.19])) <= 1.0)),
           f"case9: pg {pg}")
    _check(abs(info.outer - PIN_OUTER) <= 1, f"case9: outer {info.outer}")
    _check(abs(info.cumul - PIN_CUMUL) <= 0.02 * PIN_CUMUL,
           f"case9: cumul {info.cumul}")
    if on_card:
        _check(tron_cuda.launches == info.cumul,
               f"case9: {tron_cuda.launches} TRON launches for "
               f"{info.cumul} inner iterations")
        _check(bus_cuda.launches >= info.cumul,
               f"case9: {bus_cuda.launches} bus launches")
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def phase4_main(dev, data, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    tron_cuda.launches = tron_cuda.ramp_launches = bus_cuda.launches = 0
    tron_cuda.qpsub_launches = 0
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, rho_pq=3e3, rho_va=3e5,
                        outer_iterlim=3, inner_iterlim=100, outer_eps=0.0,
                        verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {"tron_alm_branch": tron_cuda.launches,
                "tron_alm_ramp": tron_cuda.ramp_launches,
                "tron_alm_qpsub": tron_cuda.qpsub_launches,
                "bus_scatter": bus_cuda.launches}
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    print(f"phase 4: {data.case} ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) fp64: {info.outer} outer, {info.cumul} inner; "
          f"ADMM loop {info.time_overall:.3f} s = {rate:.2f} inner it/s, "
          f"whole call with setup {secs:.3f} s = {info.cumul / secs:.2f} "
          f"inner it/s; mismatch "
          f"{info.mismatch!r} primres {info.primres!r} obj {info.objval!r}; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"main path: {name} not finite")
    _check(bool(torch.isfinite(res.solution.u.line).all()),
           "main path: u not finite")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul
               and launches["tron_alm_ramp"] == 0
               and launches["tron_alm_qpsub"] == 0,
               f"main path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * info.cumul,
               f"main path: bus launches {launches}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak)


def phase3b_case9_mpacopf(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

    tron_cuda.launches = tron_cuda.ramp_launches = bus_cuda.launches = 0
    tron_cuda.qpsub_launches = 0
    t0 = time.perf_counter()
    res = E.solve_mpacopf(CASE9, DEMAND9, start_period=1, end_period=3,
                          rho_pq=4e2, rho_va=4e4, outer_iterlim=30,
                          outer_eps=2e-4, warm_start=False, verbose=0,
                          device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    rel = abs(info.objval - MP_PIN_OBJ) / MP_PIN_OBJ
    print(f"phase 3b: case9 x 3 periods {info.status} outer {info.outer} "
          f"(pin {MP_PIN_OUTER}) cumul {info.cumul} (pin {MP_PIN_CUMUL}) obj "
          f"{info.objval!r} (rel diff {rel:.2e}) err_ramp {res.err_ramp:.3e} "
          f"in {secs:.2f} s; launches branch {tron_cuda.launches} ramp "
          f"{tron_cuda.ramp_launches} bus {bus_cuda.launches}")
    _check(info.status == "Solved", f"case9 mp: status {info.status}")
    _check(abs(info.outer - MP_PIN_OUTER) <= 1, f"case9 mp: outer {info.outer}")
    _check(abs(info.cumul - MP_PIN_CUMUL) <= 0.02 * MP_PIN_CUMUL,
           f"case9 mp: cumul {info.cumul}")
    _check(rel <= 1e-6, f"case9 mp: obj {info.objval}")
    _check(res.err_ramp <= 1e-3, f"case9 mp: err_ramp {res.err_ramp}")
    if on_card:
        _check(tron_cuda.launches == info.cumul
               and tron_cuda.ramp_launches == info.cumul,
               f"case9 mp: {tron_cuda.launches} branch and "
               f"{tron_cuda.ramp_launches} ramp launches for {info.cumul} "
               f"inner iterations")
        _check(bus_cuda.launches == 2 * info.cumul,
               f"case9 mp: {bus_cuda.launches} bus launches")

    # one period: no ramp batch, so no ramp launch
    tron_cuda.launches = tron_cuda.ramp_launches = bus_cuda.launches = 0
    one = E.solve_mpacopf(CASE9, DEMAND9, end_period=1, outer_iterlim=1,
                          inner_iterlim=5, warm_start=False, verbose=0,
                          device=dev)
    _sync(dev)
    print(f"phase 3b: case9 x 1 period, {one.info.cumul} inner: launches "
          f"branch {tron_cuda.launches} ramp {tron_cuda.ramp_launches} bus "
          f"{bus_cuda.launches}")
    _check(bool(torch.isfinite(one.solution.acopf.u.gen).all()),
           "case9 x 1 period: u not finite")
    if on_card:
        _check(tron_cuda.ramp_launches == 0
               and tron_cuda.launches == one.info.cumul,
               f"case9 x 1 period: {tron_cuda.launches} branch and "
               f"{tron_cuda.ramp_launches} ramp launches for "
               f"{one.info.cumul} inner iterations")
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                err_ramp=res.err_ramp, seconds=secs)


def phase5_mpacopf(dev, data, loads, T: int, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    tron_cuda.launches = tron_cuda.ramp_launches = bus_cuda.launches = 0
    tron_cuda.qpsub_launches = 0
    t0 = time.perf_counter()
    res = E.solve_mpacopf(data.case, data=data, loads=loads, end_period=T,
                          rho_pq=4e2, rho_va=4e4, outer_iterlim=3,
                          inner_iterlim=50, outer_eps=0.0, warm_start=False,
                          verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {"tron_alm_branch": tron_cuda.launches,
                "tron_alm_ramp": tron_cuda.ramp_launches,
                "tron_alm_qpsub": tron_cuda.qpsub_launches,
                "bus_scatter": bus_cuda.launches}
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    print(f"phase 5: {data.case} ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) x {T} periods fp64: {info.outer} outer, "
          f"{info.cumul} inner; ADMM loop {info.time_overall:.3f} s = "
          f"{rate:.2f} inner it/s, whole call with setup {secs:.3f} s = "
          f"{info.cumul / secs:.2f} inner it/s; mismatch {info.mismatch!r} primres {info.primres!r} obj "
          f"{info.objval!r} err_ramp {res.err_ramp!r}; peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"multi-period path: {name} not finite")
    _check(bool(np.isfinite(res.err_ramp)), "multi-period path: err_ramp")
    _check(bool(torch.isfinite(res.solution.acopf.u.line).all()),
           "multi-period path: u not finite")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul
               and launches["tron_alm_ramp"] == info.cumul
               and launches["tron_alm_qpsub"] == 0,
               f"multi-period path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * info.cumul,
               f"multi-period path: bus launches {launches}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, err_ramp=res.err_ramp, peak=peak)


def phase3c_case9_qpsub(dev, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
    from tests import qpsub_fixture as fx

    # the reference test's base point: vm = sqrt(bus_w), va from the lines
    data = opf_loaddata(CASE9, verbose=0)
    va = np.zeros(data.nbus)
    va[data.line_from] = fx.line_var[4]
    va[data.line_to] = fx.line_var[5]
    qp = qp_inputs(data, SqpBasePoint(pg=fx.pg, qg=fx.qg,
                                      vm=np.sqrt(fx.bus_w), va=va))
    tron_cuda.qpsub_launches = bus_cuda.launches = 0
    t0 = time.perf_counter()
    res = E.solve_qpsub(CASE9, *[qp[k] for k in QP_KEYS], 1e5,
                        outer_iterlim=10000, inner_iterlim=1, scale=1e-4,
                        rho_pq=4000.0, rho_va=4000.0, outer_eps=2e-6,
                        verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    lam = res.sqp_out["lambda"]
    rel = abs(info.objval - QP_PIN_OBJ) / abs(QP_PIN_OBJ)
    print(f"phase 3c: case9 QP {info.status} outer {info.outer} cumul "
          f"{info.cumul} (pin {QP_PIN_ITERS}) obj {info.objval!r} (rel diff "
          f"{rel:.2e}) in {secs:.2f} s ({info.cumul / info.time_overall:.1f} "
          f"it/s in the ADMM loop); dual_infeas "
          f"{res.sqp_out['dual_infeas'].shape} lambda {lam.shape}, max "
          f"lambda[2:] {lam[2:].max():.3e}; launches qpsub "
          f"{tron_cuda.qpsub_launches} bus {bus_cuda.launches}")
    _check(info.status == "Solved", f"case9 QP: status {info.status}")
    for name in ("outer", "cumul"):
        n = getattr(info, name)
        _check(abs(n - QP_PIN_ITERS) <= 0.02 * QP_PIN_ITERS,
               f"case9 QP: {name} {n}")
    _check(rel <= 1e-6, f"case9 QP: obj {info.objval}")
    _check(res.sqp_out["dual_infeas"].shape == (3 + 6 * 9,),
           "case9 QP: dual_infeas shape")
    _check(lam.shape == (4, 9), "case9 QP: lambda shape")
    _check(bool(np.all(lam[2:] <= 1e-12)), "case9 QP: lambda[2:] > 1e-12")
    if on_card:
        _check(tron_cuda.qpsub_launches == info.cumul,
               f"case9 QP: {tron_cuda.qpsub_launches} qpsub launches for "
               f"{info.cumul} iterations")
        _check(bus_cuda.launches == 2 * info.cumul,
               f"case9 QP: {bus_cuda.launches} bus launches")
    return dict(outer=info.outer, cumul=info.cumul, obj=info.objval,
                seconds=secs)


def phase6_qpsub(dev, data, on_card: bool) -> dict:
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

    qp = qp_inputs(data)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    tron_cuda.launches = tron_cuda.ramp_launches = 0
    tron_cuda.qpsub_launches = bus_cuda.launches = 0
    t0 = time.perf_counter()
    res = E.solve_qpsub(data.case, *[qp[k] for k in QP_KEYS], 1e5, data=data,
                        outer_iterlim=QP_ITERS, scale=1e-4, rho_pq=4e3,
                        rho_va=4e3, outer_eps=0.0, tron_step_cap=24,
                        verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {"tron_alm_branch": tron_cuda.launches,
                "tron_alm_ramp": tron_cuda.ramp_launches,
                "tron_alm_qpsub": tron_cuda.qpsub_launches,
                "bus_scatter": bus_cuda.launches}
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / info.time_overall
    print(f"phase 6: {data.case} QP ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) fp64: {info.cumul} one-level iterations; ADMM "
          f"loop {info.time_overall:.3f} s = {rate:.2f} it/s, whole call "
          f"with setup {secs:.3f} s = {info.cumul / secs:.2f} it/s; mismatch "
          f"{info.mismatch!r} dualres {info.dualres!r} obj {info.objval!r}; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "auglag"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"qpsub path: {name} not finite")
    _check(info.cumul == QP_ITERS, f"qpsub path: {info.cumul} iterations")
    _check(bool(torch.isfinite(res.solution.base.u.line).all()),
           "qpsub path: u not finite")
    for k, v in res.sqp_out.items():
        _check(bool(np.isfinite(v).all()), f"qpsub path: sqp_out {k}")
    if on_card:
        _check(launches["tron_alm_qpsub"] == info.cumul
               and launches["tron_alm_branch"] == 0
               and launches["tron_alm_ramp"] == 0,
               f"qpsub path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * info.cumul,
               f"qpsub path: bus launches {launches}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak)


def two_level_hooks(model, beta: float = 1e3):
    """The two-level driver's inner iteration, hook by hook: (name,
    fn(sol, iteration)); the last returns (sol, scalars)."""
    return (
        ("x", lambda s, it: model.update_x(model.inner_prestep(s), it)[0]),
        ("xbar", lambda s, it: model.update_xbar(s)),
        ("z", lambda s, it: model.update_z(s, beta)),
        ("l", lambda s, it: model.update_l(s, beta)),
        ("residual", lambda s, it: model.update_residual(s, beta)),
    )


def one_level_hooks(model):
    """The one-level driver's iteration, hook by hook, as
    ``two_level_hooks``; ``model`` is the driver's (``solve_prep``'s)."""
    return (
        ("x", lambda s, it: model.update_x(s, it)[0]),
        ("xbar", lambda s, it: model.update_xbar(s)),
        ("l", lambda s, it: model.update_l_single(s)),
        ("residual", lambda s, it: model.update_residual(s, 0.0)),
    )


def profile_main(dev, label: str, hooks, sol, readback, warmup: int = 5,
                 iters: int = 20) -> dict:
    """Where an iteration's time goes for ``hooks`` from ``sol``: host time
    per hook with a synchronize after each hook; the wall time per
    iteration without them; and, from torch.profiler over the same
    unsynchronized iterations, the device time by kernel and the device's
    idle share. ``readback`` names the scalars the driver reads back each
    iteration."""
    state = {"sol": sol, "inner": 0}

    def step(times=None):
        state["inner"] += 1
        sol = state["sol"]
        for name, fn in hooks:
            t0 = time.perf_counter()
            sol = fn(sol, state["inner"])
            if name == "residual":
                sol, scalars = sol
                # the driver's one read-back
                torch.stack([scalars[k] for k in readback]).tolist()
            if times is not None:
                _sync(dev)
                times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        state["sol"] = sol

    for _ in range(warmup):
        step()
    times = {}
    for _ in range(iters):
        step(times)
    hook_ms = {k: v * 1e3 / iters for k, v in times.items()}
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            step()
        _sync(dev)
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            kernels[e.key] = (t / 1e3 / iters, e.count / iters)
    busy_ms = sum(t for t, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    print(f"profile {label}: per iteration {wall_ms:.3f} ms wall; with "
          f"a synchronize after each hook: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in hook_ms.items()))
    print(f"profile {label}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {launches:.1f} device "
          f"activities per iteration")
    # the 12 largest, then the port's own kernels wherever they rank
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    own = [kv for kv in ranked[12:]
           if "tron_alm" in kv[0] or "bus_scatter" in kv[0]]
    for name, (t, n) in ranked[:12] + own:
        print(f"profile {label}:   {t:9.4f} ms x{n:5.1f}  {name[:100]}")
    return dict(wall_ms=wall_ms, hook_ms=hook_ms, busy_ms=busy_ms,
                launches=launches)


def solve_to_tolerance(dev, data) -> dict:
    """Time to tolerance: the full solve of ``data`` in fp64 at rho (3e3,
    3e5) and the default outer_eps 2e-4, 20 outer iterations at most (the
    kernels are already built)."""
    import exaadmm_tpu_torch as E

    _sync(dev)
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, rho_pq=3e3, rho_va=3e5,
                        outer_iterlim=20, verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    info = res.info
    print(f"solve: {data.case} fp64 {info.status} in {secs:.3f} s: "
          f"{info.outer} outer, {info.cumul} inner ({info.cumul / secs:.2f} "
          f"it/s), mismatch {info.mismatch!r}, obj {info.objval!r}, max "
          f"line-limit violation {info.max_cviol!r}")
    return dict(status=info.status, seconds=secs, cumul=info.cumul)


def run(device, big_data, mp_data, mp_loads, T: int) -> dict:
    """All phases on ``device``; ``big_data`` is the single-period grid,
    ``mp_data`` with ``mp_loads`` ((Pd, Qd), (nbus, T) each) the
    multi-period one. On a CPU device (a rehearsal) the wrappers run their
    plain versions, so the kernel comparisons and launch counts are not
    meaningful there."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mp = (mp_data, mp_loads, T, on_card)
    results = {"device": phase0_device(dev, on_card)}
    results["bus"] = phase1_bus(dev, big_data, on_card)
    results["bus_periods"] = phase1b_bus_periods(dev, *mp)
    results["tron"] = phase2_tron(dev, big_data, on_card)
    results["tron_mp"] = phase2_branch_periods(dev, *mp)
    results["ramp"] = phase2b_ramp(dev, *mp)
    results["qpsub"] = phase2c_qpsub(dev, big_data, on_card)
    results["case9"] = phase3_case9(dev, on_card)
    results["case9_mp"] = phase3b_case9_mpacopf(dev, on_card)
    results["case9_qp"] = phase3c_case9_qpsub(dev, on_card)
    results["main"] = phase4_main(dev, big_data, on_card)
    results["main_mp"] = phase5_mpacopf(dev, *mp)
    results["main_qp"] = phase6_qpsub(dev, big_data, on_card)
    kern = []
    for name, key in (("tron_alm_branch", "tron"), ("tron_alm_ramp", "ramp"),
                      ("tron_alm_qpsub", "qpsub"), ("bus_scatter", "bus")):
        r = results[key]["f64"]
        if key == "bus":
            err = max(r["abs"], results["bus_periods"]["f64"]["abs"])
        elif key == "tron":
            err = max(r["dx_all"], results["tron_mp"]["f64"]["dx_all"])
        elif key == "qpsub":
            err = max(r["dx_all"], results["qpsub"]["f64_nolimit"]["dx_all"])
        else:
            err = r["dx_all"]
        kern.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCES[name][0],
                     "replaces": KERNEL_SOURCES[name][1],
                     "launches": sum(results[m]["launches"][name]
                                     for m in ("main", "main_mp", "main_qp")),
                     "max_abs_err": err, "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "device_ms": r["ms"], "enqueue_ms": r["enqueue_ms"]})
    results["kernels"] = kern
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.qpsub import model as Q
    from exaadmm_tpu_torch.utils.environment import Parameters
    from exaadmm_tpu_torch.utils.synthetic import (synthetic_case,
                                                   synthetic_load_profile)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    big = synthetic_case(9241, seed=0, line_ratio=1.7)
    T = 8
    mp_data = synthetic_case(2869, seed=0, line_ratio=1.7)
    mp_loads = synthetic_load_profile(mp_data, T, seed=0)
    results = run("cuda", big, mp_data, mp_loads, T)
    if "--profile" in sys.argv[1:]:
        model = M.build_model(big, Parameters(verbose=0), device=dev)
        profile_main(dev, "phase 4", two_level_hooks(model),
                     M.init_solution(model, 3e3, 3e5), ("primres",))
        model = _mp_model(dev, mp_data, mp_loads, T, torch.float64,
                          Parameters(verbose=0))
        profile_main(dev, "phase 5", two_level_hooks(model),
                     MP.init_solution(model, 4e2, 4e4), ("primres",))
        model = Q.build_model(big, Parameters(verbose=0, tron_step_cap=24),
                              qp_inputs(big), device=dev)
        sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
        profile_main(dev, "phase 6", one_level_hooks(model.solve_prep(sol)),
                     sol, ("mismatch", "dualres"))
    if "--solve" in sys.argv[1:]:
        solve_to_tolerance(dev, big)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
