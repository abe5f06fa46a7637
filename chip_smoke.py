#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``exaadmm_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--solve]

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda) and
``nvidia-smi``; imports neither jax nor ``exaadmm_tpu``. It builds the two
kernels of the main path from ``exaadmm_tpu_torch/csrc`` and runs, in order:

0. the card's name and power limit, and the kernels' build (seconds and the
   ``-Xptxas -v`` report);
1. the bus-scatter kernel against its plain version (``index_add_``) on the
   synthetic 9241-bus grid, fp64 and fp32: max relative difference per
   channel (difference over the channel's largest magnitude) <= 1e-13 in
   fp64 and <= 1e-6 in fp32, two kernel runs bit-identical, and both times;
2. the branch TRON/ALM kernel against its plain version on that grid's
   15,710-line batch at the first inner iteration, prox targets perturbed
   from a numpy seed, both at step_cap 50: iteration counts equal on
   >= 99.5 % of lanes and |dx| <= 1e-8 on those lanes in fp64; >= 95 %,
   1e-3 on the agreeing lanes and 5e-3 on all lanes in fp32 (two compilers'
   fp32 rounding may flip a TRON branch decision on a few lanes);
3. case9 end to end through ``solve_acopf(..., device="cuda")``, fp64:
   Solved, objective and dispatch in the known bands, outer/cumul beside the
   pins 25/1087 (within 1 outer and 2 %), one TRON launch per inner
   iteration;
4. the main path at full size: synthetic 9241 buses, fp64, flat start at
   rho (3e3, 3e5), 3 outer x 100 inner iterations: inner iterations per
   second, the final mismatch and the peak device memory. The kernels'
   launch counters are zeroed just before and read just after this run.

``--profile`` adds a breakdown of one inner iteration of phase 4's
configuration (host time per hook, device time by kernel, idle share);
``--solve`` adds the time to tolerance of that configuration's full solve.

Each phase prints one line of numbers; any failure raises, so the script
exits non-zero and prints no result. The line before the last is one JSON
object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
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
PIN_OUTER, PIN_CUMUL = 25, 1087
KERNEL_SOURCES = {
    "tron_alm_branch": ("exaadmm_tpu_torch/csrc/tron_alm_branch.cu",
                        "exaadmm_tpu/ops/tron_pallas.py:42"),
    "bus_scatter": ("exaadmm_tpu_torch/csrc/bus_scatter.cu",
                    "exaadmm_tpu/ops/bus_pallas.py:42"),
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on the card, the host clock
    on the CPU (rehearsal only)."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


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
        for name, mod in (("tron_alm_branch", tron_cuda),
                          ("bus_scatter", bus_cuda)):
            mod.library()
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
    from exaadmm_tpu_torch.ops import bus_cuda
    from exaadmm_tpu_torch.utils.environment import Parameters

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
        ms = time_ms(lambda: bus_cuda.bus_scatter(
            arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx), dev, reps=100)
        plain_ms = time_ms(lambda: bus_cuda.bus_scatter_plain(
            arcs, gd.arc_bus, gd.nbus), dev, reps=100)
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(rel=worst_rel, abs=worst_abs, ms=ms, plain_ms=plain_ms)
        print(f"phase 1: bus_scatter {key} arcs {tuple(arcs.shape)} -> "
              f"{gd.nbus} buses: max rel diff {worst_rel:.3e} (tol {tol:.0e}),"
              f" max abs diff {worst_abs:.3e}, bit-identical reruns, kernel "
              f"{ms:.4f} ms, index_add_ {plain_ms:.4f} ms")
    return out


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

        rk = kernel()
        rp = plain()
        _sync(dev)
        a = act.cpu().numpy()
        mk = rk.minor_iters.cpu().numpy()[a]
        mp = rp.minor_iters.cpu().numpy()[a]
        ak = rk.alm_iters.cpu().numpy()[a]
        ap = rp.alm_iters.cpu().numpy()[a]
        same = (mk == mp) & (ak == ap)
        dx = (rk.x - rp.x).abs().amax(dim=0).cpu().numpy()[a]
        frac = float(same.mean())
        dx_same = float(dx[same].max()) if same.any() else 0.0
        dx_all = float(dx.max())
        _check(bool(np.isfinite(rk.x.cpu().numpy()).all()),
               "tron kernel: non-finite x")
        if dtype == torch.float64:
            _check(frac >= 0.995, f"tron f64: only {frac:.4%} lanes agree")
            _check(dx_same <= 1e-8, f"tron f64: |dx| {dx_same:.3e} > 1e-8")
        else:
            _check(frac >= 0.95, f"tron f32: only {frac:.4%} lanes agree")
            _check(dx_same <= 1e-3, f"tron f32: |dx| {dx_same:.3e} > 1e-3")
            _check(dx_all <= 5e-3, f"tron f32: |dx| {dx_all:.3e} > 5e-3")
        ms = time_ms(kernel, dev, reps=5, warmup=1)
        plain_ms = time_ms(plain, dev, reps=1, warmup=0)
        key = "f64" if dtype == torch.float64 else "f32"
        out[key] = dict(frac=frac, dx_same=dx_same, dx_all=dx_all, ms=ms,
                        plain_ms=plain_ms)
        print(f"phase 2: tron_alm_branch {key} B={x0.shape[1]} step_cap=50: "
              f"{int((~same).sum())} of {same.size} lanes differ in "
              f"minor/alm iterations ({frac:.4%} agree), max |dx| agreeing "
              f"{dx_same:.3e}, all {dx_all:.3e}; minor iters mean "
              f"{mk.mean():.2f} max {mk.max()}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms")
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
    tron_cuda.launches = bus_cuda.launches = 0
    t0 = time.perf_counter()
    res = E.solve_acopf(data.case, data=data, rho_pq=3e3, rho_va=3e5,
                        outer_iterlim=3, inner_iterlim=100, outer_eps=0.0,
                        verbose=0, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {"tron_alm_branch": tron_cuda.launches,
                "bus_scatter": bus_cuda.launches}
    info = res.info
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rate = info.cumul / secs
    print(f"phase 4: {data.case} ({data.nbus} buses, {data.nline} lines, "
          f"{data.ngen} gens) fp64: {info.outer} outer, {info.cumul} inner "
          f"in {secs:.3f} s = {rate:.2f} inner it/s; mismatch "
          f"{info.mismatch!r} primres {info.primres!r} obj {info.objval!r}; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    for name in ("mismatch", "primres", "dualres", "objval", "norm_z_curr"):
        _check(bool(np.isfinite(getattr(info, name))),
               f"main path: {name} not finite")
    _check(bool(torch.isfinite(res.solution.u.line).all()),
           "main path: u not finite")
    if on_card:
        _check(launches["tron_alm_branch"] == info.cumul,
               f"main path: TRON launches {launches}")
        _check(launches["bus_scatter"] == 2 * info.cumul,
               f"main path: bus launches {launches}")
    return dict(launches=launches, rate=rate, seconds=secs,
                mismatch=info.mismatch, peak=peak)


def profile_main(dev, data, warmup: int = 5, iters: int = 20) -> dict:
    """Where an inner iteration's time goes on the main path (synthetic 9241
    buses, fp64, rho (3e3, 3e5), from the flat start): host time per hook
    with a synchronize after each hook; the wall time per iteration without
    them; and, from torch.profiler over the same unsynchronized iterations,
    the device time by kernel and the device's idle share."""
    from exaadmm_tpu_torch.models.acopf import model as M
    from exaadmm_tpu_torch.utils.environment import Parameters

    model = M.build_model(data, Parameters(verbose=0), device=dev)
    state = {"sol": M.init_solution(model, 3e3, 3e5), "inner": 0}
    beta = 1e3
    hooks = (
        ("x", lambda s: model.update_x(model.inner_prestep(s),
                                       state["inner"])[0]),
        ("xbar", model.update_xbar),
        ("z", lambda s: model.update_z(s, beta)),
        ("l", lambda s: model.update_l(s, beta)),
        ("residual", lambda s: model.update_residual(s, beta)),
    )

    def step(times=None):
        state["inner"] += 1
        sol = state["sol"]
        for name, fn in hooks:
            t0 = time.perf_counter()
            sol = fn(sol)
            if name == "residual":
                sol, scalars = sol
                float(scalars["primres"])  # the ADMM loop's one read-back
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
    print(f"profile: per inner iteration {wall_ms:.3f} ms wall; with a "
          f"synchronize after each hook: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in hook_ms.items()))
    print(f"profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {launches:.1f} device "
          f"activities per iteration")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (t, n) in top:
        print(f"profile:   {t:9.4f} ms x{n:5.1f}  {name[:100]}")
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


def run(device, big_data) -> dict:
    """All phases on ``device``; ``big_data`` is the full-size grid. On a
    CPU device (a rehearsal) the wrappers run their plain versions, so the
    kernel comparisons and launch counts are not meaningful there."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    results = {"device": phase0_device(dev, on_card)}
    results["bus"] = phase1_bus(dev, big_data, on_card)
    results["tron"] = phase2_tron(dev, big_data, on_card)
    results["case9"] = phase3_case9(dev, on_card)
    results["main"] = phase4_main(dev, big_data, on_card)
    kern = []
    for name, key in (("tron_alm_branch", "tron"), ("bus_scatter", "bus")):
        r = results[key]["f64"]
        err = r["dx_all"] if key == "tron" else r["abs"]
        kern.append({"name": name, "route": "cuda",
                     "source": KERNEL_SOURCES[name][0],
                     "replaces": KERNEL_SOURCES[name][1],
                     "launches": results["main"]["launches"][name],
                     "max_abs_err": err, "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    results["kernels"] = kern
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from exaadmm_tpu_torch.utils.synthetic import synthetic_case

    t0 = time.perf_counter()
    big = synthetic_case(9241, seed=0, line_ratio=1.7)
    results = run("cuda", big)
    if "--profile" in sys.argv[1:]:
        profile_main(torch.device("cuda"), big)
    if "--solve" in sys.argv[1:]:
        solve_to_tolerance(torch.device("cuda"), big)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
