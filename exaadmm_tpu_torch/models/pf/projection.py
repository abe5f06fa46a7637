"""Feasibility restoration after ADMM: the power-flow projection.

Counterpart of ``exaadmm_tpu/models/pf/projection.py`` (reference
pf_projection.jl). Steps:
1. average each bus's Vm / Va over the copies of its incident lines in ``u``,
2. run Newton-Raphson from that point (Vm fixed at PV/slack buses, generator
   P/Q fixed at the ADMM values),
3. write the solved bus voltages back into every incident line's ``v`` rows,
4. recompute slack-bus P/Q and PV-bus Q from the solved flows and split
   them across the colocated generators.

It runs on the host with numpy and scipy, as in the JAX package and the
reference: the solution's ``u`` and ``v`` are copied to the host once, and
the projected ``v`` goes back to the solution's device and dtype.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...utils.environment import Blocks
from ...utils.opfdata import OPFData
from .newton import build_ybus, solve_pf_core


def _host(a) -> np.ndarray:
    """A tensor (or array) as a float64 numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, np.float64)


def pf_projection(data: OPFData, model, sol, Pd=None, Qd=None,
                  tol: float = 1e-6, max_iter: int = 50, verbose: int = 0):
    """Returns (sol with projected v, info dict). ``Pd``/``Qd`` replace the
    case's loads (numpy or tensors, MW); ``model`` is not read (the JAX
    signature)."""
    t0 = time.perf_counter()
    nb = data.nbus
    nline = data.nline
    u_line = _host(sol.u.line)[:nline]
    u_gen = _host(sol.u.gen)
    v_line = _host(sol.v.line).copy()
    f, t = data.line_from, data.line_to

    Pd = data.Pd if Pd is None else _host(Pd)
    Qd = data.Qd if Qd is None else _host(Qd)

    # 1. per-bus averages of the duplicated (w, theta) line copies
    cnt = np.bincount(f, minlength=nb) + np.bincount(t, minlength=nb)
    vm_sum = (np.bincount(f, weights=np.sqrt(np.maximum(u_line[:, 4], 0.0)),
                          minlength=nb)
              + np.bincount(t, weights=np.sqrt(np.maximum(u_line[:, 5], 0.0)),
                            minlength=nb))
    va_sum = (np.bincount(f, weights=u_line[:, 6], minlength=nb)
              + np.bincount(t, weights=u_line[:, 7], minlength=nb))
    cnt_safe = np.maximum(cnt, 1)
    vm = np.clip(vm_sum / cnt_safe, data.Vmin, data.Vmax)
    va = va_sum / cnt_safe

    # 2. NR with the generator set points from the ADMM u (v gens <- u gens
    #    first, pf_projection.jl:33)
    res = solve_pf_core(data, vm, va, u_gen[:, 0].copy(), u_gen[:, 1].copy(),
                        Pd=Pd, Qd=Qd, tol=tol, max_iter=max_iter,
                        verbose=verbose)
    vm, va = res.vm, res.va

    # 3. write the voltages back into the line consensus copies
    v_line[:nline, 4] = vm[f] ** 2
    v_line[:nline, 6] = va[f]
    v_line[:nline, 5] = vm[t] ** 2
    v_line[:nline, 7] = va[t]

    # 4. recompute slack P/Q and PV-bus Q from the solved flows
    V = vm * np.exp(1j * va)
    S = V * np.conj(build_ybus(data) @ V)  # net injection
    v_gen = u_gen.copy()
    gen_cnt = np.bincount(data.gen_bus, minlength=nb)
    sbus = data.bus_ref
    pg_s = S.real[sbus] + Pd[sbus] / data.baseMVA
    qg_s = S.imag[sbus] + Qd[sbus] / data.baseMVA
    for g in np.nonzero(data.gen_bus == sbus)[0]:
        v_gen[g, 0] = pg_s / gen_cnt[sbus]
        v_gen[g, 1] = qg_s / gen_cnt[sbus]
    for b in np.nonzero(data.bus_type == 2)[0]:
        qg_b = S.imag[b] + Qd[b] / data.baseMVA
        for g in np.nonzero(data.gen_bus == b)[0]:
            v_gen[g, 1] = qg_b / gen_cnt[b]

    like = sol.v.gen
    new_v = Blocks(
        gen=torch.as_tensor(v_gen).to(device=like.device, dtype=like.dtype),
        line=torch.as_tensor(v_line).to(device=like.device, dtype=like.dtype))
    info = {
        "time": time.perf_counter() - t0,
        "pf_residual": res.residual,
        "pf_iterations": res.iterations,
        "pf_converged": res.converged,
    }
    return sol.replace(v=new_v), info
