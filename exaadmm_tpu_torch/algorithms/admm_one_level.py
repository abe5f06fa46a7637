"""One-level ADMM driver (used by the qpsub model), driven from the host.

Counterpart of ``exaadmm_tpu/algorithms/admm_one_level.py`` (reference
admm_one_level.jl): the two-level machinery is off (z = lz = 0, one inner
iteration per outer), each iteration runs x -> xbar -> l += rho (u - v) ->
residual, and the solve stops when

    ||u - v|| <= sqrt(d) outer_eps   and   dualres <= outer_eps ||rho||

(admm_one_level.jl:65, with dualres = ||rho (v - v_prev)||, Boyd's
single-level dual residual). The JAX package runs the whole solve as one
jitted while loop; this loop gives the same sequence from the host: the
condition is tested before each iteration on scalars that start at inf,
and each iteration reads back one stacked tensor of (mismatch, dualres).
"""

from __future__ import annotations

import time

import torch

from ..utils.environment import IterationInformation


def admm_one_level(model, sol, info: IterationInformation | None = None):
    """Run one-level ADMM; returns (sol, info)."""
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dual_tol = outer_tol * model.rho_norm(sol) / sqrt_d

    sol = model.one_level_reset(sol)
    # the solve's loop-invariant QP constants, computed once
    model = model.solve_prep(sol)

    if par.verbose > 0:
        print(f"{'Iter':>8} {'Objval':>12} {'AugLag':>12} {'PrimRes':>10} "
              f"{'PrimTol':>10} {'DualRes':>10} {'DualTol':>10}")
    it = 0
    mismatch = dualres = float("inf")
    scalars = None
    t0 = time.perf_counter()
    while it < par.outer_iterlim and not (mismatch <= outer_tol
                                          and dualres <= dual_tol):
        it += 1
        sol, _ = model.update_x(sol, it)
        sol = model.update_xbar(sol)        # keeps v_prev
        sol = model.update_l_single(sol)
        sol, scalars = model.update_residual(sol, 0.0)
        mismatch, dualres = torch.stack(
            [scalars["mismatch"], scalars["dualres"]]).tolist()
        if par.verbose > 0 and (it % 50 == 1 or par.verbose > 1):
            objval, auglag, primres = torch.stack(
                [scalars[k] for k in ("objval", "auglag", "primres")]).tolist()
            print(f"{it:>8d} {objval:>12.5e} {auglag:>12.5e} "
                  f"{primres:>10.3e} {outer_tol:>10.3e} {dualres:>10.3e} "
                  f"{dual_tol:>10.3e}")
    info.time_overall = time.perf_counter() - t0

    info.outer = info.cumul = it
    info.inner = 1
    info.mismatch, info.dualres = mismatch, dualres
    if scalars is None:
        info.primres, info.objval, info.auglag = float("inf"), 0.0, 0.0
    else:
        info.primres, info.objval, info.auglag = torch.stack(
            [scalars[k] for k in ("primres", "objval", "auglag")]).tolist()
    converged = mismatch <= outer_tol and dualres <= dual_tol
    info.status = "Solved" if converged else "IterationLimit"
    return sol, info
