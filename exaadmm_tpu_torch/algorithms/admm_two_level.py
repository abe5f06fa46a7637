"""Two-level ADMM driver, driven from the host.

Counterpart of both ``admm_two_level`` and ``admm_two_level_fused`` in
``exaadmm_tpu/algorithms/admm_two_level.py`` (the two are one algorithm; the
fused one only moves the loops onto the device). Reference:
admm_two_level.jl.

Inner iteration order (admm_two_level.jl:34-63):
    z_prev <- z;  x;  xbar;  z;  l;  residual
with the adaptive inner tolerance eps_pri = sqrt(nvar)/(2500*outer) and a
break when primres <= eps_pri; primres is the one scalar read back per inner
iteration. Outer: converged when ||u - v|| <= sqrt(nvar)*outer_eps;
otherwise lz <- clamp(lz + beta z) and beta <- min(inc_c*beta, cap) when
||z|| > theta*||z_prev||.
"""

from __future__ import annotations

import time

import torch

from ..utils.environment import IterationInformation, Solution


def _beta_cap(dtype) -> float:
    """Ceiling of the outer penalty beta.

    The reference caps beta at 1e24 (admm_two_level.jl:75), which no fp64
    schedule reaches. In a narrower dtype an uncapped beta ratchets up
    whenever ||z|| stalls and then wrecks the z/l/lz updates, so it is capped
    at 0.1/eps, the rule the branch ALM's mu_max follows too."""
    eps = torch.finfo(dtype).eps
    if eps <= torch.finfo(torch.float64).eps:
        return 1e24
    return 0.1 / float(eps)


def admm_two_level(model, sol: Solution,
                   info: IterationInformation | None = None, Pd=None, Qd=None):
    """Run the two-level ADMM; returns (sol, info)."""
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dtype = sol.u.gen.dtype

    beta = min(par.initial_beta, _beta_cap(dtype))
    info.status = "IterationLimit"
    info.norm_z_curr = info.norm_z_prev = float("inf")

    if par.verbose > 0:
        print(f"{'Outer':>6} {'Inner':>6} {'Objval':>12} {'AugLag':>12} "
              f"{'PrimRes':>10} {'EpsPrim':>10} {'DualRes':>10} {'||z||':>10} "
              f"{'Mismatch':>10} {'OuterTol':>10} {'Beta':>10}")

    t0 = time.perf_counter()
    while info.outer < par.outer_iterlim:
        info.outer += 1
        info.norm_z_prev = info.norm_z_curr  # outer prestep: save ||z||
        eps_pri = sqrt_d / (2500.0 * info.outer)

        inner = 0
        scalars = stats = None
        while inner < par.inner_iterlim:
            sol = model.inner_prestep(sol)
            inner += 1
            sol, stats = model.update_x(sol, inner)
            sol = model.update_xbar(sol, Pd=Pd, Qd=Qd)
            sol = model.update_z(sol, beta)
            sol = model.update_l(sol, beta)
            sol, scalars = model.update_residual(sol, beta)
            if not float(scalars["primres"]) > eps_pri:
                break

        info.inner = inner
        info.cumul += inner
        vals = torch.stack([scalars[k] for k in (
            "primres", "dualres", "norm_z_curr", "mismatch", "objval",
            "auglag")] + [stats["max_cviol"].to(dtype)]).tolist()
        (info.primres, info.dualres, info.norm_z_curr, info.mismatch,
         info.objval, info.auglag, info.max_cviol) = vals
        info.eps_pri = eps_pri

        if par.verbose > 0:
            print(f"{info.outer:>6d} {info.inner:>6d} {info.objval:>12.5e} "
                  f"{info.auglag:>12.5e} {info.primres:>10.3e} "
                  f"{info.eps_pri:>10.3e} {info.dualres:>10.3e} "
                  f"{info.norm_z_curr:>10.3e} {info.mismatch:>10.3e} "
                  f"{outer_tol:>10.3e} {beta:>10.3e}")

        if info.mismatch <= outer_tol:
            info.status = "Solved"
            break

        sol = model.update_lz(sol, beta)
        if info.norm_z_curr > par.theta * info.norm_z_prev:
            beta = min(par.inc_c * beta, _beta_cap(dtype))

    info.time_overall = time.perf_counter() - t0
    par.beta = beta
    return sol, info
