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

With ``Parameters.time_hooks`` the loop fills the ``time_*_update`` fields
of ``IterationInformation`` (the JAX package's ``verbose >= 2`` stepping):
it synchronizes the device after every hook, so the times are the hooks' and
the loop is slower. With it off (the default) the loop issues no extra call.

With ``Parameters.sort_lines`` and a model that ``supports_line_sort``,
each outer round after the first starts by sorting the line batch by the
lanes' effort in the last inner iteration (``lane_steps``, stable
ascending, as the JAX package's ``_sorted_inner_while``): the hooks then run
on ``model.with_line_order(ids)``, the caller's model with its lines in the
composed order (the model knows which of its arrays are indexed by line),
and the state is permuted with it. The sort reads nothing back. The
solution is put back into canonical order before it is returned.

With the lines split across ranks (``parallel/sharding.py``) every rank runs
this loop over its own model; the scalars read back here derive from
all-reduced tensors and replicated data, so every rank breaks on the same
iteration. A rank sorts its own line window, with no communication.
"""

from __future__ import annotations

import time

import torch

from ..utils.environment import (IterationInformation, Solution,
                                 permute_solution_lines)


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


def _call(name, fn, *args, **kwargs):
    return fn(*args, **kwargs)


def _timed_call(info: IterationInformation, dev):
    """``_call`` that adds the hook's seconds, device work included, to
    ``info.time_<name>_update``."""
    def call(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        field = f"time_{name}_update"
        setattr(info, field, getattr(info, field) + time.perf_counter() - t0)
        return out
    return call


def admm_two_level(model, sol: Solution,
                   info: IterationInformation | None = None, Pd=None, Qd=None):
    """Run the two-level ADMM; returns (sol, info).

    ``Pd``/``Qd`` replace the grid's loads for this call (a rolling horizon
    re-solves one model period by period with them, setting the model's
    ``pgmin_curr``/``pgmax_curr`` between calls). beta starts at
    ``initial_beta`` on every call."""
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dtype = sol.u.gen.dtype
    call = _timed_call(info, sol.u.gen.device) if par.time_hooks else _call
    sorting = getattr(model, "supports_line_sort", False) and par.sort_lines
    model0 = model
    # position -> canonical line id of the current order (None: canonical)
    line_ids = None

    beta = min(par.initial_beta, _beta_cap(dtype))
    info.status = "IterationLimit"
    info.norm_z_curr = info.norm_z_prev = float("inf")

    if par.verbose > 0:
        print(f"{'Outer':>6} {'Inner':>6} {'Objval':>12} {'AugLag':>12} "
              f"{'PrimRes':>10} {'EpsPrim':>10} {'DualRes':>10} {'||z||':>10} "
              f"{'Mismatch':>10} {'OuterTol':>10} {'Beta':>10}")

    t0 = time.perf_counter()
    stats = None
    while info.outer < par.outer_iterlim:
        info.outer += 1
        info.norm_z_prev = info.norm_z_curr  # outer prestep: save ||z||
        eps_pri = sqrt_d / (2500.0 * info.outer)

        if sorting and stats is not None:
            # the first round's lane_steps would be all 0: the identity
            reorder = torch.argsort(stats["lane_steps"], stable=True)
            line_ids = reorder if line_ids is None else line_ids[reorder]
            model = model0.with_line_order(line_ids)
            sol = permute_solution_lines(sol, reorder)

        inner = 0
        scalars = stats = None
        while inner < par.inner_iterlim:
            sol = model.inner_prestep(sol)
            inner += 1
            sol, stats = call("x", model.update_x, sol, inner)
            sol = call("xbar", model.update_xbar, sol, Pd=Pd, Qd=Qd)
            sol = call("z", model.update_z, sol, beta)
            sol = call("l", model.update_l, sol, beta)
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

        sol = call("lz", model.update_lz, sol, beta)
        if info.norm_z_curr > par.theta * info.norm_z_prev:
            beta = min(par.inc_c * beta, _beta_cap(dtype))

    if line_ids is not None:
        sol = permute_solution_lines(sol, torch.argsort(line_ids))
    info.time_overall = time.perf_counter() - t0
    par.beta = beta
    return sol, info
