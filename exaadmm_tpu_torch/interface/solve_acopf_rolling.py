"""Rolling-horizon ACOPF: one period after another, warm-started,
ramp-tightened.

Counterpart of ``exaadmm_tpu/interface/solve_acopf_rolling.py`` (reference
solve_acopf_rolling + admm_restart_rolling, solve_acopf_rolling.jl and
acopf_admm_rolling_cpu.jl): for each period t the loads are column t, the
two-level driver re-enters with the previous period's whole solution (a
fresh ``IterationInformation``, beta back at ``initial_beta``), and after it
the real-power bounds tighten to u +- ramp_rate. The same arguments and
defaults, plus ``device`` (as in ``solve_acopf``: ``"cuda"`` by default,
raising ``RuntimeError`` without a CUDA device; ``"cpu"`` runs the plain
versions) and ``data``/``loads`` (as in ``solve_mpacopf``).
"""

from __future__ import annotations

import torch

from ..algorithms.admm_two_level import two_level_driver
from ..models.acopf import model as M
from ..utils import tracing
from ..utils.environment import IterationInformation, Parameters
from ..utils.opfdata import OPFData, load_time_series, opf_loaddata
from .solve_acopf import SolveResult


def update_real_power_current_bounds(pgmin, pgmax, ramp_rate, pg_curr):
    """pgmin_curr = max(pgmin, pg - r); pgmax_curr = min(pgmax, pg + r)
    (acopf_admm_rolling_cpu.jl:1-13)."""
    return (torch.maximum(pgmin, pg_curr - ramp_rate),
            torch.minimum(pgmax, pg_curr + ramp_rate))


@tracing.spanned("entry.solve", entry="solve_acopf_rolling")
def solve_acopf_rolling(
    case: str,
    load_prefix: str | None = None,
    *,
    case_format: str = "matpower",
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 400.0,
    rho_va: float = 40000.0,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    use_linelimit: bool = True,
    tight_factor: float = 0.99,
    outer_eps: float = 2e-4,
    verbose: int = 1,
    ramp_ratio: float = 0.02,
    start_period: int = 1,
    end_period: int = 6,
    load_scale: float = 1.0,
    dtype=torch.float64,
    device="cuda",
    data: OPFData | None = None,
    loads=None,
):
    """Returns (SolveResult for the last period, list of per-period infos).

    The loads come from ``<load_prefix>.Pd`` / ``.Qd`` (rows buses, columns
    periods), or from ``loads = (Pd, Qd)`` of that shape; ``load_scale``
    multiplies either."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but CUDA is not "
                           "available")
    if data is None:
        data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    if loads is None:
        pd_mat, qd_mat = load_time_series(load_prefix, load_scale)
    else:
        pd_mat, qd_mat = (m * load_scale for m in loads)
    if pd_mat.shape[0] != data.nbus:
        raise ValueError(f"loads have {pd_mat.shape[0]} rows for "
                         f"{data.nbus} buses")
    if not 1 <= start_period <= end_period <= pd_mat.shape[1]:
        raise ValueError(f"periods {start_period}..{end_period} outside "
                         f"1..{pd_mat.shape[1]}")

    par = Parameters(outer_iterlim=outer_iterlim, inner_iterlim=inner_iterlim,
                     obj_scale=obj_scale, scale=scale, outer_eps=outer_eps,
                     verbose=verbose)
    model = M.build_model(data, par, use_linelimit=use_linelimit,
                          tight_factor=tight_factor, dtype=dtype, device=dev)
    gd = model.grid
    ramp_rate = ramp_ratio * gd.pgmax

    sol = M.init_solution(model, rho_pq, rho_va)
    # one driver for every period: the fused one reuses its graph
    solve = two_level_driver(model)
    infos = []
    for t in range(start_period - 1, end_period):
        Pd = torch.as_tensor(pd_mat[:, t]).to(device=dev, dtype=dtype)
        Qd = torch.as_tensor(qd_mat[:, t]).to(device=dev, dtype=dtype)
        sol, info = solve(model, sol, IterationInformation(), Pd=Pd, Qd=Qd)
        infos.append(info)
        if verbose > 0:
            print(f" ** Period {t + 1}: status={info.status} "
                  f"obj={info.objval:.6e} mismatch={info.mismatch:.3e} "
                  f"time={info.time_overall:.3f}s")
        # the next period's generators solve within the tightened bounds
        model.pgmin_curr, model.pgmax_curr = update_real_power_current_bounds(
            gd.pgmin, gd.pgmax, ramp_rate, sol.u.gen[:, 0])

    return SolveResult(data=data, model=model, solution=sol,
                       info=infos[-1]), infos
