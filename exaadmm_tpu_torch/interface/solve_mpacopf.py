"""User-facing multi-period ACOPF solve.

Counterpart of ``exaadmm_tpu/interface/solve_mpacopf.py`` (reference
solve_mpacopf.jl): the same arguments and defaults, plus ``device`` (as in
``solve_acopf``: ``"cuda"`` by default, raising ``RuntimeError`` without a
CUDA device; ``"cpu"`` runs the plain versions), ``data`` (an already loaded or generated case) and
``loads`` ((Pd, Qd) matrices in place of the ``<load_prefix>.Pd/.Qd``
files).

One deviation from the reference, by design and as in the JAX package: the
reference's ``warm_start=true`` pass solves each period alone and then
calls ``init_solution!``, which resets the period states to a flat start
(solve_mpacopf.jl:27-32, then mpacopf_init_solution_cpu.jl:7), discarding
the warm start. Here ``warm_start=True`` keeps the solved period states and
derives the ramp coupling from them.

``use_projection=True`` needs the power-flow projection, which is not
ported yet, and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.admm_two_level import admm_two_level
from ..models.acopf import model as acopf_M
from ..models.mpacopf import model as mp_M
from ..utils.environment import (AdmmEnv, IterationInformation, Parameters,
                                 SolutionMpacopf)
from ..utils.opfdata import OPFData, load_time_series, opf_loaddata


@dataclasses.dataclass
class MpacopfResult:
    data: OPFData
    model: "mp_M.ModelMpacopf"
    solution: SolutionMpacopf
    info: IterationInformation
    err_ramp: float
    env: AdmmEnv | None = None


def solve_mpacopf(
    case: str,
    load_prefix: str | None = None,
    *,
    case_format: str = "matpower",
    start_period: int = 1,
    end_period: int = 1,
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 4e2,
    rho_va: float = 4e4,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    use_linelimit: bool = True,
    tight_factor: float = 1.0,
    outer_eps: float = 2e-4,
    verbose: int = 1,
    ramp_ratio: float = 0.02,
    warm_start: bool = True,
    load_scale: float = 1.0,
    use_projection: bool = False,
    dtype=torch.float64,
    device="cuda",
    data: OPFData | None = None,
    loads=None,
) -> MpacopfResult:
    """Solve periods start_period..end_period (1-based) of a multi-period
    ACOPF with two-level ADMM.

    The loads come from ``<load_prefix>.Pd`` / ``.Qd`` (rows buses, columns
    periods), or from ``loads = (Pd, Qd)`` of that shape; ``load_scale``
    multiplies either."""
    if use_projection:
        raise NotImplementedError(
            "use_projection needs the power-flow projection, not ported yet")
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

    par = Parameters(outer_iterlim=outer_iterlim, inner_iterlim=inner_iterlim,
                     obj_scale=obj_scale, scale=scale, outer_eps=outer_eps,
                     verbose=verbose)
    model = mp_M.build_model(
        data, par, pd_mat, qd_mat, start_period=start_period,
        end_period=end_period, use_linelimit=use_linelimit,
        tight_factor=tight_factor, ramp_ratio=ramp_ratio, dtype=dtype,
        device=dev)

    warm = None
    if warm_start and model.T > 1:
        single = acopf_M.ModelAcopf(grid=model.grid,
                                    par=dataclasses.replace(par),
                                    use_linelimit=use_linelimit)
        warm = []
        for t in range(model.T):
            s_t, info_t = admm_two_level(
                single, acopf_M.init_solution(single, rho_pq, rho_va),
                Pd=model.Pd[t], Qd=model.Qd[t])
            if verbose > 0:
                print(f" warm start period {t + 1}: {info_t.status} "
                      f"obj={info_t.objval:.6e}")
            warm.append(s_t)

    sol = mp_M.init_solution(model, rho_pq, rho_va, warm=warm)
    sol, info = admm_two_level(model, sol)
    err_ramp = mp_M.check_ramp_violations(model, sol)
    if verbose > 0:
        print(f" ** mpacopf: {info.status} obj={info.objval:.6e} "
              f"err_ramp={err_ramp:.3e}")
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=model.par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit,
                  load_specified=True,
                  horizon_length=end_period - start_period + 1)
    return MpacopfResult(data=data, model=model, solution=sol, info=info,
                         err_ramp=err_ramp, env=env)
