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

``use_projection=True`` projects every period onto its own power flow, with
that period's loads (mpacopf_admm_prepoststep_cpu.jl:48-56), on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.admm_two_level import two_level_driver
from ..models.acopf import model as acopf_M
from ..models.mpacopf import model as mp_M
from ..models.pf.projection import pf_projection
from ..utils import tracing
from ..utils.environment import (AdmmEnv, Blocks, IterationInformation,
                                 Parameters, SolutionMpacopf)
from ..utils.opfdata import OPFData, load_time_series, opf_loaddata


@dataclasses.dataclass
class MpacopfResult:
    data: OPFData
    model: "mp_M.ModelMpacopf"
    solution: SolutionMpacopf
    info: IterationInformation
    err_ramp: float
    env: AdmmEnv | None = None


@tracing.spanned("entry.solve", entry="solve_mpacopf")
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
        # one driver for every period: the fused one reuses its graph
        solve = two_level_driver(single)
        for t in range(model.T):
            s_t, info_t = solve(
                single, acopf_M.init_solution(single, rho_pq, rho_va),
                Pd=model.Pd[t], Qd=model.Qd[t])
            if verbose > 0:
                print(f" warm start period {t + 1}: {info_t.status} "
                      f"obj={info_t.objval:.6e}")
            warm.append(s_t)

    sol = mp_M.init_solution(model, rho_pq, rho_va, warm=warm)
    sol, info = two_level_driver(model)(model, sol)
    if use_projection:
        sol = _project_periods(data, model, sol, info, verbose)
    err_ramp = mp_M.check_ramp_violations(model, sol)
    if verbose > 0:
        print(f" ** mpacopf: {info.status} obj={info.objval:.6e} "
              f"err_ramp={err_ramp:.3e}")
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=model.par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit,
                  use_projection=use_projection, load_specified=True,
                  horizon_length=end_period - start_period + 1)
    return MpacopfResult(data=data, model=model, solution=sol, info=info,
                         err_ramp=err_ramp, env=env)


def _project_periods(data: OPFData, model, sol: SolutionMpacopf,
                     info: IterationInformation, verbose: int
                     ) -> SolutionMpacopf:
    """Each period's state projected onto the power flow of its own loads
    (the JAX package's poststep; ``tests/test_mpacopf.py`` guards the
    per-period loads); ``info`` gets the summed time and the worst
    residual."""
    ac = sol.acopf
    v_gen, v_line = [], []
    info.time_projection, info.pf_residual = 0.0, 0.0
    for t in range(model.T):
        period = ac.replace(
            u=Blocks(gen=ac.u.gen[t], line=ac.u.line[t]),
            v=Blocks(gen=ac.v.gen[t], line=ac.v.line[t]))
        proj, pinfo = pf_projection(data, model, period, Pd=model.Pd[t],
                                    Qd=model.Qd[t], verbose=verbose)
        v_gen.append(proj.v.gen)
        v_line.append(proj.v.line)
        info.time_projection += pinfo["time"]
        info.pf_residual = max(info.pf_residual, pinfo["pf_residual"])
    return sol.replace(acopf=ac.replace(
        v=Blocks(gen=torch.stack(v_gen), line=torch.stack(v_line))))
