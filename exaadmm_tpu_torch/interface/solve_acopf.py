"""User-facing single-period ACOPF solve.

Counterpart of ``exaadmm_tpu/interface/solve_acopf.py`` (reference
solve_acopf.jl): the same math arguments and defaults, plus ``device``.
``device`` defaults to ``"cuda"``, which runs the hand-written kernels and
raises ``RuntimeError`` when no CUDA device is present (there is no
fallback); ``device="cpu"``, asked for explicitly, runs their plain PyTorch
versions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.admm_two_level import admm_two_level
from ..models.acopf import model as M
from ..utils.environment import AdmmEnv, IterationInformation, Parameters, Solution
from ..utils.opfdata import OPFData, opf_loaddata


@dataclasses.dataclass
class SolveResult:
    data: OPFData
    model: "M.ModelAcopf"
    solution: Solution
    info: IterationInformation
    env: AdmmEnv | None = None


def solve_acopf(
    case: str,
    *,
    case_format: str = "matpower",
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 400.0,
    rho_va: float = 40000.0,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    use_linelimit: bool = True,
    tight_factor: float = 1.0,
    outer_eps: float = 2e-4,
    verbose: int = 1,
    dtype=torch.float64,
    initial_beta: float = 1e3,
    # outer-penalty escalation threshold (reference theta=0.8,
    # admm_two_level.jl:74); case9 contracts just below it, see PARITY.md
    theta: float = 0.8,
    inc_c: float = 6.0,
    tron_step_cap: int | None = None,
    device="cuda",
    data: OPFData | None = None,
) -> SolveResult:
    """Solve a single-period ACOPF with two-level ADMM.

    ``case`` is a MATPOWER file; pass ``data`` (an already loaded or
    generated :class:`OPFData`) to skip the file.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but CUDA is not "
                           "available")
    if data is None:
        data = opf_loaddata(case, case_format=case_format, verbose=verbose)

    par = Parameters(
        outer_iterlim=outer_iterlim,
        inner_iterlim=inner_iterlim,
        obj_scale=obj_scale,
        scale=scale,
        outer_eps=outer_eps,
        initial_beta=initial_beta,
        beta=initial_beta,
        theta=theta,
        inc_c=inc_c,
        verbose=verbose,
        tron_step_cap=tron_step_cap,
    )
    model = M.build_model(data, par, use_linelimit=use_linelimit,
                          tight_factor=tight_factor, dtype=dtype, device=dev)
    sol = M.init_solution(model, rho_pq, rho_va)
    sol, info = admm_two_level(model, sol)
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit)
    return SolveResult(data=data, model=model, solution=sol, info=info,
                       env=env)
