"""User-facing single-period ACOPF solve.

Counterpart of ``exaadmm_tpu/interface/solve_acopf.py`` (reference
solve_acopf.jl): the same math arguments and defaults, plus ``device``.
``device`` defaults to ``"cuda"``, which runs the hand-written kernels and
raises ``RuntimeError`` when no CUDA device is present (there is no
fallback); ``device="cpu"``, asked for explicitly, runs their plain PyTorch
versions. ``use_projection`` runs the power-flow projection
(``models/pf/projection.py``, on the host) after the solve.
``solve_acopf_from_env`` re-runs a solve from its ``AdmmEnv``.

``mesh`` (``parallel/sharding.py::make_mesh``, the same call on every rank
of a ``torch.distributed`` run) splits the lines across the ranks;
``pad_lines_to`` pads the line batch to a multiple and defaults to the mesh
size. Every rank gets the whole solution and the same ``info`` back.

``mixed_precision`` runs the branch batch in fp32 inside an fp64 solve
(``Parameters.mixed_precision``); it needs ``dtype=torch.float64``.

The driver is chosen as the JAX package chooses it (``two_level_driver``):
at ``verbose=0`` the fused driver, the whole ADMM loop on the device, with
or without a mesh (JAX ``make_sharded_fused_solver``: on the card the
collectives go into the loop's graph as NCCL work); at ``verbose > 0`` the
host loop. One rule is the port's own: a gloo mesh on CUDA tensors runs the
host loop, since gloo stages each collective through pinned host memory,
which a CUDA graph cannot hold.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.admm_two_level import two_level_driver
from ..models.acopf import model as M
from ..models.pf.projection import pf_projection
from ..parallel.sharding import default_pad, run_sharded
from ..utils import tracing
from ..utils.environment import AdmmEnv, IterationInformation, Parameters, Solution
from ..utils.opfdata import OPFData, opf_loaddata


@dataclasses.dataclass
class SolveResult:
    data: OPFData
    model: "M.ModelAcopf"
    solution: Solution
    info: IterationInformation
    env: AdmmEnv | None = None


@tracing.spanned("entry.solve", entry="solve_acopf")
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
    use_projection: bool = False,
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
    mixed_precision: bool = False,
    pad_lines_to: int = 1,
    mesh=None,
    device="cuda",
    data: OPFData | None = None,
) -> SolveResult:
    """Solve a single-period ACOPF with two-level ADMM.

    ``case`` is a MATPOWER file; pass ``data`` (an already loaded or
    generated :class:`OPFData`) to skip the file. Pass ``mesh`` to split
    the lines across the ranks of a multi-process run; ``pad_lines_to``
    then defaults to the mesh size.
    """
    if mixed_precision and dtype != torch.float64:
        # the flag would otherwise do nothing: only fp64 state is cast down,
        # so an fp32 solve would run as plain fp32 under a mixed label
        raise ValueError(
            "mixed_precision=True needs an fp64 solve (the branch batch is "
            "cast DOWN to fp32): pass dtype=torch.float64")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but CUDA is not "
                           "available")
    if data is None:
        data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    pad_lines_to = default_pad(pad_lines_to, mesh)

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
        mixed_precision=mixed_precision,
    )
    model = M.build_model(data, par, use_linelimit=use_linelimit,
                          tight_factor=tight_factor,
                          pad_lines_to=pad_lines_to, dtype=dtype, device=dev)
    sol = M.init_solution(model, rho_pq, rho_va)
    sol, info = run_sharded(two_level_driver(model, mesh), model, sol, mesh)
    if use_projection:
        sol, proj = pf_projection(data, model, sol, verbose=verbose)
        info.time_projection = proj["time"]
        info.pf_residual = proj["pf_residual"]
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit,
                  use_projection=use_projection)
    return SolveResult(data=data, model=model, solution=sol, info=info,
                       env=env)


def solve_acopf_from_env(env: AdmmEnv, **overrides) -> SolveResult:
    """Re-run a solve from its recorded :class:`AdmmEnv` (JAX
    ``solve_acopf_from_env``): the same case, rho seeds, flags and
    Parameters, with keyword ``overrides`` (``device`` among them) applied
    on top. The case is read from ``env.case`` again, or taken from
    ``env.data`` with ``data=env.data``."""
    par = env.params
    kwargs = dict(
        rho_pq=env.initial_rho_pq,
        rho_va=env.initial_rho_va,
        use_linelimit=env.use_linelimit,
        use_projection=env.use_projection,
        tight_factor=env.tight_factor,
        outer_iterlim=par.outer_iterlim,
        inner_iterlim=par.inner_iterlim,
        obj_scale=par.obj_scale,
        scale=par.scale,
        outer_eps=par.outer_eps,
        initial_beta=par.initial_beta,
        theta=par.theta,
        inc_c=par.inc_c,
        verbose=par.verbose,
        # a step cap truncates lanes, so a recorded run re-solves with it
        tron_step_cap=par.tron_step_cap,
        mixed_precision=par.mixed_precision,
    )
    kwargs.update(overrides)
    return solve_acopf(env.case, **kwargs)
