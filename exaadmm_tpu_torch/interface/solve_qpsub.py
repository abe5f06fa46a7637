"""QP-subproblem solve (the SQP inner iteration).

Counterpart of ``exaadmm_tpu/interface/solve_qpsub.py`` (reference
solve_qpsub.jl): the same positional QP data (Hs, the linearized
constraint rows 1h/1i/1j/1k, delta bounds, shifted costs, residual loads)
and keywords, solved by one-level ADMM, plus ``device`` and ``data`` (as in
``solve_acopf``: ``device`` is ``"cuda"`` by default and raises
``RuntimeError`` without a CUDA device; ``"cpu"`` runs the plain versions).

``use_projection=True`` projects the final state onto the power flow of
the QP's residual loads, on the host (qpsub_admm_prepoststep_cpu.jl:16-19).
``onelevel=False`` raises ``NotImplementedError`` (the JAX package and
the reference do not implement it either). ``mesh`` splits the lines across
the ranks of a multi-process run and ``pad_lines_to`` pads the line batch
(it defaults to the mesh size), as in ``solve_acopf``; the SQP outputs are
computed from the gathered solution on every rank. At ``verbose=0`` the
one-level loop runs fused on the device (``one_level_driver``), over a mesh
too (JAX ``make_sharded_one_level``), except a gloo mesh on CUDA tensors,
which runs the host loop.
``branch_backend``, ``pallas_tile`` and
``bus_backend`` choose between TPU code paths in the JAX package; they are
accepted and ignored: on a CUDA device the port always runs its kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.admm_one_level import one_level_driver
from ..models.pf.projection import pf_projection
from ..models.qpsub import model as Q
from ..parallel.sharding import default_pad, run_sharded
from ..utils import tracing
from ..utils.environment import IterationInformation, Parameters, SolutionQpsub
from ..utils.opfdata import OPFData, opf_loaddata


@dataclasses.dataclass
class QpsubResult:
    data: OPFData
    model: "Q.ModelQpsub"
    solution: SolutionQpsub
    info: IterationInformation
    sqp_out: dict  # dpg/dqg/dline_var/dline_fl/dw/dtheta, dual_infeas, lambda


@tracing.spanned("entry.solve", entry="solve_qpsub")
def solve_qpsub(
    case: str,
    Hs, LH_1h, RH_1h, LH_1i, RH_1i, LH_1j, RH_1j, LH_1k, RH_1k,
    ls, us, pgmax, pgmin, qgmax, qgmin, c1, c2, Pd, Qd,
    initial_beta: float = 1e5,
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
    onelevel: bool = True,
    use_projection: bool = False,
    dtype=torch.float64,
    mesh=None,
    pad_lines_to: int = 1,
    branch_backend: str = "xla",
    pallas_tile: int = 1024,
    tron_step_cap: int | None = None,
    bus_backend: str = "auto",
    device="cuda",
    data: OPFData | None = None,
) -> QpsubResult:
    """Solve the QP subproblem of ``case`` (a MATPOWER file; pass ``data``,
    an already loaded or generated case, to skip the file) with one-level
    ADMM; ``sqp_out`` holds the SQP outputs of ``poststep``."""
    del branch_backend, pallas_tile, bus_backend
    if not onelevel:
        raise NotImplementedError(
            "two-level ADMM is not implemented in QPsub (matches reference)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but CUDA is not "
                           "available")
    if data is None:
        data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    pad_lines_to = default_pad(pad_lines_to, mesh)

    par = Parameters(
        outer_iterlim=outer_iterlim, inner_iterlim=inner_iterlim,
        obj_scale=obj_scale, scale=scale, outer_eps=outer_eps,
        verbose=verbose, initial_beta=initial_beta, beta=initial_beta,
        tron_step_cap=tron_step_cap,
    )
    qp_inputs = dict(
        Hs=Hs, LH_1h=LH_1h, RH_1h=RH_1h, LH_1i=LH_1i, RH_1i=RH_1i,
        LH_1j=LH_1j, RH_1j=RH_1j, LH_1k=LH_1k, RH_1k=RH_1k,
        ls=ls, us=us, pgmax=pgmax, pgmin=pgmin, qgmax=qgmax, qgmin=qgmin,
        c1=c1, c2=c2, Pd=Pd, Qd=Qd,
    )
    model = Q.build_model(data, par, qp_inputs, use_linelimit=use_linelimit,
                          tight_factor=tight_factor,
                          pad_lines_to=pad_lines_to, dtype=dtype, device=dev)
    sol = Q.init_solution(model, rho_pq, rho_va)
    sol, info = run_sharded(one_level_driver(model, mesh), model, sol, mesh)
    sqp_out = Q.poststep(model, sol)
    if use_projection:
        base, proj = pf_projection(data, model, sol.base, Pd=model.Pd,
                                   Qd=model.Qd, verbose=verbose)
        sol = sol.replace(base=base)
        info.time_projection = proj["time"]
        info.pf_residual = proj["pf_residual"]
    return QpsubResult(data=data, model=model, solution=sol, info=info,
                       sqp_out=sqp_out)
