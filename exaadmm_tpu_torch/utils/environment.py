"""Algorithm parameters and the ADMM state, as dataclasses of tensors.

Counterpart of ``exaadmm_tpu/utils/environment.py``. The pytrees there become
plain dataclasses here: ``replace`` returns a copy with some fields changed,
and ``to`` moves every tensor to another device or dtype.

- ``Parameters`` holds only the constants the ported solves read,
- ``Blocks`` is one ADMM-space vector split by component class: (ngen, 2)
  generator rows ``[pg, qg]`` and (nline_padded, 8) line rows
  ``[pij, qij, pji, qji, wi, wj, thi, thj]``,
- ``Solution`` is the ADMM state, with the per-line ALM multipliers of the
  branch subproblems in ``BranchALMState``,
- ``SolutionMpacopf`` is the multi-period state: a ``Solution`` whose
  tensors have a leading period axis, and the ramp coupling in
  ``RampState``,
- ``SolutionQpsub`` is the QP-subproblem state: a ``Solution``, the line
  deltas, the previous v and the per-line 1j/1k ALM state,
- ``IterationInformation`` holds the host-side counters and scalars.

The MPEC state (``SolutionMpec``) lives in ``models/mpec/model.py``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

# line-block column indices (order matches the reference layout)
PIJ, QIJ, PJI, QJI, WI, WJ, THI, THJ = range(8)


class _TensorRecord:
    """``replace`` and ``to`` for a dataclass whose fields are tensors or
    records of tensors.

    ``LINE_LEAVES`` names the record's own tensor fields that are indexed by
    line, the ones ``parallel/sharding.py`` splits across ranks; their line
    axis is ``LINE_AXIS`` of the outermost record (1 where a period axis
    leads)."""

    LINE_LEAVES: ClassVar[tuple] = ()
    LINE_AXIS: ClassVar[int] = 0

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, *args, **kwargs):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(*args, **kwargs)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Parameters:
    """Algorithm constants (reference environment.jl:43-75 defaults)."""

    mu_max: float = 1e8          # ALM penalty cap (branch subproblems)
    max_auglag: int = 50         # max ALM rounds per branch solve
    verbose: int = 1

    # two-level ADMM
    initial_beta: float = 1e3
    beta: float = 1e3
    inc_c: float = 6.0
    theta: float = 0.8
    outer_eps: float = 2e-4
    MAX_MULTIPLIER: float = 1e12

    outer_iterlim: int = 20
    inner_iterlim: int = 1000
    scale: float = 1e-4          # scales the branch objective
    obj_scale: float = 1.0       # scales the generator cost coefficients

    # TRON (reference acopf_auglag_linelimit_kernel_cpu.jl:95-116)
    tron_gtol: float = 1e-6
    tron_frtol: float = 1e-12
    tron_max_minor: int = 200
    # cap on the trust-region steps of one branch solve per lane; None means
    # max_minor * max_auglag (the reference's own caps)
    tron_step_cap: int | None = None

    # fill IterationInformation's time_*_update fields: the two-level loop
    # then synchronizes after every hook, which slows it (it is host-bound)
    time_hooks: bool = False

    # branch ALM termination (auglag kernel :128-137)
    alm_ctol: float = 1e-6

    # difficulty-sort the line batch at the start of every outer round (a
    # model with ``supports_line_sort``): the lanes are reordered by the
    # trust-region steps and ALM rounds they took in the last inner
    # iteration, ascending and stable, so the stragglers share warps and
    # blocks of the TRON kernel instead of holding one lane in every warp.
    # Every line-indexed array moves with them and the bus CSR is derived
    # again on the device; the solution comes back in canonical order. The
    # iteration is permutation-equivariant up to the order of the bus sums.
    sort_lines: bool = False

    # in an fp64 solve, run the branch TRON/ALM batch in fp32 (the kernel's
    # f32 instance, fp32 tolerances) and cast its result back up, so the
    # flows, the bus consensus, z, l, lz and the residual stay fp64. No
    # effect on an fp32 solve.
    mixed_precision: bool = False


@dataclasses.dataclass
class AdmmEnv:
    """What a solve was asked to do: the case, its parsed data, the rho
    seeds, the flags and the Parameters."""

    case: str
    data: object                  # OPFData
    initial_rho_pq: float
    initial_rho_va: float
    params: Parameters
    tight_factor: float = 1.0
    use_linelimit: bool = True
    use_projection: bool = False
    load_specified: bool = False  # per-period loads given (multi-period)
    horizon_length: int = 1
    storage_ratio: float = 0.0    # MPEC
    droop: float = 0.04           # MPEC


@dataclasses.dataclass
class Blocks(_TensorRecord):
    """One ADMM-space vector, split by component class."""

    LINE_LEAVES: ClassVar[tuple] = ("line",)

    gen: torch.Tensor   # (ngen, 2)  [pg, qg]
    line: torch.Tensor  # (nline_padded, 8)  [pij,qij,pji,qji,wi,wj,thi,thj]

    @staticmethod
    def zeros(ngen: int, nline: int, dtype=torch.float64,
              device="cpu") -> "Blocks":
        return Blocks(
            gen=torch.zeros((ngen, 2), dtype=dtype, device=device),
            line=torch.zeros((nline, 8), dtype=dtype, device=device),
        )


def blocks_map(fn, *blocks: Blocks) -> Blocks:
    """Elementwise op across corresponding gen/line arrays."""
    return Blocks(
        gen=fn(*(b.gen for b in blocks)),
        line=fn(*(b.line for b in blocks)),
    )


def blocks_norm(b: Blocks, line_mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """2-norm over both blocks; ``line_mask`` leaves the padded lines out."""
    lsq = b.line * b.line
    if line_mask is not None:
        lsq = lsq * line_mask[:, None]
    return torch.sqrt(torch.sum(b.gen * b.gen) + torch.sum(lsq))


@dataclasses.dataclass
class BranchALMState(_TensorRecord):
    """Per-line ALM state persisted across inner iterations.

    The reference keeps these in membuf rows 25 (lambda1), 26 (lambda2) and
    27 (mu) (acopf_auglag_linelimit_kernel_cpu.jl:79-147); mu is reset to 10
    at the first inner iteration of each outer loop, the lambdas warm-start
    across all iterations.
    """

    LINE_LEAVES: ClassVar[tuple] = ("lam1", "lam2", "mu")

    lam1: torch.Tensor  # (nline,)
    lam2: torch.Tensor  # (nline,)
    mu: torch.Tensor    # (nline,)

    @staticmethod
    def zeros(nline: int, dtype=torch.float64,
              device="cpu") -> "BranchALMState":
        z = torch.zeros((nline,), dtype=dtype, device=device)
        return BranchALMState(lam1=z, lam2=z.clone(),
                              mu=torch.full((nline,), 10.0, dtype=dtype,
                                            device=device))


@dataclasses.dataclass
class Solution(_TensorRecord):
    """ADMM state (reference Solution, environment.jl:177-226)."""

    u: Blocks        # x (component variables)
    v: Blocks        # xbar (bus consensus copy)
    l: Blocks        # lambda for u - v + z = 0
    rho: Blocks
    z: Blocks        # artificial variable (two-level)
    z_prev: Blocks
    lz: Blocks       # outer multiplier on z = 0
    rp: Blocks       # primal residual u - v + z
    rd: Blocks       # dual residual z - z_prev
    branch_alm: BranchALMState

    @staticmethod
    def zeros(ngen: int, nline: int, dtype=torch.float64,
              device="cpu") -> "Solution":
        def z():
            return Blocks.zeros(ngen, nline, dtype, device)
        return Solution(
            u=z(), v=z(), l=z(), rho=z(), z=z(), z_prev=z(), lz=z(),
            rp=z(), rd=z(),
            branch_alm=BranchALMState.zeros(nline, dtype, device),
        )


#: the Blocks fields of a Solution, in declaration order
SOLUTION_BLOCKS = ("u", "v", "l", "rho", "z", "z_prev", "lz", "rp", "rd")


def permute_solution_lines(sol: Solution, ids: torch.Tensor) -> Solution:
    """``sol`` with every line-indexed row reordered by ``ids``: row i of the
    result is row ``ids[i]`` of ``sol``, in the line block of each of
    ``SOLUTION_BLOCKS`` and in the branch ALM state."""
    def take(a):
        return a.index_select(0, ids)

    alm = sol.branch_alm
    return sol.replace(
        branch_alm=BranchALMState(lam1=take(alm.lam1), lam2=take(alm.lam2),
                                  mu=take(alm.mu)),
        **{k: getattr(sol, k).replace(line=take(getattr(sol, k).line))
           for k in SOLUTION_BLOCKS})


@dataclasses.dataclass
class RampState(_TensorRecord):
    """Per-period ramp coupling state; every tensor (T, ngen), row 0 inert.

    Mirrors the reference ``SolutionRamping`` (mpacopf_model.jl:1-38) plus
    the per-generator ALM state the reference keeps in gen_membuf rows 7
    (linear multiplier) and 8 (penalty).
    """

    u: torch.Tensor       # phat_{t-1}, the copy of period t-1's pg
    l: torch.Tensor
    rho: torch.Tensor
    z: torch.Tensor
    z_prev: torch.Tensor
    lz: torch.Tensor
    s: torch.Tensor       # ramp slack
    alm_mu: torch.Tensor  # ALM linear multiplier
    alm_xi: torch.Tensor  # ALM penalty

    @staticmethod
    def zeros(T: int, ngen: int, dtype=torch.float64,
              device="cpu") -> "RampState":
        def z():
            return torch.zeros((T, ngen), dtype=dtype, device=device)
        return RampState(u=z(), l=z(), rho=z(), z=z(), z_prev=z(), lz=z(),
                         s=z(), alm_mu=z(),
                         alm_xi=torch.full((T, ngen), 10.0, dtype=dtype,
                                           device=device))


def on_first_iteration(inner_iter, first, rest):
    """``first`` on the first iteration (``inner_iter <= 1``), else
    ``rest``. ``inner_iter`` is a Python int (the host loop) or a 0-d
    tensor (the fused loop, which reads nothing back): then the choice is a
    ``torch.where``."""
    if isinstance(inner_iter, torch.Tensor):
        return torch.where(inner_iter <= 1, first, rest)
    return first if inner_iter <= 1 else rest


#: the fields of a RampState, in declaration order
RAMP_FIELDS = tuple(f.name for f in dataclasses.fields(RampState))


@dataclasses.dataclass
class SolutionMpacopf(_TensorRecord):
    """Multi-period ADMM state: ``acopf`` holds (T, ...) tensors."""

    LINE_AXIS: ClassVar[int] = 1

    acopf: Solution
    ramp: RampState

    @property
    def u(self) -> Blocks:
        """The component variables; the driver reads their dtype."""
        return self.acopf.u


@dataclasses.dataclass
class SolutionQpsub(_TensorRecord):
    """QP-subproblem state (one-level ADMM); ``base.z`` stays zero."""

    LINE_LEAVES: ClassVar[tuple] = ("sqp_line", "alm_lam_j", "alm_lam_k",
                                    "alm_mu")

    base: Solution
    sqp_line: torch.Tensor   # (nline_padded, 6) line deltas, Hs ordering
    v_prev: Blocks           # v of the previous iteration (dual residual)
    alm_lam_j: torch.Tensor  # (nline_padded,) 1j multiplier
    alm_lam_k: torch.Tensor  # (nline_padded,) 1k multiplier
    alm_mu: torch.Tensor     # (nline_padded,) shared 1j/1k ALM penalty

    @property
    def u(self) -> Blocks:
        return self.base.u


#: the per-line ALM fields of a SolutionQpsub
QPSUB_ALM_FIELDS = ("alm_lam_j", "alm_lam_k", "alm_mu")


@dataclasses.dataclass
class IterationInformation:
    """Host-side iteration counters and scalars (environment.jl:328-405)."""

    outer: int = 0
    inner: int = 0
    cumul: int = 0
    status: str = "NotSpecified"
    objval: float = 0.0
    auglag: float = 0.0
    primres: float = float("inf")
    dualres: float = float("inf")
    mismatch: float = float("inf")
    eps_pri: float = 0.0
    norm_z_curr: float = float("inf")
    norm_z_prev: float = float("inf")
    # worst branch line-limit constraint violation of the last inner iteration
    max_cviol: float = 0.0
    time_overall: float = 0.0
    # the fused drivers on the card: the seconds this call spent building
    # the loop graph before ``time_overall`` began (warm-up, capture and
    # instantiation; 0 when it reused a built one) and the device memory
    # the loop's graphs hold
    time_build: float = 0.0
    graph_pool_bytes: int = 0
    # seconds spent in each hook of the two-level ADMM loop, summed over the
    # solve; filled only with ``Parameters.time_hooks``
    time_x_update: float = 0.0
    time_xbar_update: float = 0.0
    time_z_update: float = 0.0
    time_l_update: float = 0.0
    time_lz_update: float = 0.0
    # the power-flow projection (``use_projection``): its wall time and the
    # power-flow mismatch it reached (None when it did not run)
    time_projection: float = 0.0
    pf_residual: float | None = None
