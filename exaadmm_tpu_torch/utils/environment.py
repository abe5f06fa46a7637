"""Algorithm parameters and the ADMM state, as dataclasses of tensors.

Counterpart of ``exaadmm_tpu/utils/environment.py``. The pytrees there become
plain dataclasses here: ``replace`` returns a copy with some fields changed,
and ``to`` moves every tensor to another device or dtype.

- ``Parameters`` holds only the constants the two-level ACOPF solve reads,
- ``Blocks`` is one ADMM-space vector split by component class: (ngen, 2)
  generator rows ``[pg, qg]`` and (nline_padded, 8) line rows
  ``[pij, qij, pji, qji, wi, wj, thi, thj]``,
- ``Solution`` is the ADMM state, with the per-line ALM multipliers of the
  branch subproblems in ``BranchALMState``,
- ``IterationInformation`` holds the host-side counters and scalars.
"""

from __future__ import annotations

import dataclasses

import torch

# line-block column indices (order matches the reference layout)
PIJ, QIJ, PJI, QJI, WI, WJ, THI, THJ = range(8)


class _TensorRecord:
    """``replace`` and ``to`` for a dataclass whose fields are tensors or
    records of tensors."""

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

    # branch ALM termination (auglag kernel :128-137)
    alm_ctol: float = 1e-6


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


@dataclasses.dataclass
class Blocks(_TensorRecord):
    """One ADMM-space vector, split by component class."""

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


@dataclasses.dataclass
class BranchALMState(_TensorRecord):
    """Per-line ALM state persisted across inner iterations.

    The reference keeps these in membuf rows 25 (lambda1), 26 (lambda2) and
    27 (mu) (acopf_auglag_linelimit_kernel_cpu.jl:79-147); mu is reset to 10
    at the first inner iteration of each outer loop, the lambdas warm-start
    across all iterations.
    """

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
