"""ACOPF model: variable layout, initial solution, and the iteration hooks.

Counterpart of ``exaadmm_tpu/models/acopf/model.py`` (reference
``ModelAcopf`` + ``init_solution!``, acopf_model.jl and
acopf_init_solution_cpu.jl). ``nvar`` (2 ngen + 8 nline, unpadded) is kept
for the tolerance scalings sqrt(nvar)*eps used by the driver.
"""

from __future__ import annotations

import copy

import torch

from ...ops import acopf_cuda
from ...utils import tracing
from ...utils.environment import Blocks, BranchALMState, Parameters, Solution
from ...utils.grid_data import GridData, build_grid_data, permute_lines
from ...utils.opfdata import OPFData
from .branch import branch_update


class ModelAcopf:
    """The grid, the parameters and the hooks the two-level driver calls."""

    # the driver may difficulty-sort the line batch between outer rounds
    # (``Parameters.sort_lines``) through ``with_line_order``
    supports_line_sort = True
    # the inner iteration's hooks take destinations (``out``, a solution
    # whose tensors receive the results; ``stats_out``, ``scalars_out``),
    # into which their kernels write: the fused driver passes its carry
    writes_into_carry = True

    def __init__(self, grid: GridData, par: Parameters,
                 use_linelimit: bool = True):
        self.grid = grid
        self.par = par
        self.use_linelimit = use_linelimit
        # pg bounds of the current period (rolling horizon tightens them)
        self.pgmin_curr = grid.pgmin
        self.pgmax_curr = grid.pgmax

    def with_line_order(self, ids: torch.Tensor) -> "ModelAcopf":
        """This model with its lines in the order ``ids`` (line i of the
        result is line ``ids[i]`` of this one): the grid's line arrays and
        its arc CSR move (``permute_lines``). Nothing else of the model is
        indexed by line, and no hook depends on the line order."""
        m = copy.copy(self)
        m.grid = permute_lines(self.grid, ids)
        return m

    @property
    def nvar(self) -> int:
        return 2 * self.grid.ngen + 8 * self.grid.nline

    # effective (obj_scale-multiplied) cost coefficients used by the kernels
    @property
    def c2_eff(self):
        return self.grid.c2 * self.par.obj_scale

    @property
    def c1_eff(self):
        return self.grid.c1 * self.par.obj_scale

    # ---- hooks called by the ADMM driver: the closed-form ones go through
    # ``ops/acopf_cuda.py`` (the hand-written kernels on the card, the
    # plain functions of ``kernels.py`` on the CPU). Given ``out``, a hook
    # writes its results into ``out``'s tensors and returns them; it reads
    # ``sol``'s, which may be those same tensors (the fused loop's carry:
    # every kernel reads only the elements it writes, or buffers it does
    # not write) ----
    def inner_prestep(self, sol: Solution) -> Solution:
        return sol.replace(z_prev=sol.z)

    def update_x(self, sol: Solution, inner_iter, out: Solution | None = None,
                 stats_out=None):
        """x update: closed-form generators + the branch TRON/ALM batch;
        ``stats_out`` receives the branch stats (``branch_cuda.STATS``)."""
        gd = self.grid
        u_gen = acopf_cuda.generator_update(
            sol.u.gen, sol.v.gen, sol.z.gen, sol.l.gen, sol.rho.gen,
            self.pgmin_curr, self.pgmax_curr, gd.qgmin, gd.qgmax,
            gd.c2, gd.c1, gd.baseMVA, obj_scale=self.par.obj_scale,
            out=None if out is None else out.u.gen,
        )
        # the new line rows come back in a tensor of their own, which the
        # driver copies in: ``sol.u.line`` holds the old rows until the
        # call returns, for a caller that wraps ``branch_update`` and reads
        # them after it (the benchmark's planted faults)
        u_line, alm, stats = branch_update(
            sol, gd, self.par, inner_iter, use_linelimit=self.use_linelimit,
            out=None if out is None else (None, out.branch_alm, stats_out))
        return sol.replace(u=Blocks(gen=u_gen, line=u_line),
                           branch_alm=alm), stats

    def update_xbar(self, sol: Solution, Pd=None, Qd=None,
                    out: Solution | None = None) -> Solution:
        v = acopf_cuda.bus_update(sol.u, sol.z, sol.l, sol.rho, self.grid,
                                  Pd=Pd, Qd=Qd,
                                  out=None if out is None else out.v)
        return sol.replace(v=v)

    def update_z(self, sol: Solution, beta,
                 out: Solution | None = None) -> Solution:
        return sol.replace(z=acopf_cuda.z_update(
            sol.u, sol.v, sol.l, sol.rho, sol.lz, beta,
            out=None if out is None else out.z))

    def update_l(self, sol: Solution, beta,
                 out: Solution | None = None) -> Solution:
        return sol.replace(l=acopf_cuda.l_update(
            sol.z, sol.lz, beta, out=None if out is None else out.l))

    def update_lz(self, sol: Solution, beta) -> Solution:
        return sol.replace(lz=acopf_cuda.lz_update(sol.z, sol.lz, beta,
                                                   self.par.MAX_MULTIPLIER))

    def update_residual(self, sol: Solution, beta,
                        out: Solution | None = None, scalars_out=None):
        """(sol with rp and rd, the six scalars of ``acopf_cuda.SCALARS``
        by name); ``scalars_out`` receives them in that order."""
        rp, rd, scalars = acopf_cuda.residual_update(
            sol, self.grid, beta,
            out=None if out is None else (out.rp, out.rd, scalars_out))
        return sol.replace(rp=rp, rd=rd), scalars


@tracing.spanned("entry.build_model")
def build_model(
    data: OPFData,
    par: Parameters,
    *,
    use_linelimit: bool = True,
    tight_factor: float = 1.0,
    pad_lines_to: int = 1,
    dtype=torch.float64,
    device="cpu",
) -> ModelAcopf:
    gd = build_grid_data(data, tight_factor=tight_factor,
                         pad_lines_to=pad_lines_to, dtype=dtype, device=device)
    return ModelAcopf(grid=gd, par=par, use_linelimit=use_linelimit)


@tracing.spanned("entry.init_solution")
def init_solution(model: ModelAcopf, rho_pq: float, rho_va: float) -> Solution:
    """Flat start (acopf_init_solution_cpu.jl:8-58).

    rho = rho_pq everywhere except the line (wi, wj, thi, thj) rows = rho_va;
    v gens at bound midpoints; v lines from w0 = (Vmax^2+Vmin^2)/2 pushed
    through the branch admittances.
    """
    gd = model.grid
    dtype, dev = gd.pgmin.dtype, gd.pgmin.device
    n = gd.nline_padded
    sol = Solution.zeros(gd.ngen, n, dtype, dev)

    rho_line = torch.cat([torch.full((n, 4), rho_pq, dtype=dtype, device=dev),
                          torch.full((n, 4), rho_va, dtype=dtype, device=dev)],
                         dim=-1)
    rho = Blocks(gen=torch.full((gd.ngen, 2), rho_pq, dtype=dtype, device=dev),
                 line=rho_line)

    v_gen = torch.stack(
        [0.5 * (gd.pgmin + gd.pgmax), 0.5 * (gd.qgmin + gd.qgmax)], dim=-1)

    vmax_f, vmin_f = gd.Vmax[gd.line_from], gd.Vmin[gd.line_from]
    vmax_t, vmin_t = gd.Vmax[gd.line_to], gd.Vmin[gd.line_to]
    wij0 = 0.5 * (vmax_f * vmax_f + vmin_f * vmin_f)
    wji0 = 0.5 * (vmax_t * vmax_t + vmin_t * vmin_t)
    wR0 = torch.sqrt(wij0 * wji0)
    zero = torch.zeros_like(wij0)
    v_line = torch.stack(
        [
            gd.YffR * wij0 + gd.YftR * wR0,
            -gd.YffI * wij0 - gd.YftI * wR0,
            gd.YttR * wji0 + gd.YtfR * wR0,
            -gd.YttI * wji0 - gd.YtfI * wR0,
            wij0,
            wji0,
            zero,
            zero,
        ],
        dim=-1,
    ) * gd.line_mask[:, None]

    return sol.replace(
        rho=rho,
        v=Blocks(gen=v_gen, line=v_line),
        branch_alm=BranchALMState.zeros(n, dtype, dev),
    )
