"""Multi-period ACOPF: time periods coupled by generator ramping.

Counterpart of ``exaadmm_tpu/models/mpacopf/model.py`` (reference
``ModelMpacopf``, mpacopf_model.jl:57-107). T single-period ACOPF problems
plus, for each t >= 2, per-generator ramp coupling variables

    phat_{t-1,g}  the consensus copy of period t-1's bus-side pg,
    s_{t,g}       the ramp slack in [-r_g, r_g],

with the consensus phat_{t-1} - vbar_{t-1}[pg] + z_r = 0 and the
generator-local equality p_t - phat_{t-1} - s_t = 0 under a per-generator
ALM (mpacopf_auglag_generator_kernel_cpu.jl:18-131).

Within one inner iteration every period reads only its neighbours' values
from the previous iteration, so the period axis is a batch axis:

- all T * nline line subproblems are one branch batch over the tiled grid
  (one ``tron_alm_branch`` launch),
- all (T - 1) * ngen ramp subproblems are one ramp batch (one
  ``tron_alm_ramp`` launch),
- the bus update runs on (T, ...) blocks, the ramp terms of period t + 1
  blended into period t's pg rows; each of its two bus sums is one
  ``bus_scatter`` launch for all periods,
- z / l / lz / residual are elementwise with a leading (T,) axis; the
  scalars are the maximum over periods of per-period 2-norms
  (mpacopf_admm_update_residual_cpu.jl:42-48).

Every hook but the prestep goes through ``ops/mpacopf_cuda.py``: on the card
one hand-written kernel each (``csrc/mpacopf_hooks.cu``: the ramp batch's
pack, the generator and ramp unpack, the bus values, solve and writeback
around the two scatters, z, l, lz, the residual's two passes), on the CPU the
plain functions at the end of this module, which the kernels are held
bit-identical to.
"""

from __future__ import annotations

import torch

from ...ops import mpacopf_cuda, tron_cuda
from ...parallel.sharding import all_reduce_sum
from ...utils import tracing
from ...utils.environment import (SOLUTION_BLOCKS, Blocks, BranchALMState,
                                  Parameters, RampState, Solution,
                                  SolutionMpacopf)
from ...utils.grid_data import GridData, build_grid_data, tile_lines
from ...utils.opfdata import OPFData
from ..acopf import kernels
from ..acopf import model as acopf_model
from ..acopf.branch import branch_update
from .ramp import ramp_tolerances


class ModelMpacopf:
    """The grid, the parameters, the per-period loads (T, nbus) and the
    hooks the two-level driver calls."""

    def __init__(self, grid: GridData, par: Parameters, T: int, Pd, Qd,
                 use_linelimit: bool = True):
        self.grid = grid
        self.par = par
        self.T = T
        self.Pd = Pd
        self.Qd = Qd
        self.use_linelimit = use_linelimit
        self.grid_T = tile_lines(grid, T)
        # (T, 1): 0 on period 1, which has no ramp coupling
        self.ramp_mask = torch.ones((T, 1), dtype=grid.pgmin.dtype,
                                    device=grid.pgmin.device)
        self.ramp_mask[0, 0] = 0.0

    @property
    def nvar(self) -> int:
        # one ramp block of ngen, not T - 1 of them, as in the JAX model
        base = 2 * self.grid.ngen + 8 * self.grid.nline
        return base + (self.grid.ngen if self.T > 1 else 0)

    @property
    def c2_eff(self):
        return self.grid.c2 * self.par.obj_scale

    @property
    def c1_eff(self):
        return self.grid.c1 * self.par.obj_scale

    def _v_pg_prev(self, ac: Solution):
        """v[pg] of the previous period, aligned to ramp row t (zeros on
        row 0)."""
        v = ac.v.gen[..., 0]
        return torch.cat([torch.zeros_like(v[:1]), v[:-1]])

    def flat_lines(self, ac: Solution) -> Solution:
        """The line blocks of all periods as one (T * nline_padded) batch
        over ``grid_T``, the branch solve's input; the generator rows are
        period 1's (the branch solve reads none)."""
        nlp = ac.u.line.shape[1]
        n = self.T * nlp
        return Solution(
            **{k: Blocks(gen=getattr(ac, k).gen[0],
                         line=getattr(ac, k).line.reshape(n, 8))
               for k in SOLUTION_BLOCKS},
            branch_alm=BranchALMState(lam1=ac.branch_alm.lam1.reshape(n),
                                      lam2=ac.branch_alm.lam2.reshape(n),
                                      mu=ac.branch_alm.mu.reshape(n)))

    @staticmethod
    def next_ramp(rp: RampState) -> dict:
        """The ramp terms the bus update of period t blends in: period
        t + 1's ramp ``u/z/l/rho`` (mpacopf_admm_update_xbar_cpu.jl), zeros
        for period T."""
        return {k: torch.cat([getattr(rp, k)[1:],
                              torch.zeros_like(getattr(rp, k)[:1])])
                for k in ("u", "z", "l", "rho")}

    # ---- hooks called by the ADMM driver: the closed-form ones and the
    # ramp batch's pack and unpack go through ``ops/mpacopf_cuda.py`` (the
    # hand-written kernels on the card, the plain functions below on the
    # CPU) ----
    def inner_prestep(self, sol: SolutionMpacopf) -> SolutionMpacopf:
        return sol.replace(acopf=sol.acopf.replace(z_prev=sol.acopf.z),
                           ramp=sol.ramp.replace(z_prev=sol.ramp.z))

    def update_x(self, sol: SolutionMpacopf, inner_iter):
        """x update: closed-form qg (all periods) and pg (period 1), the
        ramp batch for pg of periods 2..T, and the T-period branch batch."""
        T = self.T
        ac = sol.acopf
        res = None
        if T > 1:
            # with one period there is nothing to couple: no ramp batch
            *batch, act = mpacopf_cuda.ramp_pack(sol, self, inner_iter)
            res = tron_cuda.tron_alm_packed(
                tron_cuda.RAMP, *batch, active0=act,
                **ramp_tolerances(self.par, ac.u.gen.dtype))
        u_gen, ramp_new = mpacopf_cuda.generator_unpack(sol, self, res)

        nlp = ac.u.line.shape[1]
        u_line, alm, stats = branch_update(
            self.flat_lines(ac), self.grid_T, self.par, inner_iter,
            use_linelimit=self.use_linelimit)
        ac_new = ac.replace(
            u=Blocks(gen=u_gen, line=u_line.reshape(T, nlp, 8)),
            branch_alm=BranchALMState(lam1=alm.lam1.reshape(T, nlp),
                                      lam2=alm.lam2.reshape(T, nlp),
                                      mu=alm.mu.reshape(T, nlp)))
        return sol.replace(acopf=ac_new, ramp=ramp_new), stats

    def update_xbar(self, sol: SolutionMpacopf, Pd=None,
                    Qd=None) -> SolutionMpacopf:
        v = mpacopf_cuda.bus_update(sol, self, self.Pd if Pd is None else Pd,
                                    self.Qd if Qd is None else Qd)
        return sol.replace(acopf=sol.acopf.replace(v=v))

    def update_z(self, sol: SolutionMpacopf, beta) -> SolutionMpacopf:
        z_ac, z_r = mpacopf_cuda.z_update(sol, self, beta)
        return sol.replace(acopf=sol.acopf.replace(z=z_ac),
                           ramp=sol.ramp.replace(z=z_r))

    def update_l(self, sol: SolutionMpacopf, beta) -> SolutionMpacopf:
        l_ac, l_r = mpacopf_cuda.l_update(sol, self, beta)
        return sol.replace(acopf=sol.acopf.replace(l=l_ac),
                           ramp=sol.ramp.replace(l=l_r))

    def update_lz(self, sol: SolutionMpacopf, beta) -> SolutionMpacopf:
        lz_ac, lz_r = mpacopf_cuda.lz_update(sol, self, beta)
        return sol.replace(acopf=sol.acopf.replace(lz=lz_ac),
                           ramp=sol.ramp.replace(lz=lz_r))

    def update_residual(self, sol: SolutionMpacopf, beta):
        rp_b, rd_b, scalars = mpacopf_cuda.residual_update(sol, self, beta)
        return sol.replace(acopf=sol.acopf.replace(rp=rp_b, rd=rd_b)), scalars


# ---- the hooks' plain versions (the CPU route of ``ops/mpacopf_cuda.py``,
# and what its kernels are held bit-identical to on the card)

def generator_unpack_plain(sol: SolutionMpacopf, model: ModelMpacopf, res):
    """The generator rows of the x update and the new ramp state: (u_gen
    (T, ngen, 2), RampState). qg of every period and pg of period 1 in
    closed form; pg of periods 2..T, the ramp copies ``u``, slacks ``s``
    and ALM state from the ramp batch's result ``res`` (row 0 stays inert:
    zeros, and period 1's ``alm_xi`` kept). With T == 1 there is no batch
    (``res`` None) and the ramp state comes back as it was."""
    gd = model.grid
    T, ngen = model.T, gd.ngen
    ac, rp = sol.acopf, sol.ramp

    lq, rq = ac.l.gen[..., 1], ac.rho.gen[..., 1]
    qg = torch.clamp(
        (-(lq + rq * (-ac.v.gen[..., 1] + ac.z.gen[..., 1]))) / rq,
        min=gd.qgmin, max=gd.qgmax)
    lp0, rp0 = ac.l.gen[0, :, 0], ac.rho.gen[0, :, 0]
    pg0 = torch.clamp(
        (-(model.c1_eff * gd.baseMVA + lp0
           + rp0 * (-ac.v.gen[0, :, 0] + ac.z.gen[0, :, 0])))
        / (2.0 * model.c2_eff * gd.baseMVA**2 + rp0),
        min=gd.pgmin, max=gd.pgmax)

    if T == 1:
        pg, ramp_new = pg0[None], rp
    else:
        pg = torch.cat([pg0[None], res.x[0].reshape(T - 1, ngen)])

        def pad0(a):
            return torch.cat([torch.zeros_like(a[:1]), a])

        ramp_new = rp.replace(
            u=pad0(res.x[1].reshape(T - 1, ngen)),
            s=pad0(res.x[2].reshape(T - 1, ngen)),
            alm_mu=pad0(res.lam[0].reshape(T - 1, ngen)),
            alm_xi=torch.cat([rp.alm_xi[:1],
                              res.mu.reshape(T - 1, ngen)]),
        )
    return torch.stack([pg, qg], dim=-1), ramp_new


def bus_update_plain(sol: SolutionMpacopf, model: ModelMpacopf, Pd,
                     Qd) -> Blocks:
    """The bus update of all periods, period t + 1's ramp terms blended
    into period t's pg rows; returns the new v."""
    ac = sol.acopf
    return kernels.bus_update(ac.u, ac.z, ac.l, ac.rho, model.grid, Pd=Pd,
                              Qd=Qd, ramp=model.next_ramp(sol.ramp))


def z_update_plain(sol: SolutionMpacopf, model: ModelMpacopf, beta):
    """(z of the ADMM blocks, z of the ramp coupling)."""
    ac, rp = sol.acopf, sol.ramp
    z_ac = kernels.z_update(ac.u, ac.v, ac.l, ac.rho, ac.lz, beta)
    safe_rho = torch.where(rp.rho > 0, rp.rho, torch.ones_like(rp.rho))
    z_r = (-(rp.lz + rp.l + safe_rho * (rp.u - model._v_pg_prev(ac)))) / (
        beta + safe_rho)
    return z_ac, z_r * model.ramp_mask


def l_update_plain(sol: SolutionMpacopf, model: ModelMpacopf, beta):
    """(l of the ADMM blocks, l of the ramp coupling)."""
    ac, rp = sol.acopf, sol.ramp
    l_ac = kernels.l_update(ac.z, ac.lz, beta)
    return l_ac, -(rp.lz + beta * rp.z) * model.ramp_mask


def lz_update_plain(sol: SolutionMpacopf, model: ModelMpacopf, beta):
    """(lz of the ADMM blocks, lz of the ramp coupling)."""
    ac, rp = sol.acopf, sol.ramp
    cap = model.par.MAX_MULTIPLIER
    lz_ac = kernels.lz_update(ac.z, ac.lz, beta, cap)
    return lz_ac, torch.clamp(rp.lz + beta * rp.z, -cap, cap)


def residual_update_plain(sol: SolutionMpacopf, model: ModelMpacopf):
    """(rp, rd, scalars): the residual blocks and the maximum over periods
    of the per-period 2-norms, the ramp coupling folded into the later
    period (mpacopf_admm_update_residual_cpu.jl:42-48); ``auglag`` is the
    objective."""
    gd = model.grid
    ac, rp = sol.acopf, sol.ramp
    m = gd.line_mask[:, None]

    rp_b = Blocks(gen=ac.u.gen - ac.v.gen + ac.z.gen,
                  line=ac.u.line - ac.v.line + ac.z.line)
    rd_b = Blocks(gen=ac.z.gen - ac.z_prev.gen,
                  line=ac.z.line - ac.z_prev.line)
    ax_by = Blocks(gen=rp_b.gen - ac.z.gen, line=rp_b.line - ac.z.line)

    line_sq = [torch.sum(b.line * b.line * m, dim=(1, 2))
               for b in (rp_b, rd_b, ac.z, ax_by)]
    if gd.mesh is not None:
        # lines split across ranks: the (4, T) line sums in one
        # all-reduce, the replicated generator sums added after it
        line_sq = all_reduce_sum(torch.stack(line_sq), gd.mesh).unbind()

    mask = model.ramp_mask
    rp_r = (rp.u - model._v_pg_prev(ac) + rp.z) * mask
    rd_r = (rp.z - rp.z_prev) * mask
    z_r = rp.z * mask

    # per-period 2-norms, the ramp coupling folded into the later
    # period, and the maximum over periods
    def norm(i: int, b: Blocks, r):
        per_period_sq = torch.sum(b.gen * b.gen, dim=(1, 2)) + line_sq[i]
        return torch.amax(torch.sqrt(per_period_sq
                                     + torch.sum(r * r, dim=1)))

    pg = gd.baseMVA * ac.u.gen[..., 0]
    objval = torch.sum(gd.c2 * (pg * pg) + gd.c1 * pg + gd.c0)
    scalars = {
        "primres": norm(0, rp_b, rp_r), "dualres": norm(1, rd_b, rd_r),
        "norm_z_curr": norm(2, ac.z, z_r),
        "mismatch": norm(3, ax_by, rp_r - z_r),
        "objval": objval, "auglag": objval,
    }
    return rp_b, rd_b, scalars


@tracing.spanned("entry.build_model")
def build_model(data: OPFData, par: Parameters, pd_mat, qd_mat, *,
                start_period: int = 1, end_period: int = 1,
                use_linelimit: bool = True, tight_factor: float = 1.0,
                ramp_ratio: float = 0.02, pad_lines_to: int = 1,
                dtype=torch.float64, device="cpu") -> ModelMpacopf:
    """``pd_mat``/``qd_mat``: (nbus, periods) loads in MW/MVAr; the model
    takes the columns start_period..end_period (1-based). ``pad_lines_to``
    pads every period's line batch to a multiple (the mesh size of a run
    split across ranks)."""
    gd = build_grid_data(data, tight_factor=tight_factor,
                         ramp_ratio=ramp_ratio, pad_lines_to=pad_lines_to,
                         dtype=dtype, device=device)
    T = end_period - start_period + 1

    def loads(mat):
        # (T, nbus) rows in memory order: the bus kernels take contiguous
        # loads, each period's row too (the warm start's single-period
        # solves)
        cols = mat[:, start_period - 1:end_period].T
        return torch.as_tensor(cols, dtype=torch.float64).to(
            device=device, dtype=dtype).contiguous()

    return ModelMpacopf(grid=gd, par=par, T=T, Pd=loads(pd_mat),
                        Qd=loads(qd_mat), use_linelimit=use_linelimit)


def _stack(sols) -> Solution:
    """One Solution of (T, ...) tensors from T single-period Solutions."""
    return Solution(
        **{k: Blocks(gen=torch.stack([getattr(s, k).gen for s in sols]),
                     line=torch.stack([getattr(s, k).line for s in sols]))
           for k in SOLUTION_BLOCKS},
        branch_alm=BranchALMState(
            **{k: torch.stack([getattr(s.branch_alm, k) for s in sols])
               for k in ("lam1", "lam2", "mu")}))


@tracing.spanned("entry.init_solution")
def init_solution(model: ModelMpacopf, rho_pq: float, rho_va: float,
                  warm=None) -> SolutionMpacopf:
    """Flat start in every period plus the ramp state
    (mpacopf_init_solution_cpu.jl:1-19).

    ``warm``: optional list of T single-period Solutions from a warm-start
    pass; their states are kept (the reference resets them, see
    ``interface/solve_mpacopf.py``), and the ramp state derives from them.
    """
    gd = model.grid
    T = model.T
    if warm is None:
        single = acopf_model.ModelAcopf(grid=gd, par=model.par,
                                        use_linelimit=model.use_linelimit)
        warm = [acopf_model.init_solution(single, rho_pq, rho_va)] * T
    ac = _stack(warm)

    dtype, dev = gd.pgmin.dtype, gd.pgmin.device
    # u_r[t] = v_{t-1}[pg]; s[t] = u_t[pg] - u_r[t]; row 0 inert
    u_r = torch.cat([torch.zeros((1, gd.ngen), dtype=dtype, device=dev),
                     ac.v.gen[:-1, :, 0]])
    s = torch.cat([torch.zeros((1, gd.ngen), dtype=dtype, device=dev),
                   ac.u.gen[1:, :, 0] - u_r[1:]])
    ramp = RampState.zeros(T, gd.ngen, dtype, dev).replace(
        rho=torch.full((T, gd.ngen), rho_pq, dtype=dtype, device=dev),
        u=u_r, s=s)
    return SolutionMpacopf(acopf=ac, ramp=ramp)


def check_ramp_violations(model: ModelMpacopf, sol: SolutionMpacopf) -> float:
    """max over t >= 2 and g of (|pg_t - pg_{t-1}| - r_g)_+
    (mpacopf_admm_prepoststep_cpu.jl:40-47)."""
    if model.T == 1:
        return 0.0
    pg = sol.acopf.u.gen[:, :, 0]
    viol = torch.abs(pg[1:] - pg[:-1]) - model.grid.ramp_rate
    return float(torch.amax(torch.clamp_min(viol, 0.0)))
