"""MPEC / complementarity model: ACOPF + storage + primary control.

Counterpart of ``exaadmm_tpu/models/mpec/model.py`` (reference
``src/models/mpec/``, disabled upstream; the JAX package keeps it working,
and so does the port). It extends ACOPF with, per generator, a squared
voltage-magnitude copy ``vg`` (voltage setpoint control) and a
frequency-deviation copy ``fg`` (droop control), plus one net charge
variable per storage unit:

- (qg, vg) complementarity: the three KKT cases {q interior and v = v_sp,
  q = qmin and v >= v_sp, q = qmax and v <= v_sp}, each in closed form, the
  prox-objective minimizer kept (mpec_admm_update_x_cpu.jl:30-68);
- (pg, fg) droop complementarity: {p = p_sp + alpha f interior, p = pmin,
  p = pmax} (:75-119);
- storage: charge-only against discharge-only, within the energy window
  (:135-205);
- the lines: the unchanged ACOPF branch batch (``branch_update``);
- the bus update: ``vg`` joins the shared-w consensus at its generator's
  bus and the storage power enters the real-power balance
  (mpec_bus_kernel_cpu.jl); the frequency copies average into one system
  frequency (mpec_admm_update_xbar_cpu.jl:14-27).

Every bus sum goes through the bus-scatter kernel (``ops/bus_cuda.py``):
the eight line aggregates over the arc CSR, the generator sums with the two
``vg`` channels over the generator CSR, the storage sums over a bus ->
storage CSR built on the host with the model. The operation order is the
JAX model's.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ...ops import bus_cuda
from ...parallel.sharding import all_reduce_sum
from ...utils import tracing
from ...utils.environment import (BranchALMState, Blocks, Parameters,
                                  Solution, _TensorRecord)
from ...utils.grid_data import GridData
from ..acopf.branch import branch_update
from ..acopf.kernels import bus_arc_values

#: the fields of an MpecBlocks, in declaration order
MPEC_FIELDS = ("gen", "vg", "fg", "sto", "line")


@dataclasses.dataclass
class MpecBlocks(_TensorRecord):
    """One ADMM vector for the MPEC layout:
    [(pg, qg)_g | vg_g | fg_g | ps_s | (8 flow/voltage)_l]."""

    LINE_LEAVES: ClassVar[tuple] = ("line",)

    gen: torch.Tensor   # (ngen, 2)
    vg: torch.Tensor    # (ngen,) squared voltage magnitude copy
    fg: torch.Tensor    # (ngen,) frequency deviation copy
    sto: torch.Tensor   # (nstorage,) net storage power (charge - discharge)
    line: torch.Tensor  # (nline_padded, 8)

    @staticmethod
    def zeros(ngen: int, nsto: int, nline: int, dtype=torch.float64,
              device="cpu") -> "MpecBlocks":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return MpecBlocks(gen=z(ngen, 2), vg=z(ngen), fg=z(ngen), sto=z(nsto),
                          line=z(nline, 8))


def mpec_map(fn, *blocks: MpecBlocks) -> MpecBlocks:
    """Elementwise op across corresponding fields."""
    return MpecBlocks(**{k: fn(*(getattr(b, k) for b in blocks))
                         for k in MPEC_FIELDS})


@dataclasses.dataclass
class SolutionMpec(_TensorRecord):
    u: MpecBlocks
    v: MpecBlocks
    l: MpecBlocks
    rho: MpecBlocks
    z: MpecBlocks
    z_prev: MpecBlocks
    lz: MpecBlocks
    rp: MpecBlocks
    rd: MpecBlocks
    branch_alm: BranchALMState


@dataclasses.dataclass
class StorageData(_TensorRecord):
    """Per-storage tensors (reference Storage records) and the bus ->
    storage CSR the bus update's scatter walks."""

    bus: torch.Tensor          # int64 bus index
    chg_min: torch.Tensor
    chg_max: torch.Tensor
    energy_min: torch.Tensor
    energy_max: torch.Tensor
    energy_setpoint: torch.Tensor
    eta_chg: torch.Tensor
    eta_dis: torch.Tensor
    ptr: torch.Tensor          # int32 (nbus + 1,)
    idx: torch.Tensor          # int32 (nstorage,)

    @property
    def nstorage(self) -> int:
        return self.bus.shape[0]


def _sq(a):
    return a * a


def gen_values(u: MpecBlocks, z: MpecBlocks, l: MpecBlocks,
               rho: MpecBlocks) -> torch.Tensor:
    """The bus update's per-generator values, (ngen, 6): the real and
    reactive rhs terms, their inverse rhos, and vg's w term and rho."""
    uzG = u.gen + z.gen
    lG, rG = l.gen, rho.gen
    return torch.stack([
        uzG[:, 0] + lG[:, 0] / rG[:, 0],
        uzG[:, 1] + lG[:, 1] / rG[:, 1],
        1.0 / rG[:, 0],
        1.0 / rG[:, 1],
        l.vg + rho.vg * (u.vg + z.vg),
        rho.vg,
    ], dim=-1)


def storage_values(u: MpecBlocks, z: MpecBlocks, l: MpecBlocks,
                   rho: MpecBlocks) -> torch.Tensor:
    """The bus update's per-storage values, (nstorage, 2): the real-power
    rhs term and the inverse rho."""
    return torch.stack([u.sto + z.sto + l.sto / rho.sto, 1.0 / rho.sto],
                       dim=-1)


class ModelMpec:
    """The grid, the storage, the primary-control data and the hooks the
    two-level driver calls."""

    def __init__(self, grid: GridData, par: Parameters, storage: StorageData,
                 alpha, pg_setpoint, vgmin, vgmax, vm_setpoint,
                 use_linelimit: bool = True):
        self.grid = grid
        self.par = par
        self.storage = storage
        self.alpha = alpha              # -(1/droop) * pgmax (opfdata.jl:901)
        self.pg_setpoint = pg_setpoint  # (pgmin + pgmax) / 2
        self.vgmin = vgmin              # bus Vmin at the gen's bus
        self.vgmax = vgmax
        self.vm_setpoint = vm_setpoint  # (vgmin + vgmax) / 2
        self.use_linelimit = use_linelimit
        self.pgmin_curr = grid.pgmin
        self.pgmax_curr = grid.pgmax

    @property
    def nvar(self) -> int:
        return (4 * self.grid.ngen + self.storage.nstorage
                + 8 * self.grid.nline)

    @property
    def c2_eff(self):
        return self.grid.c2 * self.par.obj_scale

    @property
    def c1_eff(self):
        return self.grid.c1 * self.par.obj_scale

    # ---- hooks ----------------------------------------------------------
    def inner_prestep(self, sol: SolutionMpec) -> SolutionMpec:
        return sol.replace(z_prev=sol.z)

    def update_x(self, sol: SolutionMpec, inner_iter):
        gd = self.grid
        u, v, z, l, rho = sol.u, sol.v, sol.z, sol.l, sol.rho
        pgmin, pgmax = self.pgmin_curr, self.pgmax_curr

        def prox(val, lv, rv, vv, zv):
            d = val - vv + zv
            return lv * d + 0.5 * rv * d * d

        def pick(cands, obj):
            """The candidate of least objective (the first on a tie)."""
            best = torch.argmin(obj, dim=0)[None]
            return [torch.gather(c, 0, best)[0] for c in cands]

        # --- (qg, vg) voltage-setpoint complementarity (three cases) ---
        lq, rq = l.gen[:, 1], rho.gen[:, 1]
        lv_, rv_ = l.vg, rho.vg
        vq, zq = v.gen[:, 1], z.gen[:, 1]
        vv, zv = v.vg, z.vg
        vsp2 = _sq(self.vm_setpoint)
        vg_free = (-(lv_ + rv_ * (-vv + zv))) / rv_
        qg_free = torch.clamp((-(lq + rq * (-vq + zq))) / rq, min=gd.qgmin,
                              max=gd.qgmax)
        qg_c = torch.stack([qg_free, gd.qgmin, gd.qgmax])
        vg_c = torch.stack([
            vsp2,
            torch.maximum(torch.maximum(_sq(self.vgmin), vsp2),
                          torch.minimum(_sq(self.vgmax), vg_free)),
            torch.maximum(_sq(self.vgmin),
                          torch.minimum(torch.minimum(_sq(self.vgmax), vsp2),
                                        vg_free)),
        ])
        obj_c = prox(qg_c, lq, rq, vq, zq) + prox(vg_c, lv_, rv_, vv, zv)
        qg, vg = pick((qg_c, vg_c), obj_c)

        # --- (pg, fg) droop complementarity (three cases) ---
        lp, rp_ = l.gen[:, 0], rho.gen[:, 0]
        lf, rf = l.fg, rho.fg
        vp, zp = v.gen[:, 0], z.gen[:, 0]
        vf, zf = v.fg, z.fg
        B = gd.baseMVA
        alpha, psp = self.alpha, self.pg_setpoint
        c2, c1 = self.c2_eff, self.c1_eff
        a = 2 * c2 * _sq(B * alpha) + rp_ * _sq(alpha) + rf
        bq = (2 * c2 * psp * B**2 * alpha + c1 * B * alpha + lp * alpha
              + rp_ * (psp - vp + zp) * alpha + lf + rf * (-vf + zf))
        # alpha < 0: (pgmax - psp) / alpha <= (pgmin - psp) / alpha
        f1 = torch.clamp(-bq / a, min=(pgmax - psp) / alpha,
                         max=(pgmin - psp) / alpha)
        fg_free = -(lf + rf * (-vf + zf)) / rf
        pg_c = torch.stack([psp + alpha * f1, pgmin, pgmax])
        fg_c = torch.stack([
            f1,
            torch.maximum((pgmin - psp) / alpha, fg_free),
            torch.minimum((pgmax - psp) / alpha, fg_free),
        ])
        cost = c2 * _sq(pg_c * B) + c1 * (pg_c * B)
        obj_p = (cost + prox(pg_c, lp, rp_, vp, zp)
                 + prox(fg_c, lf, rf, vf, zf))
        pg, fg = pick((pg_c, fg_c), obj_p)

        # --- storage: charge-only vs discharge-only (two cases) ---
        st = self.storage
        if st.nstorage > 0:
            ls_, rs = l.sto, rho.sto
            vs, zs = v.sto, z.sto
            lb1 = torch.maximum(
                st.chg_min, (st.energy_min - st.energy_setpoint) / st.eta_chg)
            ub1 = torch.minimum(
                st.chg_max, (st.energy_max - st.energy_setpoint) / st.eta_chg)
            ps1 = torch.clamp((-(ls_ + rs * (-vs + zs))) / rs, min=lb1,
                              max=ub1)
            o1 = prox(ps1, ls_, rs, vs, zs)
            lb2 = torch.maximum(
                st.chg_min,
                (st.energy_max - st.energy_setpoint) / (-st.eta_dis))
            ub2 = torch.minimum(
                st.chg_max,
                (st.energy_min - st.energy_setpoint) / (-st.eta_dis))
            ps2 = torch.clamp((ls_ + rs * (-vs + zs)) / rs, min=lb2, max=ub2)
            o2 = prox(-ps2, ls_, rs, vs, zs)
            ps = torch.where(o1 <= o2, ps1, -ps2)
        else:
            ps = u.sto

        # --- lines: the unchanged ACOPF branch batch ---
        zero2 = u.line.new_zeros((1, 2))

        def flat(b):
            return Blocks(gen=zero2, line=b.line)

        line_sol = Solution(
            u=flat(u), v=flat(v), l=flat(l), rho=flat(rho), z=flat(z),
            z_prev=flat(sol.z_prev), lz=flat(sol.lz), rp=flat(sol.rp),
            rd=flat(sol.rd), branch_alm=sol.branch_alm)
        u_line, alm, stats = branch_update(
            line_sol, gd, self.par, inner_iter,
            use_linelimit=self.use_linelimit)

        u_new = MpecBlocks(gen=torch.stack([pg, qg], dim=-1), vg=vg, fg=fg,
                           sto=ps, line=u_line)
        return sol.replace(u=u_new, branch_alm=alm), stats

    def update_xbar(self, sol: SolutionMpec, Pd=None, Qd=None) -> SolutionMpec:
        gd = self.grid
        st = self.storage
        u, z, l, rho = sol.u, sol.z, sol.l, sol.rho
        fr, to, gb = gd.line_from, gd.line_to, gd.gen_bus
        if Pd is None:
            Pd = gd.Pd
        if Qd is None:
            Qd = gd.Qd

        # the eight line aggregates, one scatter over the arcs
        # (lines split across ranks, ``gd.mesh``: completed by one
        # all-reduce; generator, vg, fg and storage data are replicated)
        agg = all_reduce_sum(
            bus_cuda.bus_scatter(bus_arc_values(u, z, l, rho, gd),
                                 gd.arc_bus, gd.arc_ptr, gd.arc_idx), gd.mesh)
        (common_wi, common_ti, rhosum_wi, rhosum_ti, inv_rho_p, inv_rho_q,
         rhs1_lines, rhs2_lines) = agg.unbind(-1)

        # the generator sums, vg's two channels included, one scatter
        gsum = bus_cuda.bus_scatter(gen_values(u, z, l, rho), gb, gd.gen_ptr,
                                    gd.gen_idx)
        rhs1, rhs2, inv_rho_pg, inv_rho_qg, vg_w, vg_rho = gsum.unbind(-1)

        # vg joins the shared-w consensus on the generator's bus
        common_wi = common_wi + vg_w
        rhosum_wi = rhosum_wi + vg_rho

        one = torch.ones_like(rhosum_wi)
        safe_wi = torch.where(rhosum_wi > 0, rhosum_wi, one)
        safe_ti = torch.where(rhosum_ti > 0, rhosum_ti, one)
        common_wi = common_wi / safe_wi

        inv_rho_sg = torch.zeros_like(rhs1)
        if st.nstorage > 0:
            ssum = bus_cuda.bus_scatter(storage_values(u, z, l, rho), st.bus,
                                        st.ptr, st.idx)
            rhs1 = rhs1 - ssum[:, 0]
            inv_rho_sg = ssum[:, 1]

        rhs1 = rhs1 - Pd / gd.baseMVA - rhs1_lines
        rhs2 = rhs2 - Qd / gd.baseMVA - rhs2_lines
        rhs1 = rhs1 - gd.YshR * common_wi
        rhs2 = rhs2 + gd.YshI * common_wi

        A11 = inv_rho_pg + inv_rho_sg + inv_rho_p + _sq(gd.YshR) / safe_wi
        A12 = -gd.YshR * (gd.YshI / safe_wi)
        A22 = inv_rho_qg + inv_rho_q + _sq(gd.YshI) / safe_wi
        sA11 = torch.where(A11 != 0, A11, one)
        mu2 = (rhs2 - (A12 / sA11) * rhs1) / (A22 - (A12 / sA11) * A12)
        mu1 = (rhs1 - A12 * mu2) / sA11
        wi = common_wi + (gd.YshR * mu1 - gd.YshI * mu2) / safe_wi
        ti = common_ti / safe_ti

        uzG, uzL = u.gen + z.gen, u.line + z.line
        lG, rG = l.gen, rho.gen
        lL, rL = l.line, rho.line
        v_gen = torch.stack([
            uzG[:, 0] + (lG[:, 0] - mu1[gb]) / rG[:, 0],
            uzG[:, 1] + (lG[:, 1] - mu2[gb]) / rG[:, 1],
        ], dim=-1)
        v_sto = (u.sto + z.sto + (l.sto + mu1[st.bus]) / rho.sto
                 if st.nstorage > 0 else u.sto)
        v_line = torch.stack([
            uzL[:, 0] + (lL[:, 0] + mu1[fr]) / rL[:, 0],
            uzL[:, 1] + (lL[:, 1] + mu2[fr]) / rL[:, 1],
            uzL[:, 2] + (lL[:, 2] + mu1[to]) / rL[:, 2],
            uzL[:, 3] + (lL[:, 3] + mu2[to]) / rL[:, 3],
            wi[fr], wi[to], ti[fr], ti[to],
        ], dim=-1)

        # one system frequency: the rho-weighted mean of all the copies
        # (mpec_admm_update_xbar_cpu.jl:14-27)
        freq = (torch.sum(l.fg + rho.fg * (u.fg + z.fg))
                / torch.sum(rho.fg))
        return sol.replace(v=MpecBlocks(
            gen=v_gen, vg=wi[gb], fg=freq.expand(u.fg.shape).clone(),
            sto=v_sto, line=v_line))

    def update_z(self, sol: SolutionMpec, beta) -> SolutionMpec:
        return sol.replace(z=mpec_map(
            lambda uu, vv, ll, rr, zz: (-(zz + ll + rr * (uu - vv)))
            / (beta + rr), sol.u, sol.v, sol.l, sol.rho, sol.lz))

    def update_l(self, sol: SolutionMpec, beta) -> SolutionMpec:
        return sol.replace(l=mpec_map(lambda zz, ll: -(ll + beta * zz),
                                      sol.z, sol.lz))

    def update_lz(self, sol: SolutionMpec, beta) -> SolutionMpec:
        cap = self.par.MAX_MULTIPLIER
        return sol.replace(lz=mpec_map(
            lambda zz, ll: torch.clamp(ll + beta * zz, -cap, cap),
            sol.z, sol.lz))

    def update_residual(self, sol: SolutionMpec, beta):
        gd = self.grid
        m = gd.line_mask[:, None]
        rp = mpec_map(lambda uu, vv, zz: uu - vv + zz, sol.u, sol.v, sol.z)
        rd = mpec_map(lambda zc, zpp: zc - zpp, sol.z, sol.z_prev)
        ax_by = mpec_map(lambda a, b: a - b, rp, sol.z)

        line_sq = [torch.sum(_sq(blk.line) * m)
                   for blk in (rp, rd, sol.z, ax_by)]
        if gd.mesh is not None:
            # lines split across ranks: the four line sums in one all-reduce
            line_sq = all_reduce_sum(torch.stack(line_sq), gd.mesh).unbind()

        def sumsq(i: int, blk: MpecBlocks):
            """The replicated blocks' squares plus the masked line sum
            (the JAX model's order)."""
            rep = (torch.sum(_sq(blk.gen)) + torch.sum(_sq(blk.vg))
                   + torch.sum(_sq(blk.fg)) + torch.sum(_sq(blk.sto)))
            return rep + line_sq[i]

        pg = gd.baseMVA * sol.u.gen[:, 0]
        objval = torch.sum(gd.c2 * _sq(pg) + gd.c1 * pg + gd.c0)
        scalars = {
            "primres": torch.sqrt(sumsq(0, rp)),
            "dualres": torch.sqrt(sumsq(1, rd)),
            "norm_z_curr": torch.sqrt(sumsq(2, sol.z)),
            "mismatch": torch.sqrt(sumsq(3, ax_by)),
            "objval": objval,
            "auglag": objval,
        }
        return sol.replace(rp=rp, rd=rd), scalars


@tracing.spanned("entry.init_solution")
def init_solution(model: ModelMpec, rho_pq: float, rho_va: float
                  ) -> SolutionMpec:
    """Flat start (mpec_init_solution_cpu.jl): the ACOPF start, vg at its
    squared bound midpoint with rho_va * 10, fg at 0 with rho_pq alpha^2."""
    gd = model.grid
    st = model.storage
    dt, dev = gd.pgmin.dtype, gd.pgmin.device
    nl = gd.nline_padded

    def zb():
        return MpecBlocks.zeros(gd.ngen, st.nstorage, nl, dt, dev)

    def full(shape, val):
        return torch.full(shape, val, dtype=dt, device=dev)

    rho = MpecBlocks(
        gen=full((gd.ngen, 2), rho_pq),
        vg=full((gd.ngen,), rho_va * 10.0),
        # rho_fg matches the fg-consensus dual scale: the droop coupling
        # transmits power-scale forces d/dfg ~ c2 (B alpha)^2, so the fg
        # multiplier grows ~alpha^2 x the pg one; with the reference's flat
        # rho_pq * 10 the case9 solve does not converge (the JAX model's
        # note)
        fg=rho_pq * _sq(model.alpha),
        sto=full((st.nstorage,), rho_pq),
        line=torch.cat([full((nl, 4), rho_pq), full((nl, 4), rho_va)], dim=1),
    )
    vmax_f, vmin_f = gd.Vmax[gd.line_from], gd.Vmin[gd.line_from]
    vmax_t, vmin_t = gd.Vmax[gd.line_to], gd.Vmin[gd.line_to]
    wij0 = 0.5 * (_sq(vmax_f) + _sq(vmin_f))
    wji0 = 0.5 * (_sq(vmax_t) + _sq(vmin_t))
    wR0 = torch.sqrt(wij0 * wji0)
    zero = torch.zeros_like(wij0)
    v = MpecBlocks(
        gen=torch.stack([0.5 * (gd.pgmin + gd.pgmax),
                         0.5 * (gd.qgmin + gd.qgmax)], dim=-1),
        vg=_sq(0.5 * (model.vgmin + model.vgmax)),
        fg=torch.zeros((gd.ngen,), dtype=dt, device=dev),
        sto=torch.zeros((st.nstorage,), dtype=dt, device=dev),
        line=torch.stack([
            gd.YffR * wij0 + gd.YftR * wR0,
            -gd.YffI * wij0 - gd.YftI * wR0,
            gd.YttR * wji0 + gd.YtfR * wR0,
            -gd.YttI * wji0 - gd.YtfI * wR0,
            wij0, wji0, zero, zero,
        ], dim=-1) * gd.line_mask[:, None],
    )
    return SolutionMpec(u=zb(), v=v, l=zb(), rho=rho, z=zb(), z_prev=zb(),
                        lz=zb(), rp=zb(), rd=zb(),
                        branch_alm=BranchALMState.zeros(nl, dt, dev))
