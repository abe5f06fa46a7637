"""Closed-form ACOPF component updates (generator, bus, z/l/lz, residual).

Counterpart of ``exaadmm_tpu/models/acopf/kernels.py``:

- generator update: a box-projected proximal step per generator
  (reference acopf_generator_kernel_cpu.jl:11-16),
- bus update: per-bus sums over the incident lines and generators plus a 2x2
  KKT solve per bus (reference acopf_bus_kernel_cpu.jl:12-116); the sums go
  through ``ops/bus_cuda.py`` (the hand-written deterministic scatter on the
  GPU, ``index_add_`` on the CPU), the writeback is gathers,
- z / l / lz / residual updates: elementwise, plus norms.
"""

from __future__ import annotations

import torch

from ...ops import bus_cuda
from ...parallel.sharding import all_reduce_sum
from ...utils.environment import Blocks, blocks_map
from ...utils.grid_data import GridData


def generator_update(
    u_gen, v_gen, z_gen, l_gen, rho_gen,
    pgmin, pgmax, qgmin, qgmax, c2_eff, c1_eff, baseMVA,
):
    """One proximal generator step; returns the new (ngen, 2) u block.

    pg = clip((-(c1*B + l + rho*(z - v))) / (2 c2 B^2 + rho));  qg analogous
    without the cost terms (acopf_generator_kernel_cpu.jl:11-16).
    """
    lp, lq = l_gen[:, 0], l_gen[:, 1]
    rp_, rq = rho_gen[:, 0], rho_gen[:, 1]
    vp, vq = v_gen[:, 0], v_gen[:, 1]
    zp, zq = z_gen[:, 0], z_gen[:, 1]

    pg = (-(c1_eff * baseMVA + lp + rp_ * (-vp + zp))) / (
        2.0 * c2_eff * baseMVA**2 + rp_)
    qg = (-(lq + rq * (-vq + zq))) / rq
    pg = torch.clamp(pg, min=pgmin, max=pgmax)
    qg = torch.clamp(qg, min=qgmin, max=qgmax)
    return torch.stack([pg, qg], dim=-1)


def bus_arc_values(u: Blocks, z: Blocks, l: Blocks, rho: Blocks,
                   gd: GridData) -> torch.Tensor:
    """The (..., 2 * nline_padded, 8) per-arc terms that the bus update sums
    into each bus: the from-side rows, then the to-side rows, zero on
    padding. Leading (period) axes pass through."""
    uL, zL, lL, rL = u.line, z.line, l.line, rho.line
    m = gd.line_mask
    # lam + rho*(u + z) for the bus-owned rows (wi, wj, thi, thj)
    uz = uL + zL
    acc_w_fr = (lL[..., 4] + rL[..., 4] * uz[..., 4]) * m
    acc_w_to = (lL[..., 5] + rL[..., 5] * uz[..., 5]) * m
    acc_t_fr = (lL[..., 6] + rL[..., 6] * uz[..., 6]) * m
    acc_t_to = (lL[..., 7] + rL[..., 7] * uz[..., 7]) * m
    return torch.cat([
        torch.stack([
            acc_w_fr, acc_t_fr, rL[..., 4] * m, rL[..., 6] * m,
            m / rL[..., 0], m / rL[..., 1],
            (uz[..., 0] + lL[..., 0] / rL[..., 0]) * m,
            (uz[..., 1] + lL[..., 1] / rL[..., 1]) * m,
        ], dim=-1),
        torch.stack([
            acc_w_to, acc_t_to, rL[..., 5] * m, rL[..., 7] * m,
            m / rL[..., 2], m / rL[..., 3],
            (uz[..., 2] + lL[..., 2] / rL[..., 2]) * m,
            (uz[..., 3] + lL[..., 3] / rL[..., 3]) * m,
        ], dim=-1),
    ], dim=-2)


def _gen_p(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, ramp=None):
    """Numerator and denominator of the pg rows' consensus target. With
    ``ramp`` (the next period's ramp coupling ``u/z/l/rho``, (..., ngen)
    each) they blend its terms in (mpacopf_bus_kernel_cpu.jl:56-64):
    (l + rho (u + z) + r_l + r_rho (r_u + r_z)) / (rho + r_rho)."""
    num = l.gen[..., 0] + rho.gen[..., 0] * (u.gen[..., 0] + z.gen[..., 0])
    den = rho.gen[..., 0]
    if ramp is not None:
        num = num + ramp["l"] + ramp["rho"] * (ramp["u"] + ramp["z"])
        den = den + ramp["rho"]
    return num, den


def bus_gen_values(u: Blocks, z: Blocks, l: Blocks, rho: Blocks,
                   ramp=None) -> torch.Tensor:
    """The (..., ngen, 4) per-generator terms that the bus update sums into
    each bus: p and q targets and the two inverse penalties."""
    gen_p_num, gen_p_den = _gen_p(u, z, l, rho, ramp)
    uzq = u.gen[..., 1] + z.gen[..., 1]
    lq, rq = l.gen[..., 1], rho.gen[..., 1]
    return torch.stack([gen_p_num / gen_p_den, uzq + lq / rq,
                        1.0 / gen_p_den, 1.0 / rq], dim=-1)


def _sum_into_buses(vals, seg_ids, ptr, idx):
    """Segment sums of (R, C) rows, or of (T, R, C) rows of T periods with
    one launch for all periods."""
    if vals.dim() == 2:
        return bus_cuda.bus_scatter(vals, seg_ids, ptr, idx)
    return bus_cuda.bus_scatter_periods(vals, seg_ids, ptr, idx)


def bus_update(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, gd: GridData,
               Pd=None, Qd=None, ramp=None) -> Blocks:
    """Bus consensus (xbar) update; returns the new v Blocks.

    Per bus the optimality system for the two power-balance multipliers
    (mu1, mu2) is 2x2 linear (including shunt coupling through the shared
    w_i); solved in closed form with the reference's elimination order
    (acopf_bus_kernel_cpu.jl:85-93). Pd/Qd default to the grid loads.

    Multi-period: blocks of shape (T, ...) and Pd/Qd of shape (T, nbus)
    update all T periods at once; the grid (and so the bus CSR) is the same
    in every period, and each bus sum is one launch for all periods.
    ``ramp`` blends the next period's ramp coupling into the pg rows
    (``_gen_p``); None is the single-period update.
    """
    fr, to, gb = gd.line_from, gd.line_to, gd.gen_bus
    zL, lL, rL = z.line, l.line, rho.line
    uG, zG, lG, rG = u.gen, z.gen, l.gen, rho.gen
    uL = u.line

    if Pd is None:
        Pd = gd.Pd
    if Qd is None:
        Qd = gd.Qd

    # the lines may be split across ranks (``gd.mesh``): their arc sums are
    # completed by one all-reduce; generators and buses are replicated
    agg = all_reduce_sum(
        _sum_into_buses(bus_arc_values(u, z, l, rho, gd), gd.arc_bus,
                        gd.arc_ptr, gd.arc_idx), gd.mesh)
    uz = uL + zL
    common_wi = agg[..., 0]
    common_ti = agg[..., 1]
    rhosum_wi = agg[..., 2]
    rhosum_ti = agg[..., 3]
    inv_rho_p = agg[..., 4]
    inv_rho_q = agg[..., 5]
    flow_rhs1 = agg[..., 6]
    flow_rhs2 = agg[..., 7]

    # guard isolated buses (no incident line) against 0/0
    one = torch.ones_like(rhosum_wi)
    safe_rhosum_wi = torch.where(rhosum_wi > 0, rhosum_wi, one)
    safe_rhosum_ti = torch.where(rhosum_ti > 0, rhosum_ti, one)
    common_wi = common_wi / safe_rhosum_wi

    # generator contributions, one scatter for the four sums
    uzG = uG + zG
    gen_p_num, gen_p_den = _gen_p(u, z, l, rho, ramp)
    gsum = _sum_into_buses(bus_gen_values(u, z, l, rho, ramp), gb,
                           gd.gen_ptr, gd.gen_idx)
    rhs1, rhs2, inv_rho_pg, inv_rho_qg = gsum.unbind(-1)

    rhs1 = rhs1 - Pd / gd.baseMVA
    rhs2 = rhs2 - Qd / gd.baseMVA

    rhs1 = rhs1 - flow_rhs1
    rhs2 = rhs2 - flow_rhs2

    rhs1 = rhs1 - gd.YshR * common_wi
    rhs2 = rhs2 + gd.YshI * common_wi

    A11 = (inv_rho_pg + inv_rho_p) + (gd.YshR * gd.YshR / safe_rhosum_wi)
    A12 = -gd.YshR * (gd.YshI / safe_rhosum_wi)
    A22 = (inv_rho_qg + inv_rho_q) + (gd.YshI * gd.YshI / safe_rhosum_wi)
    # same elimination ordering as the reference (:90-92)
    safe_A11 = torch.where(A11 != 0, A11, one)
    mu2 = (rhs2 - (A12 / safe_A11) * rhs1) / (A22 - (A12 / safe_A11) * A12)
    mu1 = (rhs1 - A12 * mu2) / safe_A11

    wi = common_wi + (gd.YshR * mu1 - gd.YshI * mu2) / safe_rhosum_wi
    ti = common_ti / safe_rhosum_ti

    # writeback: consensus copies for every attached component
    wtm = torch.stack([wi, ti, mu1, mu2], dim=-1)
    g_fr = wtm[..., fr, :]
    g_to = wtm[..., to, :]
    g_gb = wtm[..., gb, :]

    v_gen = torch.stack(
        [
            (gen_p_num - g_gb[..., 2]) / gen_p_den,
            uzG[..., 1] + (lG[..., 1] - g_gb[..., 3]) / rG[..., 1],
        ],
        dim=-1,
    )
    v_line = torch.stack(
        [
            uz[..., 0] + (lL[..., 0] + g_fr[..., 2]) / rL[..., 0],
            uz[..., 1] + (lL[..., 1] + g_fr[..., 3]) / rL[..., 1],
            uz[..., 2] + (lL[..., 2] + g_to[..., 2]) / rL[..., 2],
            uz[..., 3] + (lL[..., 3] + g_to[..., 3]) / rL[..., 3],
            g_fr[..., 0],
            g_to[..., 0],
            g_fr[..., 1],
            g_to[..., 1],
        ],
        dim=-1,
    )
    return Blocks(gen=v_gen, line=v_line)


def z_update(u: Blocks, v: Blocks, l: Blocks, rho: Blocks, lz: Blocks,
             beta) -> Blocks:
    """z = -(lz + l + rho*(u - v)) / (beta + rho) (acopf_admm_update_z_cpu.jl:10)."""
    return blocks_map(
        lambda uu, vv, ll, rr, zz: (-(zz + ll + rr * (uu - vv))) / (beta + rr),
        u, v, l, rho, lz,
    )


def l_update(z: Blocks, lz: Blocks, beta) -> Blocks:
    """l = -(lz + beta*z) (acopf_admm_update_l_cpu.jl:10)."""
    return blocks_map(lambda zz, ll: -(ll + beta * zz), z, lz)


def lz_update(z: Blocks, lz: Blocks, beta, max_multiplier) -> Blocks:
    """lz = clamp(lz + beta*z, +-MAX_MULTIPLIER) (acopf_admm_update_lz_cpu.jl:10)."""
    return blocks_map(
        lambda zz, ll: torch.clamp(ll + beta * zz, -max_multiplier,
                                   max_multiplier),
        z, lz,
    )


def compute_objval(u_gen, c2, c1, c0, baseMVA):
    """sum c2*(B*pg)^2 + c1*(B*pg) + c0 with the raw cost coefficients
    (the reported objective ignores obj_scale, as the reference does)."""
    pg = baseMVA * u_gen[:, 0]
    return torch.sum(c2 * (pg * pg) + c1 * pg + c0)


def residual_update(sol, gd: GridData, beta):
    """Residual blocks and scalar norms; returns (new rp, rd, scalars dict).

    rp = u - v + z; rd = z - z_prev; mismatch = ||u - v||
    (acopf_admm_update_residual_cpu.jl). The augmented-Lagrangian value sums
    over the full vector; the reference CPU code sums only the first entry
    (a loop over ``1:length(nvar)`` with an integer nvar). It is display-only,
    and the correct sum is kept here, as in the JAX version.

    With the lines split across ranks (``gd.mesh``) the seven line partial
    sums are stacked and completed by one all-reduce; the generator terms
    are replicated and added after it.
    """
    m = gd.line_mask[:, None]
    rp = blocks_map(lambda uu, vv, zz: uu - vv + zz, sol.u, sol.v, sol.z)
    rd = blocks_map(lambda zc, zp: zc - zp, sol.z, sol.z_prev)
    ax_by = blocks_map(lambda a, b: a - b, rp, sol.z)

    def line_dot(a, b):
        return torch.sum(a * b * m)

    def gen_dot(a, b):
        return torch.sum(a * b)

    line_parts = [
        line_dot(rp.line, rp.line),
        line_dot(rd.line, rd.line),
        line_dot(sol.z.line, sol.z.line),
        line_dot(ax_by.line, ax_by.line),
        line_dot(sol.lz.line, sol.z.line),
        line_dot(sol.l.line, rp.line),
        line_dot(sol.rho.line, rp.line * rp.line),
    ]
    if gd.mesh is not None:
        line_parts = all_reduce_sum(torch.stack(line_parts), gd.mesh).unbind()

    z_sq = gen_dot(sol.z.gen, sol.z.gen) + line_parts[2]
    primres = torch.sqrt(gen_dot(rp.gen, rp.gen) + line_parts[0])
    dualres = torch.sqrt(gen_dot(rd.gen, rd.gen) + line_parts[1])
    norm_z = torch.sqrt(z_sq)
    mismatch = torch.sqrt(gen_dot(ax_by.gen, ax_by.gen) + line_parts[3])

    objval = compute_objval(sol.u.gen, gd.c2, gd.c1, gd.c0, gd.baseMVA)

    auglag = (
        objval
        + (gen_dot(sol.lz.gen, sol.z.gen) + line_parts[4])
        + 0.5 * beta * z_sq
        + (gen_dot(sol.l.gen, rp.gen) + line_parts[5])
        + 0.5 * (gen_dot(sol.rho.gen, rp.gen * rp.gen) + line_parts[6])
    )

    scalars = {
        "primres": primres,
        "dualres": dualres,
        "norm_z_curr": norm_z,
        "mismatch": mismatch,
        "objval": objval,
        "auglag": auglag,
    }
    return rp, rd, scalars
