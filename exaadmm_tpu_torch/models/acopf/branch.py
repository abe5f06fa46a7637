"""Batched branch (transmission-line) subproblems: the hot kernel.

Counterpart of ``exaadmm_tpu/models/acopf/branch.py``. Each line solves a
6-variable nonconvex NLP in polar coordinates

    x = (v_i, v_j, th_i, th_j, s_ij, s_ji)

with box bounds (Vm/Va bounds; slack in [-rateA, 0]) and the two line-limit
equalities p^2 + q^2 + s = 0 handled by an inner augmented Lagrangian. The
objective is the ADMM proximal term lam.flow + rho/2 (flow - (v - z))^2 over
the 8 flow/voltage quantities of the line
(acopf_eval_linelimit_kernel_cpu.jl:1-46).

Without line limits each line solves the 4-variable polar form over
(v_i, v_j, th_i, th_j) with the same prox objective, no slacks and no ALM
rounds (JAX ``branch_obj_polar`` through ``tron_batched``).

Every line is a lane of one TRON/ALM batch (``ops/tron_cuda.py``): the
hand-written kernel on the GPU (the branch instance, or the polar instance
without line limits), the plain lockstep version on the CPU. With
``Parameters.mixed_precision`` an fp64 solve runs that batch in fp32. The
work around the batch, its inputs' pack and its result's unpack, is
``branch_pack_plain`` and ``branch_unpack_plain`` here and one kernel each
on the GPU (``ops/branch_cuda.py``).
"""

from __future__ import annotations

import torch

from ...ops import branch_cuda, tron_cuda
from ...ops.tron import TronALMResult
from ...parallel.sharding import all_reduce_max, all_reduce_sum
from ...utils import tracing
from ...utils.environment import (BranchALMState, Parameters, Solution,
                                 on_first_iteration)
from ...utils.grid_data import GridData

#: order of the per-line admittances in the packed kernel parameters
Y_KEYS = ("YffR", "YffI", "YftR", "YftI", "YttR", "YttI", "YtfR", "YtfI")


def _flows(x, p):
    """Branch power flows in polar form (acopf_eval_linelimit_kernel_cpu.jl:11-16)."""
    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    cos_ij = torch.cos(thi - thj)
    sin_ij = torch.sin(thi - thj)
    vv_cos = vi * vj * cos_ij
    vv_sin = vi * vj * sin_ij
    vi2 = vi * vi
    vj2 = vj * vj
    pij = p["YffR"] * vi2 + p["YftR"] * vv_cos + p["YftI"] * vv_sin
    qij = -p["YffI"] * vi2 - p["YftI"] * vv_cos + p["YftR"] * vv_sin
    pji = p["YttR"] * vj2 + p["YtfR"] * vv_cos - p["YtfI"] * vv_sin
    qji = -p["YttI"] * vj2 - p["YtfI"] * vv_cos - p["YtfR"] * vv_sin
    return pij, qij, pji, qji


def branch_obj_linelimit(x, p, lam, mu):
    """Full ALM objective of the 6-var line-limit problem, times `scale`."""
    pij, qij, pji, qji = _flows(x, p)
    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    eight = (pij, qij, pji, qji, vi * vi, vj * vj, thi, thj)
    l, rho, t = p["l"], p["rho"], p["t"]
    f = torch.zeros_like(vi)
    for k, w in enumerate(eight):
        dw = w - t[k]
        f = f + l[k] * w + 0.5 * rho[k] * (dw * dw)
    c1 = pij * pij + qij * qij + x[4]
    c2 = pji * pji + qji * qji + x[5]
    f = f + lam[0] * c1 + lam[1] * c2 + 0.5 * mu * (c1 * c1 + c2 * c2)
    return f * p["scale"]


def branch_cons_linelimit(x, p):
    pij, qij, pji, qji = _flows(x, p)
    return torch.stack([pij * pij + qij * qij + x[4],
                        pji * pji + qji * qji + x[5]])


def branch_alm_delta(c, lam_old, mu_old, lam_new, mu_new, p):
    """Exact objective change under an ALM multiplier/penalty update at
    fixed x: the objective is affine in (lam, mu), all times `scale`."""
    dl = (lam_new[0] - lam_old[0]) * c[0] + (lam_new[1] - lam_old[1]) * c[1]
    dq = 0.5 * (mu_new - mu_old) * (c[0] * c[0] + c[1] * c[1])
    return (dl + dq) * p["scale"]


def branch_obj_polar(x, p):
    """Objective of the 4-variable problem without line limits, times
    `scale` (JAX ``branch_obj_polar``): the prox terms alone."""
    pij, qij, pji, qji = _flows(x, p)
    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    eight = (pij, qij, pji, qji, vi * vi, vj * vj, thi, thj)
    l, rho, t = p["l"], p["rho"], p["t"]
    f = torch.zeros_like(vi)
    for k, w in enumerate(eight):
        dw = w - t[k]
        f = f + l[k] * w + 0.5 * rho[k] * (dw * dw)
    return f * p["scale"]


def branch_cons_polar(x, p):
    """No constraints: a (0, B) tensor."""
    return x[:0]


def branch_fgh_linelimit(x, p, lam, mu):
    """Closed-form (f, gradient, Hessian) of ``branch_obj_linelimit``.

    The objective has Gauss-Newton structure over the basis u = (v_i^2,
    v_j^2, v_i v_j cos d, v_i v_j sin d), with the four flows linear in u:

        H = J_u^T M J_u + sum_b a_b (grad^2 u_b) + direct terms,

    where M collapses to a diagonal plus two rank-one terms from the ALM
    quadratic. The operation order is that of the JAX version, term by
    term, and ``csrc/branch_problem.cuh`` repeats it.

    Returns (f (B,), g (6, B), H (6, 6, B)).
    """
    return _branch_fgh(x, p, lam, mu)


def branch_fgh_polar(x, p, lam=None, mu=None):
    """Closed-form (f, gradient, Hessian) of ``branch_obj_polar``: the 4x4
    block of ``branch_fgh_linelimit`` without the ALM terms (kap = 0, no
    slack rows). The JAX package differentiates the polar objective by
    autodiff; ``csrc/branch_problem.cuh`` repeats this order. ``lam`` and
    ``mu`` are ignored.

    Returns (f (B,), g (4, B), H (4, 4, B)).
    """
    return _branch_fgh(x, p)


def _branch_fgh(x, p, lam=None, mu=None):
    """The closed form of both branch objectives: with ``lam`` and ``mu``
    the line-limit ALM objective over (v_i, v_j, th_i, th_j, s_ij, s_ji),
    without them the polar prox objective over the first four."""
    alm = lam is not None
    vi, vj, ti, tj = x[0], x[1], x[2], x[3]
    l, rho, t, scale = p["l"], p["rho"], p["t"], p["scale"]
    c_ = torch.cos(ti - tj)
    s_ = torch.sin(ti - tj)
    u1, u2 = vi * vi, vj * vj
    u3 = vi * vj * c_
    u4 = vi * vj * s_

    # flow coefficient rows K_m over the basis (u1, u2, u3, u4); the zero
    # entries are left out of every sum (they add exact zeros)
    K = [
        (p["YffR"], None, p["YftR"], p["YftI"]),
        (-p["YffI"], None, -p["YftI"], p["YftR"]),
        (None, p["YttR"], p["YtfR"], -p["YtfI"]),
        (None, -p["YttI"], -p["YtfI"], -p["YtfR"]),
    ]
    u = (u1, u2, u3, u4)

    zero = torch.zeros_like(vi)

    def ksum(terms):
        """Left-to-right sum, leaving out the structural zeros (None)."""
        acc = None
        for term in terms:
            if term is not None:
                acc = term if acc is None else acc + term
        return zero if acc is None else acc

    def kmul(k, v):
        return None if k is None else k * v

    F = [ksum(kmul(K[m][b], u[b]) for b in range(4)) for m in range(4)]

    if alm:
        s1, s2 = x[4], x[5]
        c1 = F[0] * F[0] + F[1] * F[1] + s1
        c2v = F[2] * F[2] + F[3] * F[3] + s2
        kap1 = lam[0] + mu * c1
        kap2 = lam[1] + mu * c2v

    # objective
    f = torch.zeros_like(vi)
    for m in range(4):
        dF = F[m] - t[m]
        f = f + l[m] * F[m] + 0.5 * rho[m] * (dF * dF)
    d4, d5, d6, d7 = u1 - t[4], u2 - t[5], ti - t[6], tj - t[7]
    f = (f + l[4] * u1 + 0.5 * rho[4] * (d4 * d4)
         + l[5] * u2 + 0.5 * rho[5] * (d5 * d5)
         + l[6] * ti + 0.5 * rho[6] * (d6 * d6)
         + l[7] * tj + 0.5 * rho[7] * (d7 * d7))
    if alm:
        f = (f + lam[0] * c1 + 0.5 * mu * c1 * c1
             + lam[1] * c2v + 0.5 * mu * c2v * c2v)
    f = f * scale

    # flow adjoints and direct terms
    gF = [l[m] + rho[m] * (F[m] - t[m]) for m in range(4)]
    if alm:
        gF = [gF[0] + 2.0 * kap1 * F[0], gF[1] + 2.0 * kap1 * F[1],
              gF[2] + 2.0 * kap2 * F[2], gF[3] + 2.0 * kap2 * F[3]]
    h_u1 = l[4] + rho[4] * (u1 - t[4])
    h_u2 = l[5] + rho[5] * (u2 - t[5])
    h_ti = l[6] + rho[6] * (ti - t[6])
    h_tj = l[7] + rho[7] * (tj - t[7])

    # basis adjoints a_b = sum_m gF_m K[m][b] (+ direct u terms)
    a = [ksum(None if K[m][b] is None else gF[m] * K[m][b] for m in range(4))
         for b in range(4)]
    a[0] = a[0] + h_u1
    a[1] = a[1] + h_u2

    g_rows = [
        2.0 * vi * a[0] + vj * c_ * a[2] + vj * s_ * a[3],
        2.0 * vj * a[1] + vi * c_ * a[2] + vi * s_ * a[3],
        -u4 * a[2] + u3 * a[3] + h_ti,
        u4 * a[2] - u3 * a[3] + h_tj,
    ]
    if alm:
        g_rows += [kap1, kap2]
    g = torch.stack(g_rows) * scale

    # --- Hessian ---
    # M over the basis: K^T diag(rho_m + 2 kap_blk) K
    #                   + mu (K^T w1)(K^T w1)^T + mu (K^T w2)(K^T w2)^T
    #                   + diag(rho4, rho5, 0, 0)
    # (without the ALM terms: K^T diag(rho_m) K + diag(rho4, rho5, 0, 0))
    if alm:
        rt = [rho[0] + 2.0 * kap1, rho[1] + 2.0 * kap1,
              rho[2] + 2.0 * kap2, rho[3] + 2.0 * kap2]
        kw1 = [2.0 * ksum(None if K[m][b] is None else F[m] * K[m][b]
                          for m in (0, 1)) for b in range(4)]
        kw2 = [2.0 * ksum(None if K[m][b] is None else F[m] * K[m][b]
                          for m in (2, 3)) for b in range(4)]
    else:
        rt = [rho[0], rho[1], rho[2], rho[3]]
    M = [[None] * 4 for _ in range(4)]
    for b in range(4):
        for b2 in range(b, 4):
            m_val = ksum(None if K[m][b] is None or K[m][b2] is None
                         else rt[m] * K[m][b] * K[m][b2] for m in range(4))
            if alm:
                m_val = m_val + mu * (kw1[b] * kw1[b2] + kw2[b] * kw2[b2])
            M[b][b2] = M[b2][b] = m_val
    M[0][0] = M[0][0] + rho[4]
    M[1][1] = M[1][1] + rho[5]

    # basis Jacobian rows (over vi, vj, ti, tj); columns have <= 3
    # structural nonzeros and column 3 is minus column 2 over the basis
    jv0 = 2.0 * vi          # Ju[0][0]
    jv1 = 2.0 * vj          # Ju[1][1]
    jc0, jc1 = vj * c_, vi * c_   # Ju[2][0], Ju[2][1]
    js0, js1 = vj * s_, vi * s_   # Ju[3][0], Ju[3][1]
    # T = M @ Ju with the sparse columns (T[b][3] = -T[b][2])
    T = [None] * 4
    for b in range(4):
        t0 = M[b][0] * jv0 + M[b][2] * jc0 + M[b][3] * js0
        t1 = M[b][1] * jv1 + M[b][2] * jc1 + M[b][3] * js1
        t2 = -M[b][2] * u4 + M[b][3] * u3
        T[b] = (t0, t1, t2)
    # H4 = Ju^T T, upper triangle; H4[i][3] = -H4[i][2] (Gauss-Newton part)
    H4 = [[None] * 4 for _ in range(4)]
    for j in range(3):
        H4[0][j] = jv0 * T[0][j] + jc0 * T[2][j] + js0 * T[3][j]
        H4[1][j] = jv1 * T[1][j] + jc1 * T[2][j] + js1 * T[3][j]
        H4[2][j] = -u4 * T[2][j] + u3 * T[3][j]
    H4[0][3] = -H4[0][2]
    H4[1][3] = -H4[1][2]
    H4[2][3] = -H4[2][2]
    H4[3][3] = H4[2][2]

    # curvature of the basis: sum_b a_b grad^2 u_b
    H4[0][0] = H4[0][0] + 2.0 * a[0]
    H4[1][1] = H4[1][1] + 2.0 * a[1]
    H4[0][1] = H4[0][1] + a[2] * c_ + a[3] * s_
    H4[0][2] = H4[0][2] - a[2] * vj * s_ + a[3] * vj * c_
    H4[0][3] = H4[0][3] + a[2] * vj * s_ - a[3] * vj * c_
    H4[1][2] = H4[1][2] - a[2] * vi * s_ + a[3] * vi * c_
    H4[1][3] = H4[1][3] + a[2] * vi * s_ - a[3] * vi * c_
    H4[2][2] = H4[2][2] - a[2] * u3 - a[3] * u4 + rho[6]
    H4[2][3] = H4[2][3] + a[2] * u3 + a[3] * u4
    H4[3][3] = H4[3][3] - a[2] * u3 - a[3] * u4 + rho[7]

    rows = [[H4[min(i, j)][max(i, j)] * scale for j in range(4)]
            for i in range(4)]
    if alm:
        # cross terms with the slacks: d kap_blk / dx = mu * Ju^T kw_blk,
        # over the structural nonzeros of Ju's columns
        def cross(kwb):
            return [mu * (jv0 * kwb[0] + jc0 * kwb[2] + js0 * kwb[3]),
                    mu * (jv1 * kwb[1] + jc1 * kwb[2] + js1 * kwb[3]),
                    mu * (-u4 * kwb[2] + u3 * kwb[3]),
                    mu * (u4 * kwb[2] + -u3 * kwb[3])]

        cross1 = cross(kw1)
        cross2 = cross(kw2)
        for i in range(4):
            rows[i] += [cross1[i] * scale, cross2[i] * scale]
        rows.append([cross1[j] * scale for j in range(4)] + [mu * scale, zero])
        rows.append([cross2[j] * scale for j in range(4)] + [zero, mu * scale])
    H = torch.stack([torch.stack(r) for r in rows])
    return f, g, H


def _branch_params(sol: Solution, gd: GridData, par: Parameters):
    """Per-line parameters in the solver's rows layout (leaves (..., B))."""
    t = sol.v.line - sol.z.line  # prox target (membuf rows 17-24)
    p = {k: getattr(gd, k) for k in Y_KEYS}
    p.update(l=sol.l.line.T, rho=sol.rho.line.T, t=t.T,
             scale=torch.full_like(t[:, 0], par.scale))
    return p


def _warm_start_x0(u_line, gd: GridData, use_linelimit: bool = True):
    """Warm start from current u (auglag kernel :42-47) and the bounds.

    Rows layout: returns (n, B) tensors x0, xl, xu for the batched solver,
    n = 6 with line limits (the two slacks last), else 4."""
    vi0 = torch.clamp(torch.sqrt(torch.clamp_min(u_line[:, 4], 0.0)),
                      min=gd.fr_vm_bound[:, 0], max=gd.fr_vm_bound[:, 1])
    vj0 = torch.clamp(torch.sqrt(torch.clamp_min(u_line[:, 5], 0.0)),
                      min=gd.to_vm_bound[:, 0], max=gd.to_vm_bound[:, 1])
    ti0 = torch.clamp(u_line[:, 6], min=gd.fr_va_bound[:, 0],
                      max=gd.fr_va_bound[:, 1])
    tj0 = torch.clamp(u_line[:, 7], min=gd.to_va_bound[:, 0],
                      max=gd.to_va_bound[:, 1])
    cols = [vi0, vj0, ti0, tj0]
    lo = [gd.fr_vm_bound[:, 0], gd.to_vm_bound[:, 0],
          gd.fr_va_bound[:, 0], gd.to_va_bound[:, 0]]
    hi = [gd.fr_vm_bound[:, 1], gd.to_vm_bound[:, 1],
          gd.fr_va_bound[:, 1], gd.to_va_bound[:, 1]]
    if use_linelimit:
        zero = torch.zeros_like(gd.rate_a)
        sij0 = torch.clamp(-(u_line[:, 0] * u_line[:, 0]
                             + u_line[:, 1] * u_line[:, 1]),
                           min=-gd.rate_a, max=zero)
        sji0 = torch.clamp(-(u_line[:, 2] * u_line[:, 2]
                             + u_line[:, 3] * u_line[:, 3]),
                           min=-gd.rate_a, max=zero)
        cols += [sij0, sji0]
        lo += [-gd.rate_a, -gd.rate_a]
        hi += [zero, zero]
    return torch.stack(cols), torch.stack(lo), torch.stack(hi)


def branch_tolerances(par: Parameters, dtype):
    """The TRON/ALM tolerances for a solve in ``dtype``.

    The reference's fp64 targets (gtol 1e-6 on the scaled objective,
    |c| <= 1e-6 with c ~ O(10..100)) sit below fp32 rounding noise, so they
    are floored at a multiple of the dtype's epsilon, and mu_max is capped
    so the Hessian's conditioning stays within the dtype. In fp64 every value
    is the reference's own."""
    eps = float(torch.finfo(dtype).eps)
    return dict(gtol=max(par.tron_gtol, 40.0 * eps),
                frtol=max(par.tron_frtol, 10.0 * eps),
                ctol=max(par.alm_ctol, 300.0 * eps),
                mu_max=min(par.mu_max, 0.1 / eps),
                max_minor=par.tron_max_minor, max_auglag=par.max_auglag,
                step_cap=par.tron_step_cap)


def branch_inputs(sol: Solution, gd: GridData, par: Parameters,
                  inner_iter):
    """The batch's inputs: x0, xl, xu (6, B), params, lam0 (2, B), mu0 (B,)
    and active0 (B,).

    ``inner_iter`` is the 1-based inner-iteration counter (an int, or a 0-d
    tensor in the fused loop): the ALM penalty
    restarts at 10 on the first inner iteration of each outer loop (membuf
    row 27, auglag kernel :81-87); the multipliers warm-start across all
    iterations."""
    alm = sol.branch_alm
    x0, xl, xu = _warm_start_x0(sol.u.line, gd)
    mu0 = on_first_iteration(inner_iter, torch.full_like(alm.mu, 10.0),
                             alm.mu)
    lam0 = torch.stack([alm.lam1, alm.lam2])
    return (x0, xl, xu, _branch_params(sol, gd, par), lam0, mu0,
            gd.line_mask > 0.5)


def polar_inputs(sol: Solution, gd: GridData, par: Parameters):
    """The polar batch's inputs: x0, xl, xu (4, B), params, lam0 (0, B),
    mu0 (B,) and active0 (B,); as JAX ``tron_batched`` sets them, no
    multipliers and mu0 = 10 (one ALM round that finds no constraint)."""
    x0, xl, xu = _warm_start_x0(sol.u.line, gd, use_linelimit=False)
    B = x0.shape[1]
    lam0 = x0.new_zeros((0, B))
    mu0 = x0.new_full((B,), 10.0)
    return (x0, xl, xu, _branch_params(sol, gd, par), lam0, mu0,
            gd.line_mask > 0.5)


def polar_tolerances(par: Parameters, dtype):
    """``branch_tolerances`` for the polar batch: one ALM round (JAX
    ``tron_batched``'s max_auglag 1)."""
    return dict(branch_tolerances(par, dtype), max_auglag=1)


def cast_down(*ts):
    """fp32 copies of the fp64 batch inputs (a params dict casts every
    entry), contiguous, as the f32 kernel instance requires."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(torch.float32).contiguous()
    return tuple(cast(t) for t in ts)


def cast_up(res: TronALMResult, dtype) -> TronALMResult:
    """The batch's result with its floating-point outputs cast to ``dtype``."""
    return res._replace(x=res.x.to(dtype), lam=res.lam.to(dtype),
                        mu=res.mu.to(dtype), cviol=res.cviol.to(dtype))


def branch_pack_plain(sol: Solution, gd: GridData, par: Parameters,
                      inner_iter, use_linelimit: bool, solve_dtype):
    """The batch's inputs as the TRON kernel takes them: x0, xl, xu (n, B),
    the packed (33, B) parameter block, lam0 (ncon, B), mu0 (B,), all in
    ``solve_dtype``, and the uint8 flag active0 (B,). With line limits
    ``branch_inputs``' batch (n = 6, ncon = 2), else ``polar_inputs``'
    (n = 4, ncon = 0); in fp32 under mixed precision (``cast_down`` of the
    fp64 values). The plain version of ``ops/branch_cuda.branch_pack``."""
    if use_linelimit:
        x0, xl, xu, params, lam0, mu0, active0 = branch_inputs(
            sol, gd, par, inner_iter)
    else:
        x0, xl, xu, params, lam0, mu0, active0 = polar_inputs(sol, gd, par)
    batch = (x0, xl, xu, tron_cuda.pack_params(params), lam0, mu0)
    if solve_dtype != sol.u.line.dtype:
        batch = cast_down(*batch)
    return (*batch, active0.to(torch.uint8))


def branch_stats_plain(res: TronALMResult, gd: GridData, active0):
    """The batch's stats before any all-reduce, one (5,) tensor in the
    state's dtype: the sums of ``alm_iters`` and ``minor_iters`` over the
    real lines, the largest violation of an active lane, and the two sums
    over ``gd.nline``; ``res`` is in the state's dtype."""
    m = gd.line_mask
    sums = torch.stack([torch.sum(res.alm_iters * m),
                        torch.sum(res.minor_iters * m)])
    max_cv = torch.amax(torch.where(active0, res.cviol,
                                    torch.zeros_like(res.cviol)))
    return torch.cat([sums, max_cv[None], sums / gd.nline])


def branch_unpack_plain(res: TronALMResult, sol: Solution, gd: GridData,
                        active0, use_linelimit: bool, out_dtype, steps=None):
    """(u_new (B, 8), the new ALM state, lane_steps (B,) int32, the stats
    of ``branch_stats_plain``) from the batch's result: x, the multipliers,
    the penalties and the violations cast up to ``out_dtype`` first
    (mixed precision), the four flows at x where the lane is active, else
    its old row; without line limits the ALM state as it was. ``steps``, a
    0-d int64 tensor or None, gets the stats' two sums added to it. The
    plain version of ``ops/branch_cuda.branch_unpack``."""
    if res.x.dtype != out_dtype:
        res = cast_up(res, out_dtype)
    new_alm = (BranchALMState(lam1=res.lam[0], lam2=res.lam[1], mu=res.mu)
               if use_linelimit else sol.branch_alm)
    p = {k: getattr(gd, k) for k in Y_KEYS}
    pij, qij, pji, qji = _flows(res.x, p)
    vi, vj = res.x[0], res.x[1]
    u_new = torch.stack([pij, qij, pji, qji, vi * vi, vj * vj,
                         res.x[2], res.x[3]], dim=-1)
    # padded lanes keep their previous (zero) state
    active = active0 != 0
    u_new = torch.where(active[:, None], u_new, sol.u.line)
    stats = branch_stats_plain(res, gd, active)
    if steps is not None:
        # integer values: the conversions are exact
        steps.add_(stats[0].to(torch.int64) + stats[1].to(torch.int64))
    # each lane's trust-region steps and ALM rounds (0 on padded lanes):
    # the difficulty that Parameters.sort_lines orders the lanes by
    lane_steps = ((res.minor_iters + res.alm_iters)
                  * gd.line_mask.to(res.minor_iters.dtype))
    return u_new, new_alm, lane_steps, stats


def branch_update(sol: Solution, gd: GridData, par: Parameters,
                  inner_iter, use_linelimit: bool = True):
    """Solve all line subproblems; returns (new u line block, new ALM state,
    stats). The stats are tensors (nothing is read back here). Without line
    limits the ALM state is returned unchanged and ``max_cviol`` is 0.

    Three steps, each a hand-written kernel on the card
    (``ops/branch_cuda.py``, ``ops/tron_cuda.py``) and its plain version on
    the CPU: the pack (``branch_pack_plain``), the TRON/ALM batch on the
    packed block, and the unpack (``branch_unpack_plain``); then, with the
    lines split over a mesh, one (2,) sum and one maximum across the ranks.

    With ``par.mixed_precision`` on fp64 state the batch runs in fp32 with
    fp32 tolerances (the kernel's f32 instance); its inputs are cast down
    and x, the multipliers, the penalties and the violations cast back up
    before the flows, so the returned state stays fp64
    (``cast_down``/``cast_up``, JAX ``branch_update``'s ``_down``/``_up``).

    While a fused loop that counts TRON steps runs or captures its bodies
    (``tracing.counting_steps``), the unpack adds the batch's steps to its
    counter."""
    out_dtype = sol.u.line.dtype
    mixed = par.mixed_precision and out_dtype == torch.float64
    solve_dtype = torch.float32 if mixed else out_dtype
    if use_linelimit:
        inst, opts = tron_cuda.BRANCH, branch_tolerances(par, solve_dtype)
    else:
        inst, opts = tron_cuda.POLAR, polar_tolerances(par, solve_dtype)
    *batch, active0 = branch_cuda.branch_pack(
        sol, gd, par, inner_iter, use_linelimit, solve_dtype)
    res = tron_cuda.tron_alm_packed(inst, *batch, active0=active0, **opts)
    u_new, new_alm, lane_steps, tot = branch_cuda.branch_unpack(
        res, sol, gd, active0, use_linelimit, out_dtype, tracing.steps)
    if gd.mesh is None:
        avg, max_cv = tot[3:], tot[2]
    else:
        # lines split across ranks: one (2,) sum and one scalar maximum
        avg = all_reduce_sum(tot[:2], gd.mesh) / gd.nline
        max_cv = all_reduce_max(tot[2], gd.mesh)
    stats = {
        "avg_auglag_it": avg[0],
        "avg_minor_it": avg[1],
        "max_cviol": max_cv,
        "lane_steps": lane_steps,
    }
    return u_new, new_alm, stats
