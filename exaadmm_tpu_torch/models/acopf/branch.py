"""Batched branch (transmission-line) subproblems: the hot kernel.

Counterpart of ``exaadmm_tpu/models/acopf/branch.py``. Each line solves a
6-variable nonconvex NLP in polar coordinates

    x = (v_i, v_j, th_i, th_j, s_ij, s_ji)

with box bounds (Vm/Va bounds; slack in [-rateA, 0]) and the two line-limit
equalities p^2 + q^2 + s = 0 handled by an inner augmented Lagrangian. The
objective is the ADMM proximal term lam.flow + rho/2 (flow - (v - z))^2 over
the 8 flow/voltage quantities of the line
(acopf_eval_linelimit_kernel_cpu.jl:1-46).

Every line is a lane of one TRON/ALM batch (``ops/tron_cuda.py``): the
hand-written kernel on the GPU, the plain lockstep version on the CPU. Only
the line-limit form is ported; the 4-variable polar form without line
limits raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ...ops import tron_cuda
from ...utils.environment import BranchALMState, Parameters, Solution
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


def branch_fgh_linelimit(x, p, lam, mu):
    """Closed-form (f, gradient, Hessian) of ``branch_obj_linelimit``.

    The objective has Gauss-Newton structure over the basis u = (v_i^2,
    v_j^2, v_i v_j cos d, v_i v_j sin d), with the four flows linear in u:

        H = J_u^T M J_u + sum_b a_b (grad^2 u_b) + direct terms,

    where M collapses to a diagonal plus two rank-one terms from the ALM
    quadratic. The operation order is that of the JAX version, term by
    term, and ``csrc/tron_alm_branch.cu`` repeats it.

    Returns (f (B,), g (6, B), H (6, 6, B)).
    """
    vi, vj, ti, tj, s1, s2 = x[0], x[1], x[2], x[3], x[4], x[5]
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
         + l[7] * tj + 0.5 * rho[7] * (d7 * d7)
         + lam[0] * c1 + 0.5 * mu * c1 * c1
         + lam[1] * c2v + 0.5 * mu * c2v * c2v) * scale

    # flow adjoints and direct terms
    gF = [
        l[0] + rho[0] * (F[0] - t[0]) + 2.0 * kap1 * F[0],
        l[1] + rho[1] * (F[1] - t[1]) + 2.0 * kap1 * F[1],
        l[2] + rho[2] * (F[2] - t[2]) + 2.0 * kap2 * F[2],
        l[3] + rho[3] * (F[3] - t[3]) + 2.0 * kap2 * F[3],
    ]
    h_u1 = l[4] + rho[4] * (u1 - t[4])
    h_u2 = l[5] + rho[5] * (u2 - t[5])
    h_ti = l[6] + rho[6] * (ti - t[6])
    h_tj = l[7] + rho[7] * (tj - t[7])

    # basis adjoints a_b = sum_m gF_m K[m][b] (+ direct u terms)
    a = [ksum(None if K[m][b] is None else gF[m] * K[m][b] for m in range(4))
         for b in range(4)]
    a[0] = a[0] + h_u1
    a[1] = a[1] + h_u2

    g = torch.stack([
        2.0 * vi * a[0] + vj * c_ * a[2] + vj * s_ * a[3],
        2.0 * vj * a[1] + vi * c_ * a[2] + vi * s_ * a[3],
        -u4 * a[2] + u3 * a[3] + h_ti,
        u4 * a[2] - u3 * a[3] + h_tj,
        kap1,
        kap2,
    ]) * scale

    # --- Hessian ---
    # M over the basis: K^T diag(rho_m + 2 kap_blk) K
    #                   + mu (K^T w1)(K^T w1)^T + mu (K^T w2)(K^T w2)^T
    #                   + diag(rho4, rho5, 0, 0)
    rt = [rho[0] + 2.0 * kap1, rho[1] + 2.0 * kap1,
          rho[2] + 2.0 * kap2, rho[3] + 2.0 * kap2]
    kw1 = [2.0 * ksum(None if K[m][b] is None else F[m] * K[m][b]
                      for m in (0, 1)) for b in range(4)]
    kw2 = [2.0 * ksum(None if K[m][b] is None else F[m] * K[m][b]
                      for m in (2, 3)) for b in range(4)]
    M = [[None] * 4 for _ in range(4)]
    for b in range(4):
        for b2 in range(b, 4):
            m_val = ksum(None if K[m][b] is None or K[m][b2] is None
                         else rt[m] * K[m][b] * K[m][b2] for m in range(4))
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

    # cross terms with the slacks: d kap_blk / dx = mu * Ju^T kw_blk, over
    # the structural nonzeros of Ju's columns
    def cross(kwb):
        return [mu * (jv0 * kwb[0] + jc0 * kwb[2] + js0 * kwb[3]),
                mu * (jv1 * kwb[1] + jc1 * kwb[2] + js1 * kwb[3]),
                mu * (-u4 * kwb[2] + u3 * kwb[3]),
                mu * (u4 * kwb[2] + -u3 * kwb[3])]

    cross1 = cross(kw1)
    cross2 = cross(kw2)

    rows = []
    for i in range(4):
        rows.append([H4[min(i, j)][max(i, j)] * scale for j in range(4)]
                    + [cross1[i] * scale, cross2[i] * scale])
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


def _warm_start_x0(u_line, gd: GridData):
    """Warm start from current u (auglag kernel :42-47) and the bounds.

    Rows layout: returns (6, B) tensors x0, xl, xu for the batched solver."""
    vi0 = torch.clamp(torch.sqrt(torch.clamp_min(u_line[:, 4], 0.0)),
                      min=gd.fr_vm_bound[:, 0], max=gd.fr_vm_bound[:, 1])
    vj0 = torch.clamp(torch.sqrt(torch.clamp_min(u_line[:, 5], 0.0)),
                      min=gd.to_vm_bound[:, 0], max=gd.to_vm_bound[:, 1])
    ti0 = torch.clamp(u_line[:, 6], min=gd.fr_va_bound[:, 0],
                      max=gd.fr_va_bound[:, 1])
    tj0 = torch.clamp(u_line[:, 7], min=gd.to_va_bound[:, 0],
                      max=gd.to_va_bound[:, 1])
    zero = torch.zeros_like(gd.rate_a)
    sij0 = torch.clamp(-(u_line[:, 0] * u_line[:, 0]
                         + u_line[:, 1] * u_line[:, 1]),
                       min=-gd.rate_a, max=zero)
    sji0 = torch.clamp(-(u_line[:, 2] * u_line[:, 2]
                         + u_line[:, 3] * u_line[:, 3]),
                       min=-gd.rate_a, max=zero)
    x0 = torch.stack([vi0, vj0, ti0, tj0, sij0, sji0])
    xl = torch.stack([gd.fr_vm_bound[:, 0], gd.to_vm_bound[:, 0],
                      gd.fr_va_bound[:, 0], gd.to_va_bound[:, 0],
                      -gd.rate_a, -gd.rate_a])
    xu = torch.stack([gd.fr_vm_bound[:, 1], gd.to_vm_bound[:, 1],
                      gd.fr_va_bound[:, 1], gd.to_va_bound[:, 1], zero, zero])
    return x0, xl, xu


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
                  inner_iter: int):
    """The batch's inputs: x0, xl, xu (6, B), params, lam0 (2, B), mu0 (B,)
    and active0 (B,).

    ``inner_iter`` is the 1-based inner-iteration counter: the ALM penalty
    restarts at 10 on the first inner iteration of each outer loop (membuf
    row 27, auglag kernel :81-87); the multipliers warm-start across all
    iterations."""
    alm = sol.branch_alm
    x0, xl, xu = _warm_start_x0(sol.u.line, gd)
    mu0 = torch.full_like(alm.mu, 10.0) if inner_iter == 1 else alm.mu
    lam0 = torch.stack([alm.lam1, alm.lam2])
    return (x0, xl, xu, _branch_params(sol, gd, par), lam0, mu0,
            gd.line_mask > 0.5)


def branch_update(sol: Solution, gd: GridData, par: Parameters,
                  inner_iter: int, use_linelimit: bool = True):
    """Solve all line subproblems; returns (new u line block, new ALM state,
    stats). The stats are tensors (nothing is read back here)."""
    if not use_linelimit:
        raise NotImplementedError(
            "the polar branch form without line limits is not ported yet")
    x0, xl, xu, params, lam0, mu0, active0 = branch_inputs(
        sol, gd, par, inner_iter)
    res = tron_cuda.tron_alm_branch(
        x0, xl, xu, params, lam0, mu0, active0=active0,
        **branch_tolerances(par, x0.dtype))
    new_alm = BranchALMState(lam1=res.lam[0], lam2=res.lam[1], mu=res.mu)

    p = {k: getattr(gd, k) for k in Y_KEYS}
    pij, qij, pji, qji = _flows(res.x, p)
    vi, vj = res.x[0], res.x[1]
    u_new = torch.stack([pij, qij, pji, qji, vi * vi, vj * vj,
                         res.x[2], res.x[3]], dim=-1)
    # padded lanes keep their previous (zero) state
    u_new = torch.where(active0[:, None], u_new, sol.u.line)

    m = gd.line_mask
    stats = {
        "avg_auglag_it": torch.sum(res.alm_iters * m) / gd.nline,
        "avg_minor_it": torch.sum(res.minor_iters * m) / gd.nline,
        "max_cviol": torch.amax(torch.where(active0, res.cviol,
                                            torch.zeros_like(res.cviol))),
    }
    return u_new, new_alm, stats
