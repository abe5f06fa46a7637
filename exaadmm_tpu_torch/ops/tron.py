"""Batched trust-region Newton (TRON) inside an augmented Lagrangian: the
plain PyTorch version.

Counterpart of ``exaadmm_tpu/ops/tron.py::tron_alm_batched``, and the plain
version that the branch kernel ``csrc/tron_alm_branch.cu`` is checked
against. B independent bound-constrained problems advance in lockstep
through one state machine; each lane carries its own phase (TRON step, ALM
round, done), and the loop runs until every lane has finished or
``step_cap`` steps have run. A lane's trajectory does not depend on the
other lanes, which is what lets the kernel run each lane on its own group of
threads instead.

Layout: iterates are (n, B), Hessians (n, n, B), parameters (..., B).
Reductions over the n rows run in row order, one add at a time, so the
kernel can repeat them operation for operation.

Per lane (Lin & More's TRON as used by ExaTron):
  - Cauchy point along the projected gradient with sufficient decrease
    (mu0 = 0.01, interpolation x0.1 / extrapolation x10, warm-started step),
  - Newton step on the free variables by shifted dense Cholesky, clipped to
    the trust region, then a projected backtracking search,
  - ratio test and radius update (eta0=1e-4, eta1=0.25, eta2=0.75,
    sigma1=0.25, sigma2=0.5, sigma3=4),
  - TRON stops on projected-gradient inf-norm <= gtol, relative function
    reduction <= frtol, or the minor-iteration cap,
  - then an ALM round at the new x: lambda += mu*c when ||c||_inf <= eta
    (eta /= mu^0.9), else mu = min(10*mu, mu_max) with eta = mu^-0.1; the lane
    finishes when ||c||_inf <= ctol (nested under the eta test) or at the
    round cap.

Derivatives come from a closed-form ``fgh_fn``; there is no autodiff path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# TRON constants (Lin & More)
_MU0 = 0.01       # sufficient decrease for Cauchy/projected searches
_INTERPF = 0.1
_EXTRAPF = 10.0
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CAUCHY_ITERS = 22
_EXTRAP_ITERS = 10
_PRSRCH_ITERS = 20
# Newton shift ladder, in units of max(max_i |H_ii|, 1); shift 0 comes first
_SHIFTS = (0.0, 1e-10, 1e-6, 1e-3, 1.0, 1e3)


class TronALMResult(NamedTuple):
    x: torch.Tensor            # (n, B) final iterates
    lam: torch.Tensor          # (ncon, B) ALM multipliers
    mu: torch.Tensor           # (B,) ALM penalties
    minor_iters: torch.Tensor  # (B,) int32 total TR iterations
    alm_iters: torch.Tensor    # (B,) int32 ALM rounds taken
    cviol: torch.Tensor        # (B,) final constraint inf-norm


def _rowsum(p):
    """p[0] + p[1] + ... in row order."""
    acc = p[0]
    for i in range(1, p.shape[0]):
        acc = acc + p[i]
    return acc


def _dot(a, b):
    return _rowsum(a * b)


def _norm2(s):
    return torch.sqrt(_dot(s, s))


def _hmatvec(H, s):
    """(H s)_i = H[i][0] s[0] + H[i][1] s[1] + ... in column order."""
    acc = H[:, 0] * s[0]
    for j in range(1, H.shape[1]):
        acc = acc + H[:, j] * s[j]
    return acc


def _gp_norm_inf(x, g, xl, xu):
    gp = torch.where(x <= xl, torch.clamp_max(g, 0.0), g)
    gp = torch.where(x >= xu, torch.clamp_min(gp, 0.0), gp)
    return torch.amax(torch.abs(gp), dim=0)


def _chol_solve(H, rhs, tau):
    """Solve (H + tau I) d = rhs per lane by dense Cholesky.

    Returns (d, ok); ok marks lanes whose pivots all stayed positive (d is
    meaningless elsewhere). Every entry sees its updates in the order of
    the reference's unrolled loops."""
    n = H.shape[0]
    L = torch.zeros_like(H)
    inv_diag = torch.empty_like(rhs)
    ok = torch.ones(rhs.shape[1], dtype=torch.bool, device=rhs.device)
    for j in range(n):
        s = H[j, j] + tau
        for k in range(j):
            s = s - L[j, k] * L[j, k]
        ok = ok & (s > 0)
        inv_piv = 1.0 / torch.sqrt(torch.where(s > 0, s, torch.ones_like(s)))
        inv_diag[j] = inv_piv
        if j + 1 < n:
            t = H[j + 1:, j]
            for k in range(j):
                t = t - L[j + 1:, k] * L[j, k]
            L[j + 1:, j] = t * inv_piv
    # forward substitution, column by column (each y_i still sees its terms
    # in ascending k)
    r = rhs.clone()
    y = torch.empty_like(rhs)
    for k in range(n):
        y[k] = r[k] * inv_diag[k]
        if k + 1 < n:
            r[k + 1:] = r[k + 1:] - L[k + 1:, k] * y[k]
    d = torch.empty_like(rhs)
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k, i] * d[k]
        d[i] = t * inv_diag[i]
    return d, ok


def _newton_dir(Hm, rhs, skip):
    """Smallest-shift Newton direction: shift 0, then the ladder
    ``_SHIFTS[1:]`` times max(max_i |Hm_ii|, 1) until the factorization
    succeeds. The step is 0 where no shift factorizes. ``skip`` marks lanes
    whose result is not used (they end the ladder early)."""
    n = Hm.shape[0]
    diag = torch.stack([torch.abs(Hm[i, i]) for i in range(n)])
    dmax = torch.clamp_min(torch.amax(diag, dim=0), 1.0)
    d, ok = _chol_solve(Hm, rhs, torch.zeros_like(dmax))
    d = torch.where(ok, d, torch.zeros_like(d))
    solved = ok
    for lvl in _SHIFTS[1:]:
        if bool((solved | skip).all()):
            break
        cand, ok = _chol_solve(Hm, rhs, dmax * lvl)
        d = torch.where(ok & ~solved, cand, d)
        solved = solved | ok
    return d, solved


def tron_alm_batched(
    obj_fn: Callable,    # (x (n,B), params, lam (ncon,B), mu (B,)) -> (B,)
    cons_fn: Callable,   # (x (n,B), params) -> (ncon, B)
    fgh_fn: Callable,    # (x, params, lam, mu) -> (f, g (n,B), H (n,n,B))
    x0: torch.Tensor,    # (n, B)
    xl: torch.Tensor,
    xu: torch.Tensor,
    params,              # dict of (..., B) tensors, passed to the callables
    lam0: torch.Tensor,  # (ncon, B)
    mu0: torch.Tensor,   # (B,)
    *,
    gtol: float = 1e-6,
    frtol: float = 1e-12,
    ctol: float = 1e-6,
    mu_max: float = 1e8,
    max_minor: int = 200,
    max_auglag: int = 50,
    step_cap: int | None = None,
    active0: torch.Tensor | None = None,
    alm_delta_fn: Callable | None = None,
) -> TronALMResult:
    """Solve B independent bound-constrained ALM problems in lockstep.

    ``obj_fn`` is the full augmented objective (base + lam.c + mu/2 |c|^2);
    it gives the function values of the ratio test. ``fgh_fn`` gives the
    gradient and Hessian (its f is not used). ``alm_delta_fn(c, lam_old,
    mu_old, lam_new, mu_new, params)`` gives the exact objective change of
    an ALM update at fixed x (the objective is affine in lam and mu); with
    None the objective is evaluated afresh at the new lam and mu.
    Lanes with ``active0`` False come back untouched.
    """
    n, B = x0.shape
    dev = x0.device
    if step_cap is None:
        step_cap = max_minor * max_auglag

    def proj(y):
        return torch.clamp(y, min=xl, max=xu)

    def tr_step(x, f, g, H, delta, alpha_c, lam, mu, stepping):
        skip = ~stepping

        def qval(s):
            return _dot(g, s) + 0.5 * _dot(s, _hmatvec(H, s))

        def s_of(a):
            return proj(x - a * g) - x

        def cauchy_ok(a):
            s = s_of(a)
            return (_norm2(s) <= delta) & (qval(s) <= _MU0 * _dot(g, s))

        # --- Cauchy point (dcauchy), warm-started step ---
        a0 = torch.clamp_min(alpha_c, 1e-30)
        need = ~cauchy_ok(a0)
        factor = torch.full_like(a0, _EXTRAPF).masked_fill_(need, _INTERPF)
        # interpolation lanes keep every trial (the last one even at the
        # cap) and stop at the first acceptable one; extrapolation lanes
        # keep the last acceptable trial and stop at the first failure, at
        # 1e12, or after _EXTRAP_ITERS trials
        alpha = a0
        cand = a0
        stop = skip
        k = 0
        while k < _CAUCHY_ITERS and not bool(stop.all()):
            cand = cand * factor
            ok = cauchy_ok(cand)
            good_e = ok & (cand < 1e12)
            take = ~stop & torch.where(need, torch.ones_like(ok), good_e)
            alpha = torch.where(take, cand, alpha)
            stop = torch.where(need, stop | ok,
                               stop | ~good_e | (k + 1 >= _EXTRAP_ITERS))
            k += 1
        sc = s_of(alpha)
        xc = x + sc

        # --- Newton direction on the free variables ---
        free = (xc > xl) & (xc < xu)
        Hsc = _hmatvec(H, sc)
        gc = g + Hsc
        gf = torch.where(free, gc, torch.zeros_like(gc))
        freef = free.to(x.dtype)
        Hm = H * freef[:, None, :] * freef[None, :, :]
        eye = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]
        Hm = Hm + torch.where(eye, (1.0 - freef)[:, None, :],
                              torch.zeros_like(Hm))
        d, solved = _newton_dir(Hm, -gf, skip)
        d = torch.where(free & solved, d, torch.zeros_like(d))

        # clip the combined step to the trust region (dtrqsol)
        dd = _dot(d, d)
        sd = _dot(sc, d)
        ss = _dot(sc, sc)
        rad = torch.clamp_min(sd * sd + dd * (delta * delta - ss), 0.0)
        safe_dd = torch.where(dd > 0, dd, torch.ones_like(dd))
        tau = torch.where(
            dd > 0, torch.clamp_max((torch.sqrt(rad) - sd) / safe_dd, 1.0),
            torch.zeros_like(dd))
        d = d * torch.clamp_min(tau, 0.0)

        # --- projected backtracking from xc along d (dprsrch) ---
        q_c = _dot(g, sc) + 0.5 * _dot(sc, Hsc)
        aw = torch.ones_like(f)
        s_best = sc
        found = skip
        k = 0
        while k < _PRSRCH_ITERS and not bool(found.all()):
            s_try = proj(xc + aw * d) - x
            decr = qval(s_try) <= q_c + _MU0 * torch.clamp_max(
                _dot(gc, s_try - sc), 0.0)
            s_best = torch.where(decr & ~found, s_try, s_best)
            found = found | decr
            aw = aw * 0.5
            k += 1
        s = torch.where(found, s_best, sc)

        # --- ratio test and radius update (dtron) ---
        xt = x + s
        ft = obj_fn(xt, params, lam, mu)
        predred = -qval(s)
        actred = f - ft
        gts = _dot(g, s)
        snorm = _norm2(s)

        denom = ft - f - gts
        one = torch.ones_like(denom)
        alpha_q = torch.where(
            denom <= 0.0, torch.full_like(denom, _SIGMA3),
            torch.clamp_min(-0.5 * gts / torch.where(denom == 0, one, denom),
                            _SIGMA1))
        safe_pred = torch.where(predred != 0.0, predred, one)
        ratio = torch.where(predred > 0.0, actred / safe_pred,
                            torch.zeros_like(predred))

        aqs = alpha_q * snorm
        delta_new = torch.where(
            ratio <= _ETA0,
            torch.minimum(torch.clamp_min(alpha_q, _SIGMA1) * snorm,
                          _SIGMA2 * delta),
            torch.where(
                ratio < _ETA1,
                torch.maximum(_SIGMA1 * delta,
                              torch.minimum(aqs, _SIGMA2 * delta)),
                torch.where(
                    ratio < _ETA2,
                    torch.maximum(_SIGMA1 * delta,
                                  torch.minimum(aqs, _SIGMA3 * delta)),
                    torch.maximum(delta, torch.minimum(aqs, _SIGMA3 * delta)),
                ),
            ),
        )
        delta_new = torch.clamp_min(delta_new, 1e-30)

        accept = ratio > _ETA0
        x_new = torch.where(accept, xt, x)
        f_new = torch.where(accept, ft, f)
        frtol_conv = (predred <= frtol * torch.abs(f)) | (
            accept & (actred <= frtol * torch.abs(f)))
        return x_new, f_new, delta_new, alpha, frtol_conv

    x = x0
    lam = lam0
    mu = mu0
    f = obj_fn(x0, params, lam0, mu0)
    delta = torch.zeros_like(f)
    alpha_c = torch.ones_like(f)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    tron_it = zeros_i
    alm_it = zeros_i
    minor_total = zeros_i
    tron_done = torch.zeros(B, dtype=torch.bool, device=dev)
    need_init = torch.ones(B, dtype=torch.bool, device=dev)
    eta = 1.0 / mu0 ** 0.1
    active = (torch.ones(B, dtype=torch.bool, device=dev) if active0 is None
              else active0.clone())
    cviol = torch.full_like(f, float("inf"))

    steps = 0
    while steps < step_cap and bool(active.any()):
        steps += 1
        _, g, H = fgh_fn(x, params, lam, mu)

        delta = torch.where(need_init, torch.clamp_min(_norm2(g), 1e-12), delta)
        alpha_c = torch.where(need_init, torch.ones_like(alpha_c), alpha_c)

        tron_conv = _gp_norm_inf(x, g, xl, xu) <= gtol
        open_ = active & ~tron_done
        stepping = open_ & ~tron_conv & (tron_it < max_minor)
        newly_done = open_ & (tron_conv | (tron_it >= max_minor))

        frtol_conv = torch.zeros_like(stepping)
        if bool(stepping.any()):
            x2, f2, delta2, ac2, frtol_conv = tr_step(
                x, f, g, H, delta, alpha_c, lam, mu, stepping)
            x = torch.where(stepping, x2, x)
            f = torch.where(stepping, f2, f)
            delta = torch.where(stepping, delta2, delta)
            alpha_c = torch.where(stepping, ac2, alpha_c)
        tron_it = tron_it + stepping.to(torch.int32)
        minor_total = minor_total + stepping.to(torch.int32)
        need_init = need_init & ~stepping
        tron_done = tron_done | newly_done | (stepping & frtol_conv)

        # --- ALM round, at the new x, for lanes whose TRON solve finished ---
        do_alm = active & tron_done
        if not bool(do_alm.any()):
            continue
        c = cons_fn(x, params)
        cnorm = torch.amax(torch.abs(c), dim=0)
        good = cnorm <= eta
        line_solved = good & (cnorm <= ctol)

        upd_lam = do_alm & good & ~line_solved
        lam_new = torch.where(upd_lam, lam + mu * c, lam)
        eta = torch.where(upd_lam, eta / mu ** 0.9, eta)
        upd_mu = do_alm & ~good
        mu_new = torch.where(upd_mu, torch.clamp_max(mu * 10.0, mu_max), mu)
        eta = torch.where(upd_mu, 1.0 / mu_new ** 0.1, eta)

        alm_it = alm_it + do_alm.to(torch.int32)
        finished = do_alm & (line_solved | (alm_it >= max_auglag))
        active = active & ~finished
        restart = do_alm & ~finished
        tron_done = tron_done & ~restart
        tron_it = torch.where(restart, zeros_i, tron_it)
        need_init = need_init | restart
        if alm_delta_fn is None:
            f_fresh = obj_fn(x, params, lam_new, mu_new)
        else:
            f_fresh = f + alm_delta_fn(c, lam, mu, lam_new, mu_new, params)
        f = torch.where(restart, f_fresh, f)
        cviol = torch.where(do_alm, cnorm, cviol)
        lam, mu = lam_new, mu_new

    return TronALMResult(x=x, lam=lam, mu=mu, minor_iters=minor_total,
                         alm_iters=alm_it, cviol=cviol)
