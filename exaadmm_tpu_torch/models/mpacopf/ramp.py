"""The ramp generator subproblems of the multi-period model.

Counterpart of ``gen_obj``/``gen_cons`` and of the input assembly in
``exaadmm_tpu/models/mpacopf/model.py::_ramp_alm_update``
(reference mpacopf_auglag_generator_kernel_cpu.jl:18-131). For every period
t >= 2 and generator g one lane solves, over x = (p_t, phat_{t-1}, s_t),

    c2 (B p)^2 + c1 B p + lam_p (p - t_p) + rho_p/2 (p - t_p)^2
    + lam_h (phat - t_h) + rho_h/2 (phat - t_h)^2

with box bounds (pg limits, |s| <= ramp rate) and the equality
c = p - phat - s = 0 under an augmented Lagrangian (B = baseMVA). The lanes
go through ``ops/tron_cuda.py::tron_alm_ramp``; derivatives are closed form
(the JAX package differentiates ``gen_obj`` by autodiff).

Parameters are a dict of (B,) tensors under ``PARAM_KEYS``, the row order of
the kernel's packed (9, B) block. ``ramp_pack_plain`` is the plain version of
the pack kernel of ``ops/mpacopf_cuda.py`` (``mp_ramp_pack``), which writes
that block and the batch's other inputs in one launch on the card.
"""

from __future__ import annotations

import torch

from ...ops import tron_cuda
from ...utils.environment import SolutionMpacopf, on_first_iteration
from ..acopf.branch import branch_tolerances

#: row order of the ramp lane parameters in the packed kernel block
PARAM_KEYS = ("c2", "c1", "lam_p", "rho_p", "t_p", "lam_h", "rho_h", "t_h",
              "baseMVA")


def ramp_obj(x, p, lam, mu):
    """Full ALM objective of the ramp lanes (B,)."""
    pB = x[0] * p["baseMVA"]
    dp = x[0] - p["t_p"]
    dh = x[1] - p["t_h"]
    f = p["c2"] * (pB * pB) + p["c1"] * pB
    f = f + p["lam_p"] * dp + 0.5 * p["rho_p"] * (dp * dp)
    f = f + p["lam_h"] * dh + 0.5 * p["rho_h"] * (dh * dh)
    c = x[0] - x[1] - x[2]
    return f + lam[0] * c + 0.5 * mu * (c * c)


def ramp_cons(x, p):
    """The equality p_t - phat_{t-1} - s_t, as (1, B)."""
    del p
    return (x[0] - x[1] - x[2])[None]


def ramp_fgh(x, p, lam, mu):
    """Closed-form (f, gradient (3, B), Hessian (3, 3, B)) of ``ramp_obj``.

    With kap = lam + mu c and v = (1, -1, -1) = grad c:
      g = (2 c2 B^2 p + c1 B + lam_p + rho_p (p - t_p),
           lam_h + rho_h (phat - t_h), 0) + kap v,
      H = diag(2 c2 B^2 + rho_p, rho_h, 0) + mu v v^T.
    ``csrc/tron_alm_ramp.cu`` repeats these expressions op for op.
    """
    B = p["baseMVA"]
    c = x[0] - x[1] - x[2]
    kap = lam[0] + mu * c
    cB2 = 2.0 * p["c2"] * B * B
    g = torch.stack([
        cB2 * x[0] + p["c1"] * B + p["lam_p"] + p["rho_p"] * (x[0] - p["t_p"])
        + kap,
        p["lam_h"] + p["rho_h"] * (x[1] - p["t_h"]) - kap,
        -kap,
    ])
    H = torch.stack([
        torch.stack([cB2 + p["rho_p"] + mu, -mu, -mu]),
        torch.stack([-mu, p["rho_h"] + mu, mu]),
        torch.stack([-mu, mu, mu]),
    ])
    return ramp_obj(x, p, lam, mu), g, H


#: the ramp batch uses the branch batch's dtype floors (40 eps, 10 eps,
#: 300 eps, 0.1/eps), as the JAX model does (mpacopf/model.py:234-239)
ramp_tolerances = branch_tolerances


def ramp_inputs(sol: SolutionMpacopf, model, inner_iter):
    """The ramp batch of periods 2..T: x0, xl, xu (3, B), params, lam0
    (1, B) and mu0 (B,), lanes ordered period-major (B = (T-1) ngen).

    The ALM penalty restarts at 10 on the first inner iteration of each
    outer loop; the multiplier warm-starts across all iterations."""
    gd = model.grid
    T, ngen = model.T, gd.ngen
    ac, rp = sol.acopf, sol.ramp
    B = (T - 1) * ngen

    def flat(a):  # rows t >= 2 of a (T, ngen) tensor
        return a[1:].reshape(B)

    def tile(a):
        return a.repeat(T - 1)

    params = {
        "c2": tile(model.c2_eff), "c1": tile(model.c1_eff),
        "lam_p": flat(ac.l.gen[..., 0]),
        "rho_p": flat(ac.rho.gen[..., 0]),
        "t_p": flat(ac.v.gen[..., 0] - ac.z.gen[..., 0]),
        "lam_h": flat(rp.l),
        "rho_h": flat(rp.rho),
        # consensus target of phat: the previous period's bus-side pg
        "t_h": ac.v.gen[:-1, :, 0].reshape(B) - flat(rp.z),
        "baseMVA": torch.full_like(flat(rp.l), gd.baseMVA),
    }
    xl = torch.stack([tile(gd.pgmin), tile(gd.pgmin), -tile(gd.ramp_rate)])
    xu = torch.stack([tile(gd.pgmax), tile(gd.pgmax), tile(gd.ramp_rate)])
    x0 = torch.stack([
        torch.clamp(flat(ac.u.gen[..., 0]), min=xl[0], max=xu[0]),
        torch.clamp(flat(rp.u), min=xl[1], max=xu[1]),
        torch.clamp(flat(rp.s), min=xl[2], max=xu[2]),
    ])
    mu0 = on_first_iteration(inner_iter,
                             torch.full_like(params["baseMVA"], 10.0),
                             flat(rp.alm_xi))
    return x0, xl, xu, params, flat(rp.alm_mu)[None], mu0


def ramp_pack_plain(sol: SolutionMpacopf, model, inner_iter):
    """``ramp_inputs`` followed by the pack, in their op order: x0, xl, xu
    (3, B), the (9, B) parameter block in ``PARAM_KEYS`` order, lam0 (1, B),
    mu0 (B,) and the uint8 flags active0 (B,), all ones (every ramp lane
    runs). The plain version of ``mpacopf_cuda.ramp_pack``."""
    x0, xl, xu, params, lam0, mu0 = ramp_inputs(sol, model, inner_iter)
    act = torch.ones(x0.shape[1], dtype=torch.uint8, device=x0.device)
    return x0, xl, xu, tron_cuda.pack_ramp_params(params), lam0, mu0, act
