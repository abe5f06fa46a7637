"""The port's branch path without line limits against the JAX package's.

The JAX package solves each line's 4-variable polar problem with
``tron_batched`` over ``branch_obj_polar``, its derivatives by autodiff;
the port has the closed form ``branch_fgh_polar`` and runs the same TRON
body with no constraints (the plain version here, ``csrc/tron_alm_polar.cu``
on the card).

Tolerances:
- f, g and H of ``branch_fgh_polar`` against ``jax.value_and_grad`` and
  ``jax.hessian`` of the JAX ``branch_obj_polar`` on 64 seeded lanes: 1e-12
  relative to each quantity's largest magnitude (the two round in other
  orders).
- the plain polar batch against JAX ``tron_batched`` on the 510 lines of a
  synthetic 300-bus grid, prox targets perturbed from a numpy seed: equal
  minor iterations on >= 99.5 % of lanes and |dx| <= 1e-8 on those lanes
  (closed form and autodiff may round a TRON decision differently).
- the 4-row warm start: equal to 1e-15 relative (the square roots of
  the two libraries may differ in the last bit).
- the case9 solve: the JAX package's own result, Solved in 20 outer / 973
  inner, objective within 1e-8 relative of 5286.651807890947.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaadmm_tpu_torch
from exaadmm_tpu.models.acopf import branch as JB
from exaadmm_tpu.ops.tron import tron_batched
from exaadmm_tpu.utils.grid_data import build_grid_data as jax_grid
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.models.acopf import branch as TB
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.ops import tron_cuda
from exaadmm_tpu_torch.ops.tron import tron_alm_batched
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from .test_torch_threads import one_torch_thread  # noqa: F401

PIN_OUTER, PIN_CUMUL, PIN_OBJ = 20, 973, 5286.651807890947


def _lanes(B=64, seed=0):
    """Seeded lanes of the polar problem, as numpy: x (4, B) and params."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0.9, 1.1, B), rng.uniform(0.9, 1.1, B),
                  rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B)])
    p = {k: rng.normal(0.0, 5.0, B) for k in TB.Y_KEYS}
    p.update(l=rng.normal(0.0, 10.0, (8, B)),
             rho=rng.uniform(1e2, 1e5, (8, B)), t=rng.normal(0.0, 1.0, (8, B)),
             scale=np.full(B, 1e-4))
    return x, p


def test_fgh_polar_matches_jax_autodiff():
    x, p = _lanes()
    tx = torch.as_tensor(x)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    f, g, H = TB.branch_fgh_polar(tx, tp)

    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def one(xl, pl):
        return JB.branch_obj_polar(
            xl[:, None], jax.tree.map(lambda a: a[..., None], pl))[0]

    jf, jg = jax.vmap(jax.value_and_grad(one), in_axes=(1, -1))(
        jnp.asarray(x), jp)
    jH = jax.vmap(jax.hessian(one), in_axes=(1, -1))(jnp.asarray(x), jp)
    for got, ref, name in ((f.numpy(), np.asarray(jf), "f"),
                           (g.numpy(), np.asarray(jg).T, "g"),
                           (H.numpy(), np.moveaxis(np.asarray(jH), 0, -1),
                            "H")):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max(),
                                   err_msg=name)
    # the objective alone, as the ratio test evaluates it
    np.testing.assert_allclose(TB.branch_obj_polar(tx, tp).numpy(),
                               np.asarray(jf), rtol=1e-13)


def test_tron_without_constraints_runs_one_round():
    """A (0, B) multiplier block: one ALM round finds ||c|| = 0 and ends
    every lane; lam keeps its shape, mu its value."""
    x, p = _lanes(B=8)
    tx = torch.as_tensor(x)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    lo, hi = tx - 0.2, tx + 0.2
    res = tron_alm_batched(
        lambda xx, pp, lam, mu: TB.branch_obj_polar(xx, pp),
        TB.branch_cons_polar, TB.branch_fgh_polar, tx, lo, hi, tp,
        tx.new_zeros((0, 8)), tx.new_full((8,), 10.0), max_auglag=1)
    assert res.lam.shape == (0, 8)
    assert torch.equal(res.alm_iters, torch.ones(8, dtype=torch.int32))
    assert torch.equal(res.cviol, torch.zeros(8, dtype=torch.float64))
    assert torch.equal(res.mu, torch.full((8,), 10.0, dtype=torch.float64))
    assert bool((res.minor_iters > 0).all())


@pytest.fixture(scope="module")
def synth300_polar():
    """The port's polar batch of synthetic 300 buses at its first inner
    iteration, prox targets perturbed by N(0, 0.05)."""
    data = synthetic_case(300, seed=0)
    par = Parameters(verbose=0)
    model = TM.build_model(data, par)
    sol = TM.init_solution(model, 4e2, 4e4)
    rng = np.random.default_rng(0)
    sol = sol.replace(v=sol.v.replace(line=sol.v.line + torch.as_tensor(
        rng.normal(0, 0.05, tuple(sol.v.line.shape)))))
    return model, par, TB.polar_inputs(sol, model.grid, par)


def test_warm_start_matches_jax(synth300_polar):
    model, _, (x0, xl, xu, *_rest) = synth300_polar
    jgd = jax_grid(jax_synthetic_case(300, seed=0))
    u = np.random.default_rng(3).normal(0.5, 0.3, (model.grid.nline_padded, 8))
    got = TB._warm_start_x0(torch.as_tensor(u), model.grid,
                            use_linelimit=False)
    ref = JB._warm_start_x0(jnp.asarray(u), jgd, False)
    for a, b in zip(got, ref):
        assert a.shape == (4, model.grid.nline_padded)
        # equal but for the last bit of a square root
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                   atol=0)
    assert x0.shape == xl.shape == xu.shape == (4, model.grid.nline_padded)


def test_polar_batch_matches_jax_tron_batched(synth300_polar):
    model, par, (x0, xl, xu, params, lam0, mu0, act) = synth300_polar
    opts = TB.polar_tolerances(par, torch.float64)
    assert opts["max_auglag"] == 1 and lam0.shape == (0, x0.shape[1])
    got = tron_cuda.tron_alm_polar(x0, xl, xu, params, lam0, mu0,
                                   active0=act, **opts)
    ref = tron_batched(
        JB.branch_obj_polar, *(jnp.asarray(a.numpy()) for a in (x0, xl, xu)),
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        gtol=opts["gtol"], frtol=opts["frtol"], max_minor=opts["max_minor"],
        step_cap=opts["step_cap"], active0=jnp.asarray(act.numpy()))
    a = act.numpy()
    mk = got.minor_iters.numpy()[a]
    mj = np.asarray(ref.minor_iters)[a]
    same = mk == mj
    assert same.mean() >= 0.995, f"{(~same).sum()} lanes differ"
    dx = np.abs(got.x.numpy() - np.asarray(ref.x)).max(axis=0)[a]
    assert dx[same].max() <= 1e-8
    assert np.array_equal(got.alm_iters.numpy()[a], np.asarray(ref.alm_iters)[a])
    assert float(got.cviol[act].abs().max()) == 0.0
    assert mk.max() > 1


def test_case9_without_line_limits_hits_the_pins(case9_path):
    res = exaadmm_tpu_torch.solve_acopf(
        case9_path, rho_pq=4e2, rho_va=4e4, outer_eps=2e-4, outer_iterlim=25,
        use_linelimit=False, verbose=0, device="cpu")
    info = res.info
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (PIN_OUTER, PIN_CUMUL)
    assert abs(info.objval - PIN_OBJ) / PIN_OBJ < 1e-8
    assert info.max_cviol == 0.0
    # no ALM state moves without line limits
    assert torch.equal(res.solution.branch_alm.lam1,
                       torch.zeros_like(res.solution.branch_alm.lam1))
    assert res.env.use_linelimit is False
