"""The port's branch subproblem pieces and plain TRON/ALM against JAX.

Tolerances:
- closed-form f/g/H against torch.autograd, fp64: those of the JAX
  package's own test (f rtol 1e-12; g rtol/atol 1e-8; H rtol 1e-7 with an
  atol scaled by the row's largest entry): the closed form and autodiff
  round differently.
- plain TRON against JAX TRON, fp64: both run the same lockstep state
  machine op for op, but sin/cos/pow and XLA's fusion round differently
  from PyTorch's, by ulps. On case9 that must not change any lane's path:
  iteration counts equal on every lane and x within 1e-9. On the
  synthetic 300-bus batch, with more and harder lanes, a rare rounding may
  flip one TRON decision: counts equal on >= 99 % of lanes (the number
  that differ is reported).
- fp32, against the Pallas kernel in interpret mode (tile 256): x within
  1e-5 and equal minor iterations, as the JAX package's own Pallas test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import branch as JB
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.ops.tron import tron_alm_batched as jax_tron
from exaadmm_tpu.ops.tron_pallas import tron_alm_batched_pallas
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.models.acopf import branch as TB
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.ops import tron_cuda
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case


def test_closed_form_fgh_matches_autograd():
    rng = np.random.default_rng(7)
    B = 64
    p = {k: torch.as_tensor(rng.normal(0, 2, B)) for k in TB.Y_KEYS}
    p["l"] = torch.as_tensor(rng.normal(0, 50, (8, B)))
    p["rho"] = torch.as_tensor(rng.uniform(1, 4e4, (8, B)))
    p["t"] = torch.as_tensor(rng.normal(0, 1, (8, B)))
    p["scale"] = torch.as_tensor(rng.uniform(1e-5, 1e-3, B))
    x = torch.as_tensor(np.concatenate([rng.uniform(0.9, 1.1, (2, B)),
                                        rng.uniform(-0.5, 0.5, (2, B)),
                                        rng.uniform(-5, 0, (2, B))]))
    lam = torch.as_tensor(rng.normal(0, 10, (2, B)))
    mu = torch.as_tensor(rng.uniform(1, 1e6, B))

    f, g, H = TB.branch_fgh_linelimit(x, p, lam, mu)
    xg = x.clone().requires_grad_(True)
    f_ad = TB.branch_obj_linelimit(xg, p, lam, mu)
    (g_ad,) = torch.autograd.grad(f_ad.sum(), xg, create_graph=True)
    np.testing.assert_allclose(f.numpy(), f_ad.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_ad.detach().numpy(),
                               rtol=1e-8, atol=1e-8)
    for i in range(6):
        (hi,) = torch.autograd.grad(g_ad[i].sum(), xg, retain_graph=True)
        hi = hi.numpy()   # row i: d g_i / d x_j, lane by lane
        for j in range(6):
            np.testing.assert_allclose(
                H[i][j].numpy(), hi[j], rtol=1e-7,
                atol=1e-7 * (float(np.abs(hi).max()) + 1))


def _batch(case, dtype, seed=0, sigma=0.05):
    """The branch batch of the first inner iteration on both packages, with
    the prox targets perturbed by the same numpy noise."""
    if case == "synth300":
        tdata, jdata = synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)
    else:
        from os.path import dirname, join
        path = join(dirname(dirname(__file__)), "data", case + ".m")
        tdata = opf_loaddata(path, verbose=0)
        jdata = jax_opf_loaddata(path, verbose=0)
    tdt, jdt = ((torch.float64, jnp.float64) if dtype == "f64"
                else (torch.float32, jnp.float32))
    tpar, jpar = Parameters(verbose=0), JParameters(verbose=0)
    tmodel = TM.build_model(tdata, tpar, dtype=tdt)
    jmodel = JM.build_model(jdata, jpar, dtype=jdt)
    tsol = TM.init_solution(tmodel, 4e2, 4e4)
    jsol = JM.init_solution(jmodel, 4e2, 4e4)
    noise = np.random.default_rng(seed).normal(0, sigma, tsol.v.line.shape)
    tsol = tsol.replace(v=tsol.v.replace(
        line=tsol.v.line + torch.as_tensor(noise).to(tdt)))
    jsol = jsol.replace(v=jsol.v.replace(
        line=jsol.v.line + jnp.asarray(noise, jdt)))
    t_in = TB.branch_inputs(tsol, tmodel.grid, tpar, 1)
    jx0, jxl, jxu = JB._warm_start_x0(jsol.u.line, jmodel.grid, True)
    jp = JB._branch_params(jsol, jmodel.grid, jpar)
    jlam0 = jnp.stack([jsol.branch_alm.lam1, jsol.branch_alm.lam2])
    jmu0 = jnp.full_like(jsol.branch_alm.mu, 10.0)
    return t_in, (jx0, jxl, jxu, jp, jlam0, jmu0), tpar


def _tolerances(dtype):
    eps = float(np.finfo(np.float64 if dtype == "f64" else np.float32).eps)
    return dict(gtol=max(1e-6, 40 * eps), frtol=max(1e-12, 10 * eps),
                ctol=max(1e-6, 300 * eps), mu_max=min(1e8, 0.1 / eps),
                max_minor=200, max_auglag=50)


def test_branch_inputs_match_jax():
    (x0, xl, xu, p, lam0, mu0, act), (jx0, jxl, jxu, jp, jlam0, jmu0), _ = \
        _batch("case9", "f64")
    for a, b in ((x0, jx0), (xl, jxl), (xu, jxu), (lam0, jlam0), (mu0, jmu0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    assert bool(act.all())


@pytest.mark.parametrize("case,min_agree", [("case9", 1.0),
                                            ("synth300", 0.99)])
def test_plain_tron_matches_jax_fp64(case, min_agree):
    t_in, j_in, _ = _batch(case, "f64")
    x0, xl, xu, p, lam0, mu0, act = t_in
    opts = _tolerances("f64")
    rt = tron_cuda.tron_alm_branch(x0, xl, xu, p, lam0, mu0, active0=act,
                                   **opts)
    jx0, jxl, jxu, jp, jlam0, jmu0 = j_in
    rj = jax.jit(lambda *a: jax_tron(
        JB.branch_obj_linelimit, JB.branch_cons_linelimit, *a,
        fgh_fn=JB.branch_fgh_linelimit, alm_delta_fn=JB.branch_alm_delta,
        **opts))(jx0, jxl, jxu, jp, jlam0, jmu0)
    same = ((rt.minor_iters.numpy() == np.asarray(rj.minor_iters))
            & (rt.alm_iters.numpy() == np.asarray(rj.alm_iters)))
    n_diff = int((~same).sum())
    print(f"{case}: {n_diff} of {same.size} lanes differ in iteration counts")
    assert same.mean() >= min_agree, n_diff
    dx = np.abs(rt.x.numpy() - np.asarray(rj.x)).max(axis=0)
    assert dx[same].max() <= 1e-9, dx[same].max()
    np.testing.assert_allclose(rt.lam.numpy()[:, same],
                               np.asarray(rj.lam)[:, same], rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_array_equal(rt.mu.numpy()[same], np.asarray(rj.mu)[same])


def test_plain_tron_fp32_matches_pallas_interpret():
    t_in, j_in, _ = _batch("case9", "f32", sigma=0.0)
    x0, xl, xu, p, lam0, mu0, act = t_in
    opts = dict(gtol=40 * float(np.finfo(np.float32).eps),
                frtol=10 * float(np.finfo(np.float32).eps),
                ctol=300 * float(np.finfo(np.float32).eps),
                mu_max=1e8, max_minor=200, max_auglag=50)
    rt = tron_cuda.tron_alm_branch(x0, xl, xu, p, lam0, mu0, active0=act,
                                   **opts)
    jx0, jxl, jxu, jp, jlam0, jmu0 = j_in
    rp = tron_alm_batched_pallas(
        JB.branch_obj_linelimit, JB.branch_cons_linelimit,
        jx0, jxl, jxu, jp, jlam0, jmu0, tile=256, interpret=True, **opts)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rp.x), atol=1e-5)
    np.testing.assert_array_equal(rt.minor_iters.numpy(),
                                  np.asarray(rp.minor_iters))


def test_padded_lanes_come_back_untouched():
    (x0, xl, xu, p, lam0, mu0, act), _, _ = _batch("case9", "f64")
    act = act.clone()
    act[::3] = False
    r = tron_cuda.tron_alm_branch(x0, xl, xu, p, lam0, mu0, active0=act,
                                  **_tolerances("f64"))
    off = ~act
    assert torch.equal(r.x[:, off], x0[:, off])
    assert torch.equal(r.lam[:, off], lam0[:, off])
    assert torch.equal(r.mu[off], mu0[off])
    assert int(r.minor_iters[off].abs().sum()) == 0
    assert int(r.alm_iters[off].abs().sum()) == 0
    assert bool(torch.isinf(r.cviol[off]).all())
    assert bool((r.minor_iters[act] > 0).all())


def test_step_cap_bounds_every_lane():
    (x0, xl, xu, p, lam0, mu0, act), _, _ = _batch("synth300", "f64")
    opts = _tolerances("f64")
    full = tron_cuda.tron_alm_branch(x0, xl, xu, p, lam0, mu0, active0=act,
                                     **opts)
    capped = tron_cuda.tron_alm_branch(x0, xl, xu, p, lam0, mu0, active0=act,
                                       step_cap=6, **opts)
    steps = capped.minor_iters + capped.alm_iters
    assert int(capped.minor_iters.max()) <= 6
    # lanes that finish within the cap take the same path as without it
    done = (full.minor_iters + full.alm_iters <= 6).numpy()
    assert done.any()
    assert torch.equal(capped.x[:, done], full.x[:, done])
    assert int(steps.max()) <= 12
