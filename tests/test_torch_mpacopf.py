"""The port's multi-period model and ramp subproblems against the JAX ones.

Case9 with the in-repo demand series (``data/case9_demand.*``), T = 3, fp64
unless stated; inputs from numpy seeds go to both packages as numpy arrays.

Tolerances:
- ramp f/g/H, closed form against torch.autograd of ``ramp_obj`` and
  against jax.grad / jax.jvp of a copy of the JAX model's ``gen_obj``:
  1e-12 relative to each array's largest magnitude (the closed form and
  autodiff round differently, by ulps).
- plain ramp TRON against JAX ``tron_alm_batched`` (autodiff derivatives,
  the objective evaluated afresh after each ALM round), fp64: iteration
  counts equal on every lane and x within 1e-9.
- the same in fp32 against the Pallas kernel in interpret mode: x within
  1e-5, as the JAX package's own Pallas test.
- ``ops/tron.py`` with ``alm_delta_fn=None`` on the branch batch against
  JAX's fresh-evaluation path: counts equal, x within 1e-9.
- one inner iteration hook by hook, each port hook fed the JAX hook's input
  state: every block and the ramp state within 1e-9 absolute, the scalars
  within 1e-9 relative (the branch and ramp solves agree to ~1e-12; the
  margin covers sin/cos/pow rounding that differs between the libraries).
- the bus update over T periods: bit-identical to T single-period calls
  (the folded scatter adds each column in the same order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import branch as JB
from exaadmm_tpu.models.mpacopf import model as JMP
from exaadmm_tpu.ops.tron import tron_alm_batched as jax_tron
from exaadmm_tpu.ops.tron_pallas import tron_alm_batched_pallas
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.models.acopf import branch as TB
from exaadmm_tpu_torch.models.acopf import kernels as TK
from exaadmm_tpu_torch.models.acopf import model as TAM
from exaadmm_tpu_torch.models.mpacopf import model as TMP
from exaadmm_tpu_torch.models.mpacopf import ramp as TR
from exaadmm_tpu_torch.ops import tron_cuda
from exaadmm_tpu_torch.ops.tron import tron_alm_batched
from exaadmm_tpu_torch.utils.convert import (mpacopf_solution_from_numpy,
                                             mpacopf_solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import (SOLUTION_BLOCKS, Blocks,
                                                 BranchALMState, Parameters,
                                                 Solution)
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import (synthetic_case,
                                               synthetic_load_profile)

from .test_torch_tron import _batch, _tolerances
from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE9 = os.path.join(ROOT, "data", "case9.m")
DEMAND = os.path.join(ROOT, "data", "case9_demand")
RHO_PQ, RHO_VA, BETA, T = 4e2, 4e4, 1e3, 3


def jax_gen_obj(x, p, lam, mu):
    """A copy of ``gen_obj`` of exaadmm_tpu/models/mpacopf/model.py."""
    f = p["c2"] * (x[0] * p["baseMVA"]) ** 2 + p["c1"] * (x[0] * p["baseMVA"])
    f = f + p["lam_p"] * (x[0] - p["t_p"]) + 0.5 * p["rho_p"] * (x[0] - p["t_p"]) ** 2
    f = f + p["lam_h"] * (x[1] - p["t_h"]) + 0.5 * p["rho_h"] * (x[1] - p["t_h"]) ** 2
    c = x[0] - x[1] - x[2]
    return f + lam[0] * c + 0.5 * mu * c * c


def jax_gen_cons(x, p):
    """A copy of ``gen_cons`` of exaadmm_tpu/models/mpacopf/model.py."""
    del p
    return jnp.stack([x[0] - x[1] - x[2]])


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def _models(case="case9", dtype="f64"):
    tdt, jdt = ((torch.float64, jnp.float64) if dtype == "f64"
                else (torch.float32, jnp.float32))
    if case == "case9":
        tdata, jdata = opf_loaddata(CASE9, verbose=0), jax_opf_loaddata(
            CASE9, verbose=0)
        pd, qd = load_time_series(DEMAND)
    else:
        tdata, jdata = synthetic_case(300, seed=3), jax_synthetic_case(300,
                                                                      seed=3)
        pd, qd = synthetic_load_profile(tdata, T, seed=1)
    tm = TMP.build_model(tdata, Parameters(verbose=0), pd, qd,
                         start_period=1, end_period=T, dtype=tdt)
    jm = JMP.build_model(jdata, JParameters(verbose=0), pd, qd,
                         start_period=1, end_period=T, dtype=jdt)
    return tm, jm


def _ramp_batch(case, dtype, seed=0):
    """The port's ramp batch of the first inner iteration, with the
    generator prox targets perturbed from a numpy seed."""
    tm, _ = _models(case, dtype)
    sol = TMP.init_solution(tm, RHO_PQ, RHO_VA)
    noise = np.random.default_rng(seed).normal(0, 0.05, sol.acopf.v.gen.shape)
    v = sol.acopf.v
    sol = sol.replace(acopf=sol.acopf.replace(v=v.replace(
        gen=v.gen + torch.as_tensor(noise).to(v.gen.dtype))))
    return TR.ramp_inputs(sol, tm, 1), TR.ramp_tolerances(tm.par,
                                                         v.gen.dtype)


def _to_jax(batch):
    x0, xl, xu, p, lam0, mu0 = batch
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return j(x0), j(xl), j(xu), {k: j(v) for k, v in p.items()}, j(lam0), j(mu0)


def test_ramp_fgh_matches_autograd_and_jax():
    rng = np.random.default_rng(11)
    B = 64
    p = {"c2": rng.uniform(0.01, 0.12, B), "c1": rng.uniform(1, 10, B),
         "lam_p": rng.normal(0, 100, B), "rho_p": rng.uniform(4e2, 4e4, B),
         "t_p": rng.normal(0, 1, B), "lam_h": rng.normal(0, 100, B),
         "rho_h": rng.uniform(4e2, 4e4, B), "t_h": rng.normal(0, 1, B),
         "baseMVA": np.full(B, 100.0)}
    x = rng.normal(0, 1, (3, B))
    lam = rng.normal(0, 50, (1, B))
    mu = rng.uniform(10, 1e6, B)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tx, tlam, tmu = (torch.as_tensor(a) for a in (x, lam, mu))
    f, g, H = TR.ramp_fgh(tx, tp, tlam, tmu)

    xg = tx.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(TR.ramp_obj(xg, tp, tlam, tmu).sum(), xg,
                                  create_graph=True)
    H_ad = np.stack([torch.autograd.grad(g_ad[i].sum(), xg,
                                         retain_graph=True)[0].numpy()
                     for i in range(3)])

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx, jlam, jmu = jnp.asarray(x), jnp.asarray(lam), jnp.asarray(mu)
    grad_fn = jax.grad(lambda X: jnp.sum(jax_gen_obj(X, jp, jlam, jmu)))
    H_jax = np.stack([np.asarray(jax.jvp(
        grad_fn, (jx,), (jnp.zeros_like(jx).at[j].set(1.0),))[1])
        for j in range(3)], axis=1)

    for ref_f, ref_g, ref_H in ((TR.ramp_obj(tx, tp, tlam, tmu).numpy(),
                                 g_ad.detach().numpy(), H_ad),
                                (np.asarray(jax_gen_obj(jx, jp, jlam, jmu)),
                                 np.asarray(grad_fn(jx)), H_jax)):
        _close(f.numpy(), ref_f, 1e-12)
        for i in range(3):
            _close(g[i].numpy(), ref_g[i], 1e-12)
            _close(H[i].numpy(), ref_H[i], 1e-12)


@pytest.mark.parametrize("case", ["case9", "synth300"])
def test_plain_ramp_tron_matches_jax_fp64(case):
    batch, opts = _ramp_batch(case, "f64")
    rt = tron_cuda.tron_alm_ramp(*batch, **opts)
    rj = jax.jit(lambda *a: jax_tron(jax_gen_obj, jax_gen_cons, *a,
                                     **opts))(*_to_jax(batch))
    np.testing.assert_array_equal(rt.minor_iters.numpy(),
                                  np.asarray(rj.minor_iters))
    np.testing.assert_array_equal(rt.alm_iters.numpy(),
                                  np.asarray(rj.alm_iters))
    assert int(rt.minor_iters.sum()) > 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_array_equal(rt.mu.numpy(), np.asarray(rj.mu))


def test_plain_ramp_tron_fp32_matches_pallas_interpret():
    batch, opts = _ramp_batch("case9", "f32")
    rt = tron_cuda.tron_alm_ramp(*batch, **opts)
    rp = tron_alm_batched_pallas(jax_gen_obj, jax_gen_cons, *_to_jax(batch),
                                 tile=256, interpret=True, **opts)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rp.x), atol=1e-5)


def test_fresh_objective_path_matches_jax():
    """``alm_delta_fn=None`` (the objective evaluated afresh after an ALM
    round) on the branch batch, against the same path of the JAX solver;
    the prox targets are perturbed enough to bind line limits."""
    t_in, j_in, _ = _batch("case9", "f64", sigma=0.3)
    x0, xl, xu, p, lam0, mu0, act = t_in
    opts = _tolerances("f64")
    rt = tron_alm_batched(TB.branch_obj_linelimit, TB.branch_cons_linelimit,
                          TB.branch_fgh_linelimit, x0, xl, xu, p, lam0, mu0,
                          active0=act, alm_delta_fn=None, **opts)
    rj = jax.jit(lambda *a: jax_tron(
        JB.branch_obj_linelimit, JB.branch_cons_linelimit, *a,
        fgh_fn=JB.branch_fgh_linelimit, alm_delta_fn=None, **opts))(*j_in)
    np.testing.assert_array_equal(rt.minor_iters.numpy(),
                                  np.asarray(rj.minor_iters))
    np.testing.assert_array_equal(rt.alm_iters.numpy(),
                                  np.asarray(rj.alm_iters))
    assert int(rt.alm_iters.max()) > 1   # ALM rounds restarted TRON
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-9)


def _jax_chain():
    """JAX: flat start, two inner iterations, then the third hook by hook;
    returns {stage: (inner_iter, input state, output state)} and the
    scalars."""
    _, jm = _models()
    sol = JMP.init_solution(jm, RHO_PQ, RHO_VA)
    stages = {"init": (None, None, sol)}
    x1, _ = jm.update_x(jm.inner_prestep(sol), 1)
    stages["x1"] = (1, sol, x1)
    for it in (1, 2):
        sol, _ = jm.update_x(jm.inner_prestep(sol), it)
        sol = jm.update_xbar(sol)
        sol = jm.update_z(sol, BETA)
        sol = jm.update_l(sol, BETA)
        sol, _ = jm.update_residual(sol, BETA)
    pre = jm.inner_prestep(sol)
    xs, _ = jm.update_x(pre, 3)
    xb = jm.update_xbar(xs)
    zs = jm.update_z(xb, BETA)
    ls = jm.update_l(zs, BETA)
    rs, scalars = jm.update_residual(ls, BETA)
    stages.update(prestep=(None, sol, pre), x=(3, pre, xs), xbar=(None, xs, xb),
                  z=(None, xb, zs), l=(None, zs, ls), r=(None, ls, rs),
                  lz=(None, rs, jm.update_lz(rs, BETA)))
    return stages, scalars


@pytest.fixture(scope="module")
def jax_chain():
    return _jax_chain()


@pytest.mark.parametrize("stage", ["init", "x1", "prestep", "x", "xbar", "z",
                                   "l", "r", "lz"])
def test_hooks_match_jax(jax_chain, stage):
    stages, jsc = jax_chain
    tm, _ = _models()
    inner, j_in, j_out = stages[stage]
    if stage == "init":
        got = TMP.init_solution(tm, RHO_PQ, RHO_VA)
    else:
        sol = mpacopf_solution_from_numpy(mpacopf_solution_to_numpy(j_in))
        hook = {"x1": lambda s: tm.update_x(s, inner)[0],
                "prestep": tm.inner_prestep,
                "x": lambda s: tm.update_x(s, inner)[0],
                "xbar": tm.update_xbar,
                "z": lambda s: tm.update_z(s, BETA),
                "l": lambda s: tm.update_l(s, BETA),
                "r": lambda s: tm.update_residual(s, BETA),
                "lz": lambda s: tm.update_lz(s, BETA)}[stage]
        got = hook(sol)
        if stage == "r":
            got, tsc = got
            for k in jsc:
                np.testing.assert_allclose(float(tsc[k]), float(jsc[k]),
                                           rtol=1e-9, err_msg=k)
    a = mpacopf_solution_to_numpy(got)
    b = mpacopf_solution_to_numpy(j_out)
    for part in ("acopf", "ramp"):
        for k, v in b[part].items():
            for kk, ref in (v.items() if isinstance(v, dict) else [(k, v)]):
                g = a[part][k][kk] if isinstance(v, dict) else a[part][k]
                np.testing.assert_allclose(g, ref, rtol=0, atol=1e-9,
                                           err_msg=f"{stage}: {part}.{k}.{kk}")


def test_period_bus_update_is_bitwise_per_period():
    """The bus update of T periods (one folded scatter per sum) equals T
    single-period updates bit for bit; the last period, whose ramp terms
    are zero, equals the update with no ramp at all."""
    tm, _ = _models("synth300")
    gd = tm.grid
    rng = np.random.default_rng(5)

    def blk(scale, lo=None):
        def draw(shape):
            if lo is not None:
                return torch.as_tensor(rng.uniform(lo, scale, shape))
            return torch.as_tensor(rng.normal(0, scale, shape))
        return Blocks(gen=draw((T, gd.ngen, 2)),
                      line=draw((T, gd.nline_padded, 8)))

    u, z, l, rho = blk(1.0), blk(0.1), blk(10.0), blk(4e4, lo=4e2)
    ramp = {k: torch.as_tensor(rng.normal(0, 1, (T, gd.ngen)))
            for k in ("u", "z", "l")}
    ramp["rho"] = torch.as_tensor(rng.uniform(4e2, 4e4, (T, gd.ngen)))
    ramp = {k: torch.cat([v[:-1], torch.zeros_like(v[:1])])
            for k, v in ramp.items()}
    v = TK.bus_update(u, z, l, rho, gd, Pd=tm.Pd, Qd=tm.Qd, ramp=ramp)

    def at(t, *bs):
        return [Blocks(gen=b.gen[t], line=b.line[t]) for b in bs]

    for t in range(T):
        vt = TK.bus_update(*at(t, u, z, l, rho), gd, Pd=tm.Pd[t],
                           Qd=tm.Qd[t], ramp={k: r[t] for k, r in ramp.items()})
        assert torch.equal(v.gen[t], vt.gen), t
        assert torch.equal(v.line[t], vt.line), t
    plain = TK.bus_update(*at(T - 1, u, z, l, rho), gd, Pd=tm.Pd[-1],
                          Qd=tm.Qd[-1])
    assert torch.equal(v.gen[-1], plain.gen)
    assert torch.equal(v.line[-1], plain.line)


def test_one_period_solves_no_ramp_batch(monkeypatch):
    """With T = 1 there is nothing to couple: ``update_x`` runs no ramp
    solve (so a card counts no ramp launch), leaves the ramp state as it
    was, and gives the single-period model's x update bit for bit."""
    def no_ramp(*a, **k):
        raise AssertionError("ramp batch solved with T = 1")

    monkeypatch.setattr(tron_cuda, "tron_alm_ramp", no_ramp)
    pd, qd = load_time_series(DEMAND)
    tm = TMP.build_model(opf_loaddata(CASE9, verbose=0), Parameters(verbose=0),
                         pd, qd, end_period=1)
    sol = TMP.init_solution(tm, RHO_PQ, RHO_VA)
    got, _ = tm.update_x(tm.inner_prestep(sol), 1)
    single = TAM.ModelAcopf(grid=tm.grid, par=tm.par)
    ac0 = Solution(**{k: Blocks(gen=getattr(sol.acopf, k).gen[0],
                                line=getattr(sol.acopf, k).line[0])
                      for k in SOLUTION_BLOCKS},
                   branch_alm=BranchALMState(
                       **{k: getattr(sol.acopf.branch_alm, k)[0]
                          for k in ("lam1", "lam2", "mu")}))
    ref, _ = single.update_x(ac0, 1)
    assert torch.equal(got.acopf.u.gen[0], ref.u.gen)
    assert torch.equal(got.acopf.u.line[0], ref.u.line)
    for k in ("u", "s", "alm_mu", "alm_xi"):
        assert torch.equal(getattr(got.ramp, k), getattr(sol.ramp, k)), k
