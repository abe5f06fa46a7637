"""The port's QP-subproblem model and reduced-QP TRON against the JAX ones.

Inputs: the case9 QP linearized at the reference test's base point
(``tests/qpsub_fixture.py``) and the QP of a synthetic 300-bus case at its
own operating point, built by each package's ``build_qp_inputs`` and
handed to both as numpy arrays; fp64 unless stated.

Tolerances:
- ``build_qp_inputs`` and the model's precomputed arrays (numpy fp64 in
  both packages): 1e-12.
- G: bitwise symmetric in the port, and within 1e-15 of each lane's
  largest |G| of the JAX G (which is symmetric only to rounding, and whose
  einsum sums in another order); the other solve constants within 1e-15
  relative to each array's largest magnitude.
- closed-form f/g/H against torch.autograd and against the JAX ``fgh``:
  1e-9 (as the JAX package's own test, ``test_qpsub.py:203-249``).
- plain TRON against the JAX ``tron_alm_batched`` on the same parameters,
  fp64: iteration counts equal on every lane, x within 1e-10; fp32 against
  the Pallas kernel in interpret mode: x within 1e-5 and equal minor
  iterations, as the branch instance's test.
- one x/xbar/l/residual sweep, each port hook fed the JAX hook's input
  state: every block within 1e-10; against the reference's golden vectors
  at ``test_qpsub.py``'s tolerances.
- 50 one-level iterations (20 without line limits) against the JAX
  ``_one_level_while``: every block of the state within 1e-9 relative to
  its largest magnitude (einsum and reduction orders differ by ulps, which
  the iterations carry along).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.algorithms.admm_one_level import _one_level_while
from exaadmm_tpu.models.acopf.branch import branch_alm_delta as jax_alm_delta
from exaadmm_tpu.models.qpsub import model as JQ
from exaadmm_tpu.models.qpsub import sqp as JS
from exaadmm_tpu.ops.tron import tron_alm_batched as jax_tron
from exaadmm_tpu.ops.tron_pallas import tron_alm_batched_pallas
from exaadmm_tpu.utils import environment as JE
from exaadmm_tpu.utils.grid_data import build_grid_data as jax_grid
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.algorithms.admm_one_level import admm_one_level
from exaadmm_tpu_torch.models.qpsub import model as TQ
from exaadmm_tpu_torch.models.qpsub import sqp as TS
from exaadmm_tpu_torch.ops import tron_cuda
from exaadmm_tpu_torch.utils.convert import (qpsub_solution_from_numpy,
                                             qpsub_solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from . import qpsub_fixture as fx
from .test_torch_threads import one_torch_thread  # noqa: F401


def _data(case):
    if case == "synth300":
        return synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)
    from os.path import dirname, join
    path = join(dirname(dirname(__file__)), "data", "case9.m")
    return opf_loaddata(path, verbose=0), jax_opf_loaddata(path, verbose=0)


def _base(data, mod):
    """The case9 fixture's base point (vm = sqrt(bus_w), va from the line
    angles), or a synthetic case's own operating point."""
    if data.nbus == 9:
        f, t = np.asarray(data.line_from), np.asarray(data.line_to)
        va = np.zeros(data.nbus)
        va[f] = fx.line_var[4]
        va[t] = fx.line_var[5]
        return mod.SqpBasePoint(pg=fx.pg, qg=fx.qg, vm=np.sqrt(fx.bus_w),
                                va=va)
    return mod.SqpBasePoint(pg=np.asarray(data.Pg0), qg=np.asarray(data.Qg0),
                            vm=np.asarray(data.Vm), va=np.asarray(data.Va))


def _qp_inputs(case):
    """Each package's QP inputs of ``case`` and its data."""
    tdata, jdata = _data(case)
    tq = TS.build_qp_inputs(tdata, build_grid_data(tdata), _base(tdata, TS))
    jq = JS.build_qp_inputs(jdata, jax_grid(jdata), _base(jdata, JS))
    return (tdata, tq), (jdata, jq)


def _models(case, dtype="f64", use_linelimit=True, pad_lines_to=1,
            scale=1e-4, outer_eps=2e-6, outer_iterlim=10000):
    """Both packages' models of ``case``, built from the port's QP inputs."""
    (tdata, tq), (jdata, _) = _qp_inputs(case)
    tdt, jdt = ((torch.float64, jnp.float64) if dtype == "f64"
                else (torch.float32, jnp.float32))
    kw = dict(verbose=0, scale=scale, outer_eps=outer_eps,
              outer_iterlim=outer_iterlim)
    tm = TQ.build_model(tdata, Parameters(**kw), tq,
                        use_linelimit=use_linelimit,
                        pad_lines_to=pad_lines_to, dtype=tdt)
    jm = JQ.build_model(jdata, JE.Parameters(**kw), tq,
                        use_linelimit=use_linelimit,
                        pad_lines_to=pad_lines_to, dtype=jdt)
    return tm, jm


def _jax_solution(d: dict):
    """A JAX ``SolutionQpsub`` from the nested numpy dicts of
    ``qpsub_solution_to_numpy``."""
    def blk(b):
        return JE.Blocks(gen=jnp.asarray(b["gen"]), line=jnp.asarray(b["line"]))

    b = d["base"]
    base = JE.Solution(
        **{k: blk(b[k]) for k in ("u", "v", "l", "rho", "z", "z_prev", "lz",
                                  "rp", "rd")},
        branch_alm=JE.BranchALMState(
            **{k: jnp.asarray(v) for k, v in b["branch_alm"].items()}))
    return JQ.SolutionQpsub(
        base=base, sqp_line=jnp.asarray(d["sqp_line"]), v_prev=blk(d["v_prev"]),
        **{k: jnp.asarray(d[k]) for k in ("alm_lam_j", "alm_lam_k", "alm_mu")})


def _flat(d: dict, prefix=""):
    """(name, array) of every leaf of a nested numpy dict."""
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def _assert_states_close(tsol, jsol, rel=None, atol=None):
    a = dict(_flat(qpsub_solution_to_numpy(tsol)))
    for name, ref in _flat(qpsub_solution_to_numpy(jsol)):
        tol = atol if rel is None else rel * max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(a[name], ref, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["case9", "synth300"])
def test_build_qp_inputs_matches_jax(case):
    (_, tq), (_, jq) = _qp_inputs(case)
    assert set(tq) == set(jq) == set(TQ.QP_KEYS)
    for k in jq:
        np.testing.assert_allclose(tq[k], jq[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_from_power_flow_not_ported():
    """The power flow is ported now: the base point is the NR warm start,
    equal to the JAX package's (more in test_torch_pf.py)."""
    tdata, jdata = _data("case9")
    got = TS.SqpBasePoint.from_power_flow(tdata)
    ref = JS.SqpBasePoint.from_power_flow(jdata)
    for k in ("pg", "qg", "vm", "va"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


@pytest.mark.parametrize("case,pad", [("case9", 1), ("case9", 4),
                                      ("synth300", 1)])
def test_model_precompute_matches_jax(case, pad):
    tm, jm = _models(case, pad_lines_to=pad)
    assert tm.grid.nline_padded == jm.grid.nline_padded
    for k in ("Hs", "LH_1h", "RH_1h", "LH_1i", "RH_1i", "LH_1j", "RH_1j",
              "LH_1k", "RH_1k", "ls", "us", "c1", "c2", "C", "dvec", "supY8",
              "vec_1j", "vec_1k", "line_res"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert tm.nvar == jm.nvar


@pytest.mark.parametrize("case", ["case9", "synth300"])
def test_solve_constants_symmetric_and_match_jax(case):
    tm, jm = _models(case)
    rho = np.random.default_rng(2).uniform(4e2, 4e4, (tm.grid.nline_padded,
                                                      8))
    tc = TQ.qp_solve_constants(tm, torch.as_tensor(rho))
    jc = JQ._qp_solve_constants(jm, jnp.asarray(rho))
    G, Gj = tc["GT"].numpy(), np.asarray(jc["GT"])
    assert np.array_equal(G, G.transpose(1, 0, 2))
    lane_max = np.abs(Gj).max(axis=(0, 1))
    assert (np.abs(G - Gj).max(axis=(0, 1)) <= 1e-15 * lane_max).all()
    for k in ("Ad6", "fc0", "w3T", "w4T", "e3", "e4"):
        ref = np.asarray(jc[k])
        np.testing.assert_allclose(tc[k].numpy(), ref, rtol=0,
                                   atol=1e-15 * float(np.abs(ref).max()),
                                   err_msg=k)


def _random_qp(seed=7):
    """Both packages' reduced-QP parameters from random multipliers, rho and
    prox targets on the case9 model (as ``test_qpsub.py:203-249``), plus a
    random point (x, lam, mu)."""
    tm, _ = _models("case9")
    nl = tm.grid.nline_padded
    rng = np.random.default_rng(seed)
    lL = rng.standard_normal((nl, 8))
    rL = rng.uniform(1.0, 5.0, (nl, 8))
    vz = rng.standard_normal((nl, 8))
    sol = TQ.init_solution(tm, 1.0, 1.0)
    b = sol.base
    sol = sol.replace(base=b.replace(
        l=b.l.replace(line=torch.as_tensor(lL)),
        rho=b.rho.replace(line=torch.as_tensor(rL)),
        v=b.v.replace(line=torch.as_tensor(vz))))
    params = TQ.qpsub_inputs(tm, sol, 1)[3]
    x = rng.standard_normal((6, nl))
    lam = rng.standard_normal((2, nl))
    mu = rng.uniform(1.0, 20.0, nl)
    return params, x, lam, mu


def test_qp_fgh_matches_autograd_and_jax():
    params, x, lam, mu = _random_qp()
    tx, tlam, tmu = (torch.as_tensor(a) for a in (x, lam, mu))
    f, g, H = TQ.qp_fgh(tx, params, tlam, tmu)
    np.testing.assert_allclose(f.numpy(),
                               TQ.qp_obj(tx, params, tlam, tmu).numpy(),
                               rtol=1e-12)

    xg = tx.clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(TQ.qp_obj(xg, params, tlam, tmu).sum(), xg,
                                  create_graph=True)
    H_ad = np.stack([torch.autograd.grad(g_ad[i].sum(), xg,
                                         retain_graph=True)[0].numpy()
                     for i in range(6)])

    obj, _, fgh = JQ._reduced_qp_fns()
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jx, jlam, jmu = jnp.asarray(x), jnp.asarray(lam), jnp.asarray(mu)
    jf, jg, jH = fgh(jx, jp, jlam, jmu)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), g_ad.detach().numpy(), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-10)
    for i in range(6):
        for j in range(6):
            np.testing.assert_allclose(H[i, j].numpy(), H_ad[i, j], rtol=1e-9,
                                       atol=1e-10)
            np.testing.assert_allclose(H[i, j].numpy(), np.asarray(jH[i][j]),
                                       rtol=1e-9, atol=1e-10)


def _batch(case, dtype="f64", use_linelimit=True, seed=0):
    """The port's batch of the first iteration, from ``init_solution`` and
    ``one_level_reset``, with l.line and v.line perturbed by N(0, 0.05)."""
    tm, _ = _models(case, dtype, use_linelimit)
    sol = tm.one_level_reset(TQ.init_solution(tm, 4e3, 4e3))
    b = sol.base
    rng = np.random.default_rng(seed)
    dt = b.l.line.dtype

    def noise():
        return torch.as_tensor(rng.normal(0, 0.05, tuple(b.l.line.shape))).to(dt)

    sol = sol.replace(base=b.replace(
        l=b.l.replace(line=b.l.line + noise()),
        v=b.v.replace(line=b.v.line + noise())))
    batch = TQ.qpsub_inputs(tm, sol, 1)
    return batch, TQ.qpsub_tolerances(tm.par, dt, use_linelimit)


def _to_jax(batch):
    x0, xl, xu, p, lam0, mu0, act = batch
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return (j(x0), j(xl), j(xu), {k: j(v) for k, v in p.items()}, j(lam0),
            j(mu0)), j(act)


@pytest.mark.parametrize("case,use_linelimit", [("case9", True),
                                                ("synth300", True),
                                                ("synth300", False)])
def test_plain_qpsub_tron_matches_jax_fp64(case, use_linelimit):
    batch, opts = _batch(case, use_linelimit=use_linelimit)
    rt = tron_cuda.tron_alm_qpsub(*batch[:6], active0=batch[6], **opts)
    obj, cons, fgh = JQ._reduced_qp_fns()
    args, jact = _to_jax(batch)
    rj = jax.jit(lambda *a: jax_tron(
        obj, cons, *a, active0=jact, fgh_fn=fgh, alm_delta_fn=jax_alm_delta,
        **opts))(*args)
    np.testing.assert_array_equal(rt.minor_iters.numpy(),
                                  np.asarray(rj.minor_iters))
    np.testing.assert_array_equal(rt.alm_iters.numpy(),
                                  np.asarray(rj.alm_iters))
    assert int(rt.minor_iters.min()) > 0
    if not use_linelimit:
        assert int(rt.alm_iters.max()) == 1
        assert float(rt.x[:2].abs().max()) == 0.0   # slacks pinned at 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(rt.mu.numpy(), np.asarray(rj.mu))


def test_plain_qpsub_tron_fp32_matches_pallas_interpret():
    batch, opts = _batch("case9", "f32")
    rt = tron_cuda.tron_alm_qpsub(*batch[:6], active0=batch[6], **opts)
    obj, cons, fgh = JQ._reduced_qp_fns()
    args, jact = _to_jax(batch)
    rp = tron_alm_batched_pallas(obj, cons, *args, tile=256, interpret=True,
                                 active0=jact, fgh_fn=fgh,
                                 alm_delta_fn=jax_alm_delta, **opts)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rp.x), atol=1e-5)
    np.testing.assert_array_equal(rt.minor_iters.numpy(),
                                  np.asarray(rp.minor_iters))


def test_padded_lanes_come_back_untouched():
    batch, opts = _batch("case9")
    x0, xl, xu, p, lam0, mu0, act = batch
    act = act.clone()
    act[::3] = False
    r = tron_cuda.tron_alm_qpsub(x0, xl, xu, p, lam0, mu0, active0=act,
                                 **opts)
    off = ~act
    assert torch.equal(r.x[:, off], x0[:, off])
    assert torch.equal(r.lam[:, off], lam0[:, off])
    assert torch.equal(r.mu[off], mu0[off])
    assert int(r.minor_iters[off].abs().sum()) == 0
    assert bool((r.minor_iters[act] > 0).all())


def test_pack_qpsub_params_layout():
    batch, _ = _batch("case9")
    p = batch[3]
    P = tron_cuda.pack_qpsub_params(p)
    B = p["fc"].shape[0]
    assert tuple(P.shape) == (tron_cuda.QPSUB.nparam, B)
    assert P.is_contiguous()
    for i in range(6):
        for j in range(i + 1):
            assert torch.equal(P[i * (i + 1) // 2 + j], p["G"][i, j])
    for r, k in enumerate(("h0", "w3", "w4")):
        assert torch.equal(P[21 + 6 * r:27 + 6 * r], p[k])
    for r, k in enumerate(("fc", "e3", "e4", "scale")):
        assert torch.equal(P[39 + r], p[k])


def test_one_sweep_matches_jax_and_golden():
    """One x/xbar/l/residual sweep at rho (20, 20): each port hook fed the
    JAX hook's input state matches the JAX hook to 1e-10, and the chained
    port sweep matches the reference's golden vectors."""
    tm, jm = _models("case9")
    j0 = jm.one_level_reset(JQ.init_solution(jm, 20.0, 20.0))
    t0 = tm.one_level_reset(TQ.init_solution(tm, 20.0, 20.0))
    _assert_states_close(t0, j0, atol=1e-12)

    j1, _ = jm.update_x(j0, 1)
    j2 = jm.update_xbar(j1)
    j3 = jm.update_l_single(j2)
    j4, jsc = jm.update_residual(j3, 0.0)

    def port(jsol):
        return qpsub_solution_from_numpy(qpsub_solution_to_numpy(jsol))

    _assert_states_close(tm.update_x(port(j0), 1)[0], j1, atol=1e-10)
    _assert_states_close(tm.update_xbar(port(j1)), j2, atol=1e-10)
    _assert_states_close(tm.update_l_single(port(j2)), j3, atol=1e-10)
    t4, tsc = tm.update_residual(port(j3), 0.0)
    _assert_states_close(t4, j4, atol=1e-10)
    for k in jsc:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-10,
                                   err_msg=k)

    s, _ = tm.update_x(t0, 1)
    b = s.base

    def cat(blk):
        return np.concatenate([blk.gen.numpy().ravel(),
                               blk.line.numpy().ravel()])

    np.testing.assert_allclose(cat(b.u), fx.U_SOL, atol=1e-4)
    s = tm.update_xbar(s)
    np.testing.assert_allclose(cat(s.base.v), fx.V_SOL, atol=1e-4)
    s = tm.update_l_single(s)
    np.testing.assert_allclose(cat(s.base.l), fx.L_SOL, atol=2e-3)
    s, _ = tm.update_residual(s, 0.0)
    np.testing.assert_allclose(cat(s.base.rp), fx.RP_SOL, atol=1e-4)


@pytest.mark.parametrize("use_linelimit,iters", [(True, 50), (False, 20)])
def test_one_level_iterations_match_jax(use_linelimit, iters):
    """The port's driver over ``iters`` iterations (outer_eps 0, so no early
    stop) against the JAX solve's while loop from the same reset state."""
    tm, jm = _models("case9", use_linelimit=use_linelimit, outer_eps=0.0,
                     outer_iterlim=iters)
    jsol = jm.one_level_reset(JQ.init_solution(jm, 4e3, 4e3))
    c = jax.jit(lambda s: _one_level_while(jm, s, 0.0, 0.0, iters))(jsol)
    tsol, info = admm_one_level(tm, TQ.init_solution(tm, 4e3, 4e3))
    assert info.outer == info.cumul == int(c.it) == iters
    assert info.status == "IterationLimit"
    _assert_states_close(tsol, c.sol, rel=1e-9)
    for k in ("primres", "dualres", "mismatch", "objval", "auglag"):
        np.testing.assert_allclose(getattr(info, k), float(getattr(c, k)),
                                   rtol=1e-9, err_msg=k)
