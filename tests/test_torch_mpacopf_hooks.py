"""The multi-period hook wrappers (``exaadmm_tpu_torch/ops/mpacopf_cuda.py``)
on the CPU, where they run their plain versions, against the plain
functions and the JAX hooks; ``tron_alm_packed`` on the ramp batch; the
refusals; the model's hooks going through the wrappers; and the residual
kernels' per-period fixed summation tree, reproduced with torch ops.

Inputs: case9 x 3 periods (``data/case9_demand``) and a synthetic case of 300
buses (seed 3) x 3 periods (``synthetic_load_profile`` seed 1) in both
packages, with a multi-period ADMM state drawn from a numpy seed and handed
to both as numpy arrays; case9 x 1 period for the model without a ramp
batch.

Tolerances:
- a wrapper on CPU tensors against the plain function: bit for bit (it
  runs the plain function);
- against the JAX hooks, fp64: 1e-12 of each array's largest magnitude, as
  ``tests/test_torch_acopf_hooks.py`` holds the single-period hooks (the
  bus sums run in another order, and the 2x2 bus solve amplifies that);
- the residual's fixed tree against ``torch.sum``, fp64: each per-period sum
  within 1e-13 of the sum of its terms' magnitudes, the square roots 1e-13
  relative: the same positive terms added in another order.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.models.mpacopf import model as JMP
from exaadmm_tpu.utils.environment import Blocks as JBlocks
from exaadmm_tpu.utils.environment import BranchALMState as JALM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.environment import Solution as JSolution
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.models.mpacopf import model as MP
from exaadmm_tpu_torch.models.mpacopf import ramp as R
from exaadmm_tpu_torch.ops import bounds, bus_cuda, tron_cuda
from exaadmm_tpu_torch.ops import mpacopf_cuda as MC
from exaadmm_tpu_torch.ops.tron import TronALMResult
from exaadmm_tpu_torch.utils.convert import (mpacopf_solution_from_numpy,
                                             mpacopf_solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import (RAMP_FIELDS, Blocks,
                                                 Parameters, RampState)
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import (synthetic_case,
                                               synthetic_load_profile)

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMAND = os.path.join(ROOT, "data", "case9_demand")
BETA = 1e3
KEYS = ("u", "v", "l", "rho", "z", "z_prev", "lz", "rp", "rd")
CASES = ("case9", "synthetic300", "case9 x 1")


def _close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def _data(name, case9_path):
    """(port data, JAX data, (Pd, Qd), T)."""
    if name.startswith("case9"):
        pd, qd = load_time_series(DEMAND)
        return (opf_loaddata(case9_path, verbose=0),
                jax_opf_loaddata(case9_path, verbose=0), (pd, qd),
                1 if name.endswith("x 1") else 3)
    tdata = synthetic_case(300, seed=3)
    return (tdata, jax_synthetic_case(300, seed=3),
            synthetic_load_profile(tdata, 3, seed=1), 3)


def _state(T, ngen, nl, seed=0):
    """A random multi-period state over the shapes, as numpy arrays: rho
    positive but one ramp row of period 2 (safe_rho's guard), ALM
    penalties positive."""
    rng = np.random.default_rng(seed)
    ac = {}
    for k in KEYS:
        if k == "rho":
            ac[k] = {"gen": rng.uniform(1e2, 1e5, (T, ngen, 2)),
                     "line": rng.uniform(1e2, 1e5, (T, nl, 8))}
        else:
            ac[k] = {"gen": rng.normal(0, 1, (T, ngen, 2)),
                     "line": rng.normal(0, 1, (T, nl, 8))}
    ac["branch_alm"] = {"lam1": rng.normal(0, 1, (T, nl)),
                        "lam2": rng.normal(0, 1, (T, nl)),
                        "mu": rng.uniform(10, 1e3, (T, nl))}
    ramp = {k: rng.normal(0, 1, (T, ngen)) for k in RAMP_FIELDS}
    ramp["rho"] = rng.uniform(1e2, 1e5, (T, ngen))
    ramp["alm_xi"] = rng.uniform(10, 1e3, (T, ngen))
    if T > 1:
        ramp["rho"][1, 0] = -1.0
    return {"acopf": ac, "ramp": ramp}


def _jax_solution(d):
    ac = d["acopf"]
    blocks = {k: JBlocks(gen=jnp.asarray(ac[k]["gen"]),
                         line=jnp.asarray(ac[k]["line"])) for k in KEYS}
    alm = {k: jnp.asarray(v) for k, v in ac["branch_alm"].items()}
    return JMP.SolutionMpacopf(
        acopf=JSolution(**blocks, branch_alm=JALM(**alm)),
        ramp=JMP.RampState(**{k: jnp.asarray(v)
                              for k, v in d["ramp"].items()}))


@pytest.fixture(scope="module", params=CASES)
def state(request, case9_path):
    """Both packages' models of one case (obj_scale 2, so the effective
    costs differ from the raw ones) and one random state; the port's model
    also with its lines padded to a multiple of 4 (padded rows masked)."""
    tdata, jdata, (pd, qd), T = _data(request.param, case9_path)
    kw = dict(start_period=1, end_period=T)
    tmodel = MP.build_model(tdata, Parameters(verbose=0, obj_scale=2.0), pd,
                            qd, **kw)
    jmodel = JMP.build_model(jdata, JParameters(verbose=0, obj_scale=2.0), pd,
                             qd, **kw)
    padded = MP.build_model(tdata, Parameters(verbose=0, obj_scale=2.0), pd,
                            qd, pad_lines_to=4, **kw)
    gd = tmodel.grid
    d = _state(T, gd.ngen, gd.nline_padded)
    dp = _state(T, gd.ngen, padded.grid.nline_padded, seed=1)
    return dict(tmodel=tmodel, jmodel=jmodel, d=d,
                tsol=mpacopf_solution_from_numpy(d), jsol=_jax_solution(d),
                padded=padded, psol=mpacopf_solution_from_numpy(dp))


def _ramp_result(model, seed=2):
    """A ramp batch's result drawn from a numpy seed (None with T == 1)."""
    T, ngen = model.T, model.grid.ngen
    if T == 1:
        return None
    B = (T - 1) * ngen
    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    return TronALMResult(
        x=t(rng.normal(0, 1, (3, B))), lam=t(rng.normal(0, 1, (1, B))),
        mu=t(rng.uniform(10, 1e3, B)),
        minor_iters=torch.zeros(B, dtype=torch.int32),
        alm_iters=torch.ones(B, dtype=torch.int32),
        cviol=torch.zeros(B, dtype=torch.float64))


def _flat(x):
    if isinstance(x, Blocks):
        return [x.gen, x.line]
    if isinstance(x, RampState):
        return [getattr(x, k) for k in RAMP_FIELDS]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat(y)]
    if isinstance(x, dict):
        return [x[k] for k in MC.SCALARS]
    return [x]


def _wrapped_and_plain(name, m, s):
    """(the wrapper's outputs, the plain function's) of hook ``name`` as
    lists of tensors."""
    gd = m.grid
    bt = torch.tensor(BETA, dtype=torch.float64)
    res = _ramp_result(m)
    arcs, gens = MC.bus_values_plain(s, m)
    agg = bus_cuda.bus_scatter(arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx)
    gsum = bus_cuda.bus_scatter(gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)
    wtm = MC.bus_solve_plain(agg, gsum, gd, m.Pd, m.Qd)
    _, _, part = MC.residual_partials_plain(s, m)
    ac = s.acopf
    calls = {
        "ramp_pack": (lambda: MC.ramp_pack(s, m, 3),
                      lambda: R.ramp_pack_plain(s, m, 3)),
        "ramp_pack, first iteration": (
            lambda: MC.ramp_pack(s, m, torch.tensor(1)),
            lambda: R.ramp_pack_plain(s, m, torch.tensor(1))),
        "generator_unpack": (lambda: MC.generator_unpack(s, m, res),
                             lambda: MP.generator_unpack_plain(s, m, res)),
        "bus_values": (lambda: MC.bus_values(s, m),
                       lambda: MC.bus_values_plain(s, m)),
        "bus_solve": (lambda: MC.bus_solve(agg, gsum, gd, m.Pd, m.Qd),
                      lambda: MC.bus_solve_plain(agg, gsum, gd, m.Pd, m.Qd)),
        "bus_writeback": (
            lambda: MC.bus_writeback(s, m, wtm),
            lambda: MP.kernels.bus_writeback(ac.u, ac.z, ac.l, ac.rho, wtm,
                                             gd, m.next_ramp(s.ramp))),
        "bus_update": (lambda: MC.bus_update(s, m, m.Pd, m.Qd),
                       lambda: MP.bus_update_plain(s, m, m.Pd, m.Qd)),
        "z_update": (lambda: MC.z_update(s, m, bt),
                     lambda: MP.z_update_plain(s, m, bt)),
        "l_update": (lambda: MC.l_update(s, m, BETA),
                     lambda: MP.l_update_plain(s, m, BETA)),
        "lz_update": (lambda: MC.lz_update(s, m, bt),
                      lambda: MP.lz_update_plain(s, m, bt)),
        "residual_partials": (lambda: MC.residual_partials(s, m),
                              lambda: MC.residual_partials_plain(s, m)),
        "residual_final": (
            lambda: MC.residual_final(part[:MC.LINE_SUMS],
                                      part[MC.LINE_SUMS:]),
            lambda: MC.residual_final_plain(part[:MC.LINE_SUMS],
                                            part[MC.LINE_SUMS:])),
        "residual_update": (lambda: MC.residual_update(s, m, bt),
                            lambda: MP.residual_update_plain(s, m)),
    }
    wrapped, plain = calls[name]
    return _flat(wrapped()), _flat(plain())


HOOKS = ("ramp_pack", "ramp_pack, first iteration", "generator_unpack",
         "bus_values", "bus_solve", "bus_writeback", "bus_update",
         "z_update", "l_update", "lz_update", "residual_partials",
         "residual_final", "residual_update")


@pytest.mark.parametrize("name", HOOKS)
def test_wrapper_on_cpu_is_the_plain_version(state, name):
    for m, s in ((state["tmodel"], state["tsol"]),
                 (state["padded"], state["psol"])):
        got, ref = _wrapped_and_plain(name, m, s)
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_ramp_inputs(jm, jsol, inner_iter, monkeypatch, res=None):
    """The JAX x update's ramp batch inputs (x0, xl, xu, params, lam0, mu0)
    as the solver receives them, and its update_x output with the solver
    returning ``res`` (None: an empty batch; a JAX line batch is not
    solved: its branch update returns the old rows)."""
    seen = {}

    def solver(obj, cons, x0, xl, xu, params, lam0, mu0, **kw):
        seen["in"] = (x0, xl, xu, params, lam0, mu0)
        if res is None:
            return SimpleNamespace(x=jnp.zeros((3, 0)), lam=jnp.zeros((1, 0)),
                                   mu=jnp.zeros(0))
        return SimpleNamespace(x=jnp.asarray(res.x.numpy()),
                               lam=jnp.asarray(res.lam.numpy()),
                               mu=jnp.asarray(res.mu.numpy()))

    def no_lines(sol, gd, par, inner_iter, **kw):
        return sol.u.line, sol.branch_alm, {}

    monkeypatch.setattr(JMP, "tron_alm_batched", solver)
    monkeypatch.setattr(JMP, "branch_update", no_lines)
    out, _ = jm.update_x(jsol, inner_iter)
    return seen["in"], out


@pytest.mark.parametrize("inner_iter", [1, 3])
def test_pack_and_unpack_match_jax(state, inner_iter, monkeypatch):
    """``ramp_pack_plain`` against the inputs the JAX x update hands its
    ramp solver, and ``generator_unpack_plain`` against the JAX x update's
    generator rows and ramp state, both from the same batch result: 1e-12
    (the copies and clamps exactly; qg and pg of period 1 by rounding).
    With one period the port solves no batch and keeps the ramp state as
    it was (the JAX model solves an empty batch and zeroes the inert row's
    u, s and alm_mu); the generator rows agree."""
    tm, jm = state["tmodel"], state["jmodel"]
    res = _ramp_result(tm)
    (jx0, jxl, jxu, jp, jlam0, jmu0), jout = _jax_ramp_inputs(
        jm, state["jsol"], inner_iter, monkeypatch, res)
    x0, xl, xu, P, lam0, mu0, act = R.ramp_pack_plain(state["tsol"], tm,
                                                      inner_iter)
    for a, b in ((x0, jx0), (xl, jxl), (xu, jxu), (lam0, jlam0),
                 (mu0, jmu0)):
        assert a.shape == b.shape
        _close(a.numpy(), b)
    for i, k in enumerate(R.PARAM_KEYS):
        _close(P[i].numpy(), jp[k])
    assert act.dtype == torch.uint8 and bool((act == 1).all())
    u_gen, ramp = MP.generator_unpack_plain(state["tsol"], tm, res)
    _close(u_gen.numpy(), jout.acopf.u.gen)
    if tm.T == 1:
        assert ramp is state["tsol"].ramp
        return
    jr = mpacopf_solution_to_numpy(jout)["ramp"]
    for k in RAMP_FIELDS:
        _close(getattr(ramp, k).numpy(), jr[k])


def test_model_hooks_match_jax(state):
    """The model's xbar, z, l, lz and residual hooks (through the wrappers)
    against the JAX model's on the same state: 1e-12."""
    tm, jm = state["tmodel"], state["jmodel"]
    ts, js = state["tsol"], state["jsol"]
    pairs = [(tm.update_xbar(ts), jm.update_xbar(js)),
             (tm.update_z(ts, BETA), jm.update_z(js, BETA)),
             (tm.update_l(ts, BETA), jm.update_l(js, BETA)),
             (tm.update_lz(ts, BETA), jm.update_lz(js, BETA))]
    (t_r, t_sc), (j_r, j_sc) = (tm.update_residual(ts, BETA),
                                jm.update_residual(js, BETA))
    pairs.append((t_r, j_r))
    for a, b in pairs:
        da, db = mpacopf_solution_to_numpy(a), mpacopf_solution_to_numpy(b)
        for part in ("acopf", "ramp"):
            for k, v in db[part].items():
                for kk, ref in (v.items() if isinstance(v, dict)
                                else [(k, v)]):
                    got = (da[part][k][kk] if isinstance(v, dict)
                           else da[part][k])
                    _close(got, ref)
    for k in j_sc:
        _close(float(t_sc[k]), float(j_sc[k]))


@pytest.mark.parametrize("active", ["ones", "none"])
def test_packed_ramp_batch_is_tron_alm_ramp(state, active):
    """``tron_alm_packed(RAMP, ...)`` on the pack's block is
    ``tron_alm_ramp`` on the dict of ``ramp_inputs``, bit for bit, with the
    pack's all-ones flags and with none."""
    tm, s = state["tmodel"], state["tsol"]
    opts = R.ramp_tolerances(tm.par, torch.float64)
    *batch, act = R.ramp_pack_plain(s, tm, 1)
    got = tron_cuda.tron_alm_packed(
        tron_cuda.RAMP, *batch, active0=act if active == "ones" else None,
        **opts)
    ref = tron_cuda.tron_alm_ramp(*R.ramp_inputs(s, tm, 1), **opts)
    for k in TronALMResult._fields:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def test_packed_refuses_what_it_cannot_take():
    x = torch.ones((6, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="takes no packed"):
        tron_cuda.tron_alm_packed(tron_cuda.QPSUB, x, x, x, x, x, x,
                                  active0=None, gtol=1.0, frtol=1.0,
                                  ctol=1.0, mu_max=1.0, max_minor=1,
                                  max_auglag=1)
    with pytest.raises(ValueError, match="needs active0"):
        tron_cuda.tron_alm_packed(tron_cuda.BRANCH, x, x, x, x, x, x,
                                  active0=None, gtol=1.0, frtol=1.0,
                                  ctol=1.0, mu_max=1.0, max_minor=1,
                                  max_auglag=1)


@pytest.mark.parametrize("bad", ["meta", "float16"])
def test_wrapper_refuses_and_runs_no_plain_version(bad, monkeypatch,
                                                   case9_path):
    """A state on another device than the CPU or the card, or of another
    dtype than float32/float64, raises before any plain version runs."""
    def never(*a, **k):
        raise AssertionError("the plain version ran")

    for name in ("generator_unpack_plain", "bus_update_plain",
                 "z_update_plain", "l_update_plain", "lz_update_plain",
                 "residual_update_plain"):
        monkeypatch.setattr(MP, name, never)
    monkeypatch.setattr(R, "ramp_pack_plain", never)
    monkeypatch.setattr(MC, "residual_partials_plain", never)
    pd, qd = load_time_series(DEMAND)
    m = MP.build_model(opf_loaddata(case9_path, verbose=0),
                       Parameters(verbose=0), pd, qd, end_period=3)
    kw, err = (({"device": "meta"}, ValueError) if bad == "meta"
               else ({"dtype": torch.float16}, TypeError))
    s = MP.init_solution(m, 4e2, 4e4).to(**kw)
    res = _ramp_result(m)
    res = res._replace(x=res.x.to(**kw), lam=res.lam.to(**kw),
                       mu=res.mu.to(**kw))
    for call in (lambda: MC.ramp_pack(s, m, 1),
                 lambda: MC.generator_unpack(s, m, res),
                 lambda: MC.bus_update(s, m, m.Pd, m.Qd),
                 lambda: MC.z_update(s, m, BETA),
                 lambda: MC.l_update(s, m, BETA),
                 lambda: MC.lz_update(s, m, BETA),
                 lambda: MC.residual_partials(s, m),
                 lambda: MC.residual_update(s, m, BETA)):
        with pytest.raises(err):
            call()


def test_kernel_input_checks(case9_path):
    """What the kernels take, checked as on the card: a strided load
    matrix, a block of the wrong length, a mixed dtype, an index array that
    is not int64, an ``inner_iter`` that is not an int64 0-d tensor."""
    pd, qd = load_time_series(DEMAND)
    m = MP.build_model(opf_loaddata(case9_path, verbose=0),
                       Parameters(verbose=0), pd, qd, end_period=3)
    s = MP.init_solution(m, 4e2, 4e4)
    gd = m.grid
    ok = MC._values_inputs(s, m) + MC._grid_inputs(s, m, m.Pd, m.Qd)
    MC.validate("ok", ok)
    with pytest.raises(ValueError, match="strided"):
        MC.validate("t", MC._grid_inputs(s, m, m.Pd.t().contiguous().t(),
                                         m.Qd))
    with pytest.raises(ValueError, match="shape"):
        MC.validate("t", MC._grid_inputs(s, m, m.Pd[:2], m.Qd))
    with pytest.raises(ValueError, match="float32"):   # an fp64 grid
        MC.validate("t", MC._grid(s.to(torch.float32), m, "c2"))
    bad = [(n, t.to(torch.int32) if n == "gen_bus" else t, sh, dt)
           for n, t, sh, dt in MC._grid_inputs(s, m, m.Pd, m.Qd)]
    with pytest.raises(ValueError, match="int64"):
        MC.validate("t", bad)
    line = s.acopf.u.replace(line=s.acopf.u.line[:, :-1])
    with pytest.raises(ValueError, match="u.line"):
        MC.validate("t", MC._blocks(s.replace(acopf=s.acopf.replace(
            u=line)), m, "u"))
    for it in (torch.tensor(1, dtype=torch.int32), torch.tensor([1])):
        with pytest.raises(ValueError, match="inner_iter"):
            MC._iteration(it, gd.pgmin.device)
    assert MC._iteration(3, gd.pgmin.device) == (None, 3)
    # the loads are contiguous rows, each period's row too
    assert m.Pd.is_contiguous() and m.Qd[1].is_contiguous()


@pytest.mark.parametrize("path", ["fused", "host", "one period"])
def test_model_hooks_go_through_the_wrappers(case9_path, monkeypatch, path):
    """``ModelMpacopf``'s hooks call ``ops/mpacopf_cuda.py`` on the fused
    loop, the host loop and with one period, each with inputs the kernels
    take (checked as on the card), once an inner iteration (no ramp pack
    with one period), and lz once an outer round in the fused loop (its
    tail) and in every round that did not solve in the host loop; the
    ramp batch runs through ``tron_alm_packed``."""
    calls = {}
    route = MC._route
    packed = tron_cuda.tron_alm_packed

    def counted(what, inputs):
        calls[what] = calls.get(what, 0) + 1
        MC.validate(what, inputs)
        return route(what, inputs)

    def counted_packed(inst, *a, **k):
        calls[inst.name] = calls.get(inst.name, 0) + 1
        return packed(inst, *a, **k)

    monkeypatch.setattr(MC, "_route", counted)
    monkeypatch.setattr(tron_cuda, "tron_alm_packed", counted_packed)
    T = 1 if path == "one period" else 3
    pd, qd = load_time_series(DEMAND)
    par = Parameters(verbose=0, outer_iterlim=2, inner_iterlim=4,
                     outer_eps=2e-5)
    model = MP.build_model(opf_loaddata(case9_path, verbose=0), par, pd, qd,
                           end_period=T)
    sol = MP.init_solution(model, 4e2, 4e4)
    if path == "host":
        _, info = two.admm_two_level(model, sol)
        lz = info.outer - (info.status == "Solved")
    else:
        _, info = two.two_level_driver(model)(model, sol)
        lz = info.outer
    n = info.cumul
    want = {"generator_unpack": n, "bus_update": n, "z_update": n,
            "l_update": n, "residual_update": n, "lz_update": lz,
            "tron_alm_branch": n}
    if T > 1:
        want.update(ramp_pack=n, tron_alm_ramp=n)
    assert n > 0 and calls == want


def _tree_inputs(T, ngen, nline, seed):
    """A random state of T periods, ``ngen`` generators and ``nline`` lines
    (the last 5 padded), and a model-like record with the mask, the costs
    and the ramp mask."""
    rng = np.random.default_rng(seed)
    d = _state(T, ngen, nline, seed)
    for k in KEYS:
        lo, hi = (1e2, 1e5) if k == "rho" else (-3.0, 3.0)
        d["acopf"][k] = {"gen": rng.uniform(lo, hi, (T, ngen, 2)),
                         "line": rng.uniform(lo, hi, (T, nline, 8))}
    mask = np.ones(nline)
    mask[-5:] = 0.0
    t = torch.tensor
    gd = SimpleNamespace(
        line_mask=t(mask), c2=t(rng.uniform(0, 0.1, ngen)),
        c1=t(rng.uniform(0, 40, ngen)), c0=t(rng.uniform(0, 500, ngen)),
        baseMVA=100.0, mesh=None, ngen=ngen, nbus=0)
    ramp_mask = torch.ones((T, 1), dtype=torch.float64)
    ramp_mask[0, 0] = 0.0
    model = SimpleNamespace(grid=gd, T=T, ramp_mask=ramp_mask,
                            _v_pg_prev=lambda ac: MP.ModelMpacopf._v_pg_prev(
                                None, ac))
    return mpacopf_solution_from_numpy(d), model


@pytest.mark.parametrize("T,ngen,nline", [(3, 3, 9), (4, 45, 510),
                                          (2, 700, 4000)])
def test_residual_tree_matches_torch_sum(T, ngen, nline):
    """The residual kernels' layout and per-period fixed tree, reproduced
    with torch ops (``residual_partials_plain``, ``residual_final_plain``:
    13 rows of block sums per period, then the six scalars), against the
    plain hook's ``torch.sum``: rp and rd bit for bit, each (row, period)'s
    block sums adding up to the plain per-period sums, the scalars within
    rounding of the terms' magnitudes. (2, 700, 4000) gives 134 blocks a
    period, more than one lap of a warp's 32 lanes in the final pass."""
    sol, m = _tree_inputs(T, ngen, nline, seed=ngen)
    rp, rd, part = MC.residual_partials_plain(sol, m)
    nb = MC.residual_blocks(ngen, nline)
    assert part.shape == (MC.LINE_SUMS + MC.REST_SUMS, T, nb)
    rp_p, rd_p, sc_p = MP.residual_update_plain(sol, m)
    for a, b in ((rp, rp_p), (rd, rd_p)):
        assert torch.equal(a.gen, b.gen) and torch.equal(a.line, b.line)
    ac, rpm = sol.acopf, sol.ramp
    msk = m.grid.line_mask[:, None]
    ax = Blocks(gen=rp.gen - ac.z.gen, line=rp.line - ac.z.line)
    rp_r = (rpm.u - m._v_pg_prev(ac) + rpm.z) * m.ramp_mask
    rd_r = (rpm.z - rpm.z_prev) * m.ramp_mask
    z_r = rpm.z * m.ramp_mask
    ramp = [rp_r, rd_r, z_r, rp_r - z_r]
    sums = part.sum(dim=2)   # (13, T)
    for r, b in enumerate((rp, rd, ac.z, ax)):
        want = torch.sum(b.line * b.line * msk, dim=(1, 2))
        mag = torch.sum((b.line * b.line * msk).abs(), dim=(1, 2))
        assert bool(((sums[r] - want).abs() <= 1e-13 * mag).all())
        want = torch.sum(b.gen * b.gen, dim=(1, 2))
        assert bool(((sums[4 + r] - want).abs() <= 1e-13 * want).all())
        want = torch.sum(ramp[r] * ramp[r], dim=1)
        assert bool(((sums[8 + r] - want).abs() <= 1e-13 * want).all())
    pg = ac.u.gen[..., 0] * m.grid.baseMVA
    gd = m.grid
    obj_mag = torch.sum((gd.c2 * (pg * pg)).abs() + (gd.c1 * pg).abs()
                        + gd.c0.abs())
    sc = MC.residual_final_plain(part[:MC.LINE_SUMS], part[MC.LINE_SUMS:])
    assert sc.shape == (len(MC.SCALARS),)
    for i, k in enumerate(MC.SCALARS):
        got, ref = float(sc[i]), float(sc_p[k])
        if k in ("objval", "auglag"):
            assert abs(got - ref) <= 1e-13 * float(obj_mag)
        else:
            assert abs(got - ref) <= 1e-13 * abs(ref)
    # a second run is bit-equal; the tree does not depend on the data
    _, _, again = MC.residual_partials_plain(sol, m)
    assert torch.equal(part, again)


def test_hook_bounds_at_synth_2869_x_8():
    """The multi-period hook kernels' byte counts at synthetic 2869 buses x
    8 periods (4,877 lines, 430 generators: the ADMM blocks of all periods
    hold 319,008 values, 2.55 MB in fp64): z reads five vectors, the ramp's
    four rows and v's pg column before the last period, writes one and the
    ramp's z, 15.5 MB; l and lz 7.7 MB; the residual's first pass 15.6 MB;
    the bus values 15.4 MB; the ramp pack under 0.8 MB; each bound by
    bytes, at 3.35 TB/s."""
    T, ngen, nline, nbus = 8, 430, 4877, 2869
    nb = MC.residual_blocks(ngen, nline)
    assert nb == 158
    n = T * (2 * ngen + 8 * nline)
    assert n == 319_008
    G, B = T * ngen, (T - 1) * ngen
    want = {"mp_z": (6 * n + 5 * G + B) * 8 + 8,
            "mp_l": (3 * n + 3 * G) * 8 + 8,
            "mp_residual_partials": (6 * n + 3 * G + B + 3 * ngen + nline
                                     + 13 * T * nb) * 8,
            "mp_bus_values": (48 * T * nline + 12 * G + 4 * B + nline) * 8,
            "mp_ramp_pack": (31 * B + G + 5 * ngen) * 8 + B}
    for name, nbytes in want.items():
        got = bounds.mpacopf_hook_bytes(
            name, T, ngen, nline, nbus, 8, nb,
            scalar_tensor=name in ("mp_z", "mp_l"))
        assert got["total"] == nbytes, name
        ms, by = bounds.bound(got["total"], bounds.mpacopf_hook_ops(
            name, T, ngen, nline, nbus, nb))
        assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    assert bounds.mpacopf_hook_bytes("mp_z", T, ngen, nline, nbus, 8,
                                     scalar_tensor=True)["total"] == (
        15_474_072)
    one = bounds.mpacopf_hook_bytes("mp_generator_unpack", 1, ngen, nline,
                                    nbus, 8)
    assert one["write"] == 2 * ngen * 8
    assert set(bounds._MP_VALUES) == set(MC.KERNELS) == set(
        bounds._MP_OPS)
