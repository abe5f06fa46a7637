"""The ACOPF hook wrappers (``exaadmm_tpu_torch/ops/acopf_cuda.py``) on the
CPU, where they run their plain versions, against the plain functions and
the JAX hooks; their refusals; the model's hooks going through them; and
the residual kernels' fixed summation tree, reproduced with torch ops.

Inputs: case9, and a synthetic case of 300 buses (seed 3) in both
packages, with an ADMM state drawn from a numpy seed and handed to both as
numpy arrays.

Tolerances:
- a wrapper on CPU tensors against the plain function: bit for bit (it
  runs the plain function);
- against the JAX hooks, fp64: 1e-12 of each array's largest magnitude,
  as ``tests/test_torch_kernels.py`` holds the plain functions (the bus
  sums run in another order, and the 2x2 bus solve amplifies that);
- the residual's fixed tree against ``torch.sum``, fp64: each sum within
  1e-13 of the sum of its terms' magnitudes, the square roots 1e-12
  relative: the same terms added in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import kernels as JK
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import Blocks as JBlocks
from exaadmm_tpu.utils.environment import BranchALMState as JALM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.environment import Solution as JSolution
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.models.acopf import kernels as K
from exaadmm_tpu_torch.models.acopf import model as M
from exaadmm_tpu_torch.ops import acopf_cuda as A
from exaadmm_tpu_torch.ops import bounds
from exaadmm_tpu_torch.utils.convert import solution_from_numpy
from exaadmm_tpu_torch.utils.environment import Blocks, Parameters
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from .test_torch_threads import one_torch_thread  # noqa: F401

BETA = 1e3
KEYS = ("u", "v", "l", "rho", "z", "z_prev", "lz", "rp", "rd")
CASES = ("case9", "synthetic300")


def _close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def _data(name, case9_path):
    if name == "case9":
        return (opf_loaddata(case9_path, verbose=0),
                jax_opf_loaddata(case9_path, verbose=0))
    return synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)


def _state(tmodel, seed=0):
    """A random ADMM state over the model's shapes, as numpy arrays."""
    rng = np.random.default_rng(seed)
    ngen, nl = tmodel.grid.ngen, tmodel.grid.nline_padded
    d = {}
    for k in KEYS:
        if k == "rho":
            d[k] = {"gen": rng.uniform(1e2, 1e5, (ngen, 2)),
                    "line": rng.uniform(1e2, 1e5, (nl, 8))}
        else:
            d[k] = {"gen": rng.normal(0, 1, (ngen, 2)),
                    "line": rng.normal(0, 1, (nl, 8))}
    d["branch_alm"] = {"lam1": rng.normal(0, 1, nl),
                       "lam2": rng.normal(0, 1, nl),
                       "mu": rng.uniform(10, 1e3, nl)}
    return d


def _jax_solution(d):
    blocks = {k: JBlocks(gen=jnp.asarray(d[k]["gen"]),
                         line=jnp.asarray(d[k]["line"])) for k in KEYS}
    alm = d["branch_alm"]
    return JSolution(**blocks, branch_alm=JALM(
        lam1=jnp.asarray(alm["lam1"]), lam2=jnp.asarray(alm["lam2"]),
        mu=jnp.asarray(alm["mu"])))


@pytest.fixture(scope="module", params=CASES)
def state(request, case9_path):
    """Both packages' models of one case (lines padded to a multiple of 4)
    and one random state, obj_scale 2 so the effective costs differ from
    the raw ones."""
    tdata, jdata = _data(request.param, case9_path)
    tmodel = M.build_model(tdata, Parameters(verbose=0, obj_scale=2.0),
                           pad_lines_to=4)
    jmodel = JM.build_model(jdata, JParameters(verbose=0, obj_scale=2.0),
                            pad_lines_to=4)
    d = _state(tmodel)
    return dict(tmodel=tmodel, jmodel=jmodel, tsol=solution_from_numpy(d),
                jsol=_jax_solution(d))


def _wrapped_and_plain(name, tm, s):
    """(the wrapper's outputs, the plain function's) of hook ``name`` as
    lists of tensors."""
    wrapped, plain, _ = _calls(name, tm, s)
    return _flat(wrapped()), _flat(plain())


def _flat(x):
    if isinstance(x, Blocks):
        return [x.gen, x.line]
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    if isinstance(x, dict):
        return [x[k] for k in A.SCALARS]
    return [x]


def _calls(name, tm, s):
    """(the wrapper, its plain version, the wrapper given a destination
    ``out``, or None where it takes none) of hook ``name``."""
    gd = tm.grid
    bt = torch.tensor(BETA, dtype=torch.float64)

    agg = torch.randn(gd.nbus, 8, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1)).abs()
    gsum = torch.randn(gd.nbus, 4, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2)).abs()
    wtm = K.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd)
    part = A.residual_partials(s, gd)[2]
    into = {
        "generator_update": lambda out: A.generator_update(
            s.u.gen, s.v.gen, s.z.gen, s.l.gen, s.rho.gen, gd.pgmin,
            gd.pgmax, gd.qgmin, gd.qgmax, gd.c2, gd.c1, gd.baseMVA,
            obj_scale=tm.par.obj_scale, out=out),
        "bus_update": lambda out: A.bus_update(s.u, s.z, s.l, s.rho, gd,
                                               out=out),
        "bus_writeback": lambda out: A.bus_writeback(s.u, s.z, s.l, s.rho,
                                                     wtm, gd, out=out),
        "z_update": lambda out: A.z_update(s.u, s.v, s.l, s.rho, s.lz, bt,
                                           out=out),
        "l_update": lambda out: A.l_update(s.z, s.lz, BETA, out=out),
        "residual_partials": lambda out: A.residual_partials(
            s, gd, out=None if out is None else out[:2]),
        "residual_final": lambda out: A.residual_final(
            part[:A.LINE_SUMS], part[A.LINE_SUMS:], bt, out=out),
        "residual_update": lambda out: A.residual_update(s, gd, bt, out=out),
    }
    calls = {
        "generator_update": (
            lambda: A.generator_update(
                s.u.gen, s.v.gen, s.z.gen, s.l.gen, s.rho.gen, gd.pgmin,
                gd.pgmax, gd.qgmin, gd.qgmax, gd.c2, gd.c1, gd.baseMVA,
                obj_scale=tm.par.obj_scale),
            lambda: K.generator_update(
                s.u.gen, s.v.gen, s.z.gen, s.l.gen, s.rho.gen, gd.pgmin,
                gd.pgmax, gd.qgmin, gd.qgmax, tm.c2_eff, tm.c1_eff,
                gd.baseMVA)),
        "bus_update": (lambda: A.bus_update(s.u, s.z, s.l, s.rho, gd),
                       lambda: K.bus_update(s.u, s.z, s.l, s.rho, gd)),
        "bus_values": (lambda: A.bus_values(s.u, s.z, s.l, s.rho, gd),
                       lambda: (K.bus_arc_values(s.u, s.z, s.l, s.rho, gd),
                                K.bus_gen_values(s.u, s.z, s.l, s.rho))),
        "bus_solve": (lambda: A.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd),
                      lambda: K.bus_solve(agg, gsum, gd, gd.Pd, gd.Qd)),
        "bus_writeback": (
            lambda: A.bus_writeback(s.u, s.z, s.l, s.rho, wtm, gd),
            lambda: K.bus_writeback(s.u, s.z, s.l, s.rho, wtm, gd)),
        "z_update": (lambda: A.z_update(s.u, s.v, s.l, s.rho, s.lz, bt),
                     lambda: K.z_update(s.u, s.v, s.l, s.rho, s.lz, bt)),
        "l_update": (lambda: A.l_update(s.z, s.lz, BETA),
                     lambda: K.l_update(s.z, s.lz, BETA)),
        "lz_update": (lambda: A.lz_update(s.z, s.lz, bt, 1e12),
                      lambda: K.lz_update(s.z, s.lz, bt, 1e12)),
        "residual_update": (lambda: A.residual_update(s, gd, bt),
                            lambda: K.residual_update(s, gd, bt)),
        "residual_partials": (lambda: A.residual_partials(s, gd),
                              lambda: A.residual_partials_plain(s, gd)),
        "residual_final": (
            lambda: A.residual_final(part[:A.LINE_SUMS], part[A.LINE_SUMS:],
                                     bt),
            lambda: A.residual_final_plain(part[:A.LINE_SUMS],
                                           part[A.LINE_SUMS:], bt)),
    }
    wrapped, plain = calls[name]
    return wrapped, plain, into.get(name)


def _destination(ref):
    """Zeroed tensors shaped as the result ``ref``, in its structure (the
    residual's scalars as one (6,) tensor)."""
    if isinstance(ref, Blocks):
        return Blocks(gen=torch.zeros_like(ref.gen),
                      line=torch.zeros_like(ref.line))
    if isinstance(ref, tuple):
        return tuple(_destination(x) for x in ref)
    if isinstance(ref, dict):
        return torch.zeros(len(A.SCALARS), dtype=ref[A.SCALARS[0]].dtype)
    return torch.zeros_like(ref)


INTO = ("generator_update", "bus_update", "bus_writeback", "z_update",
        "l_update", "residual_partials", "residual_final", "residual_update")


@pytest.mark.parametrize("name", [
    "generator_update", "bus_update", "bus_values", "bus_solve",
    "bus_writeback", "z_update", "l_update", "lz_update", "residual_update"]
    + [f"{k}:out" for k in INTO])
def test_wrapper_on_cpu_is_the_plain_version(state, name):
    """A wrapper on CPU tensors is its plain version, bit for bit; given
    ``out`` (``<hook>:out``), it returns that very destination, holding
    what it returns without one."""
    name, _, into = name.partition(":")
    if not into:
        got, ref = _wrapped_and_plain(name, state["tmodel"], state["tsol"])
    else:
        wrapped, _, with_out = _calls(name, state["tmodel"], state["tsol"])
        fresh = wrapped()
        dst = _destination(fresh)
        res = with_out(dst)
        want = _flat(dst)
        if name == "residual_update":
            assert [t.data_ptr() for t in _flat(res[2])] == [
                t.data_ptr() for t in dst[2].unbind()]
            assert torch.equal(dst[2], torch.stack(_flat(fresh[2])))
            res, want = res[:2], want[:4]
        elif name == "residual_partials":
            res, want, fresh = res[:2], want[:4], fresh[:2]
        got = _flat(res)
        assert len(got) == len(want)
        assert all(a is b for a, b in zip(got, want))
        ref = _flat(fresh)[:len(got)]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_wrappers_match_jax(state):
    tm, jm = state["tmodel"], state["jmodel"]
    ts, js = state["tsol"], state["jsol"]
    tg, jg = tm.grid, jm.grid
    got = A.generator_update(ts.u.gen, ts.v.gen, ts.z.gen, ts.l.gen,
                             ts.rho.gen, tg.pgmin, tg.pgmax, tg.qgmin,
                             tg.qgmax, tg.c2, tg.c1, tg.baseMVA,
                             obj_scale=tm.par.obj_scale)
    ref = JK.generator_update(js.u.gen, js.v.gen, js.z.gen, js.l.gen,
                              js.rho.gen, jg.pgmin, jg.pgmax, jg.qgmin,
                              jg.qgmax, jm.c2_eff, jm.c1_eff, jg.baseMVA)
    _close(got.numpy(), ref)
    got = A.bus_update(ts.u, ts.z, ts.l, ts.rho, tg)
    ref = JK.bus_update(js.u, js.z, js.l, js.rho, jg, bus_backend="segsum")
    _close(got.gen.numpy(), ref.gen)
    _close(got.line.numpy(), ref.line)
    zt = A.z_update(ts.u, ts.v, ts.l, ts.rho, ts.lz, BETA)
    zj = JK.z_update(js.u, js.v, js.l, js.rho, js.lz, BETA)
    pairs = [(zt, zj), (A.l_update(zt, ts.lz, BETA),
                        JK.l_update(zj, js.lz, BETA)),
             (A.lz_update(zt, ts.lz, BETA, 1e12),
              JK.lz_update(zj, js.lz, BETA, 1e12))]
    for a, b in pairs:
        _close(a.gen.numpy(), b.gen)
        _close(a.line.numpy(), b.line)
    rpt, rdt, st = A.residual_update(ts, tg, BETA)
    rpj, rdj, sj = JK.residual_update(js, jg, BETA)
    for a, b in ((rpt, rpj), (rdt, rdj)):
        _close(a.gen.numpy(), b.gen)
        _close(a.line.numpy(), b.line)
    for k in sj:
        _close(float(st[k]), float(sj[k]))


@pytest.mark.parametrize("bad", ["meta", "float16"])
def test_wrapper_refuses_and_runs_no_plain_version(bad, monkeypatch):
    """A tensor on another device than the CPU or the card, or of another
    dtype than float32/float64, raises before any plain version runs."""
    def never(*a, **k):
        raise AssertionError("the plain version ran")

    for name in ("z_update", "l_update", "lz_update", "generator_update",
                 "bus_update", "residual_update"):
        monkeypatch.setattr(K, name, never)
    if bad == "meta":
        kw, err = dict(device="meta", dtype=torch.float64), ValueError
    else:
        kw, err = dict(dtype=torch.float16), TypeError
    b = Blocks(gen=torch.ones((3, 2), **kw), line=torch.ones((9, 8), **kw))
    with pytest.raises(err):
        A.z_update(b, b, b, b, b, BETA)
    with pytest.raises(err):
        A.l_update(b, b, BETA)
    with pytest.raises(err):
        A.lz_update(b, b, BETA, 1e12)
    g = b.gen
    col = torch.ones(3, **kw)
    with pytest.raises(err):
        A.generator_update(g, g, g, g, g, col, col, col, col, col, col,
                           100.0)


def test_kernel_input_checks():
    """What the kernels take, checked as on the card: a non-contiguous
    block, a mixed dtype, a block of the wrong length, an index array that
    is not int64, a scalar tensor that is not 0-d of the blocks' dtype."""
    g, ln = torch.ones((3, 2)), torch.ones((9, 8))
    g64, ln64 = g.double(), ln.double()
    A.validate("ok", [g64, ln64], [torch.zeros(9, dtype=torch.int64)], 3, 9)
    with pytest.raises(ValueError, match="contiguous"):
        A.validate("t", [g64, torch.ones((8, 9)).double().t()], (), 3, 9)
    with pytest.raises(ValueError, match="contiguous"):
        A.validate("t", [g64, ln])
    with pytest.raises(ValueError, match="line block"):
        A.validate("t", [g64, ln64], (), 3, 10)
    with pytest.raises(ValueError, match="generator block"):
        A.validate("t", [g64, ln64], (), 4, 9)
    with pytest.raises(ValueError, match="int64"):
        A.validate("t", [g64], [torch.zeros(9, dtype=torch.int32)])
    with pytest.raises(ValueError, match="0-d"):
        A._scalar(torch.ones(1, dtype=torch.float64), "t", torch.float64,
                  g64.device)
    with pytest.raises(ValueError, match="0-d"):
        A._scalar(torch.tensor(1.0), "t", torch.float64, g64.device)
    assert A._scalar(2.5, "t", torch.float64, g64.device) == (None, 2.5)


@pytest.mark.parametrize("path", ["fused", "host", "sorted", "mixed"])
def test_model_hooks_go_through_the_wrappers(case9_path, monkeypatch, path):
    """``ModelAcopf``'s closed-form hooks call ``ops/acopf_cuda.py`` on
    every path of a solve (the fused loop, the host loop, sorted lines,
    mixed precision), each with inputs the kernels take (checked as on the
    card), once an inner iteration, and lz once an outer round in the
    fused loop (its tail) and in every round that did not solve in the
    host loop."""
    calls = {}
    route = A._route

    def counted(what, floats, ints=(), ngen=None, nline=None):
        calls[what] = calls.get(what, 0) + 1
        A.validate(what, floats, ints, ngen, nline)
        return route(what, floats, ints, ngen, nline)

    monkeypatch.setattr(A, "_route", counted)
    par = Parameters(verbose=0, outer_iterlim=3, outer_eps=2e-5,
                     sort_lines=path == "sorted",
                     mixed_precision=path == "mixed")
    model = M.build_model(opf_loaddata(case9_path, verbose=0), par)
    sol = M.init_solution(model, 4e2, 4e4)
    if path == "host":
        _, info = two.admm_two_level(model, sol)
        lz = info.outer - (info.status == "Solved")
    else:
        _, info = two.two_level_driver(model)(model, sol)
        lz = info.outer
    n = info.cumul
    assert calls == {"generator_update": n, "bus_update": n, "z_update": n,
                     "l_update": n, "residual_update": n, "lz_update": lz}


def _tree_inputs(ngen, nline, seed):
    """A random state of ``ngen`` generators and ``nline`` lines (the last
    5 padded) and a grid-like record with the mask and costs."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    d = {}
    for k in KEYS:
        lo, hi = (1e2, 1e5) if k == "rho" else (-3.0, 3.0)
        d[k] = {"gen": rng.uniform(lo, hi, (ngen, 2)),
                "line": rng.uniform(lo, hi, (nline, 8))}
    d["branch_alm"] = {"lam1": np.zeros(nline), "lam2": np.zeros(nline),
                       "mu": np.ones(nline)}
    mask = np.ones(nline)
    mask[-5:] = 0.0
    t = torch.tensor
    gd = SimpleNamespace(
        line_mask=t(mask), c2=t(rng.uniform(0, 0.1, ngen)),
        c1=t(rng.uniform(0, 40, ngen)), c0=t(rng.uniform(0, 500, ngen)),
        baseMVA=100.0, mesh=None)
    return solution_from_numpy(d), gd


@pytest.mark.parametrize("ngen,nline", [(3, 9), (45, 510), (700, 4000)])
def test_residual_tree_matches_torch_sum(ngen, nline):
    """The residual kernels' layout and fixed tree, reproduced with torch
    ops (``residual_partials_plain``, ``residual_final_plain``: 15 rows of
    block sums, then the six scalars), against the plain hook's
    ``torch.sum``: rp and rd bit for bit, the block sums' rows adding up
    to the plain dot products, the scalars within rounding of the terms'
    magnitudes. (700, 4000) gives 138 blocks, more than one lap of a
    warp's 32 lanes in the final pass."""
    sol, gd = _tree_inputs(ngen, nline, seed=ngen)
    rp, rd, part = A.residual_partials_plain(sol, gd)
    nb = A.residual_blocks(ngen, nline)
    assert part.shape == (A.LINE_SUMS + A.GEN_SUMS, nb)
    rp_p, rd_p, sc_p = K.residual_update(sol, gd, BETA)
    for a, b in ((rp, rp_p), (rd, rd_p)):
        assert torch.equal(a.gen, b.gen) and torch.equal(a.line, b.line)
    m = gd.line_mask[:, None]
    ax = Blocks(gen=rp.gen - sol.z.gen, line=rp.line - sol.z.line)
    terms = [(rp, rp), (rd, rd), (sol.z, sol.z), (ax, ax), (sol.lz, sol.z),
             (sol.l, rp), (sol.rho, Blocks(gen=rp.gen * rp.gen,
                                           line=rp.line * rp.line))]
    line_mag = [torch.sum((a.line * b.line * m).abs()) for a, b in terms]
    gen_mag = [torch.sum((a.gen * b.gen).abs()) for a, b in terms]
    pg = sol.u.gen[:, 0] * gd.baseMVA
    obj_terms = gd.c2 * (pg * pg) + gd.c1 * pg + gd.c0
    obj_mag = torch.sum((gd.c2 * (pg * pg)).abs() + (gd.c1 * pg).abs()
                        + gd.c0.abs())
    sums = part.sum(dim=1)
    for r in range(A.LINE_SUMS):
        a, b = terms[r]
        want = torch.sum(a.line * b.line * m)
        assert abs(float(sums[r] - want)) <= 1e-13 * float(line_mag[r])
        want = torch.sum(a.gen * b.gen)
        assert abs(float(sums[A.LINE_SUMS + r] - want)) <= 1e-13 * float(
            gen_mag[r])
    assert abs(float(sums[-1] - obj_terms.sum())) <= 1e-13 * float(obj_mag)
    sc = A.residual_final_plain(part[:A.LINE_SUMS], part[A.LINE_SUMS:], BETA)
    assert sc.shape == (len(A.SCALARS),)
    aug_mag = (obj_mag + gen_mag[4] + line_mag[4]
               + 0.5 * BETA * (gen_mag[2] + line_mag[2]) + gen_mag[5]
               + line_mag[5] + 0.5 * (gen_mag[6] + line_mag[6]))
    for i, k in enumerate(A.SCALARS):
        got, ref = float(sc[i]), float(sc_p[k])
        if k == "objval":
            assert abs(got - ref) <= 1e-13 * float(obj_mag)
        elif k == "auglag":
            assert abs(got - ref) <= 1e-13 * float(aug_mag)
        else:
            assert abs(got - ref) <= 1e-12 * abs(ref)
    # a second run is bit-equal; the tree does not depend on the data
    _, _, again = A.residual_partials_plain(sol, gd)
    assert torch.equal(part, again)


def test_hook_bounds_at_synth_9241():
    """The hook kernels' byte counts at the shapes of synthetic 9241 buses
    (15,710 lines, 1,386 generators: one ADMM vector of 128,452 values,
    1.03 MB in fp64): z reads five vectors and writes one, 6.17 MB; l and
    lz 3.08 MB; the residual's first pass reads seven and writes two and
    its 15 x 502 block sums, 9.47 MB; the bus values 6.29 MB; the bus
    solve 1.48 MB; each bound by bytes."""
    ngen, nline, nbus = 1386, 15710, 9241
    nb = A.residual_blocks(ngen, nline)
    assert nb == 502
    n = 2 * ngen + 8 * nline
    want = {"acopf_z": 6 * n * 8 + 8, "acopf_l": 3 * n * 8,
            "acopf_residual_partials": (9 * n + nline + 3 * ngen
                                        + 15 * nb) * 8,
            "acopf_bus_values": (33 * nline + 8 * ngen + 16 * nline
                                 + 4 * ngen) * 8,
            "acopf_bus_solve": 20 * nbus * 8}
    for name, nbytes in want.items():
        got = bounds.hook_bytes(name, ngen, nline, nbus, 8, nb,
                                scalar_tensor=name == "acopf_z")
        assert got["total"] == nbytes
        ms, by = bounds.bound(got["total"], bounds.hook_ops(
            name, ngen, nline, nbus, nb))
        assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    assert bounds.hook_bytes("acopf_z", ngen, nline, nbus, 8)["total"] == (
        6_165_696)
    assert set(bounds._HOOK_VALUES) == set(A.KERNELS) == set(
        bounds._HOOK_OPS)
