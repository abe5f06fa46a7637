"""The port's fused (device-resident) drivers on the CPU.

- Against the port's own host loops: the same bodies, hooks and break
  conditions, so the same status and counts, equal info scalars and every
  solution tensor bit-identical (``torch.equal``), fp64, on every path.
- Against the JAX package's ``admm_two_level_fused`` on case9 (8 outer
  iterations, 442 inner, outer_eps 2e-5): exact outer and cumul, the
  objective within 1e-10 relative, and u.gen, u.line and lz.line within
  1e-10 of each array's largest magnitude (at least 1): the tolerance of
  the JAX package's own fused-against-host test
  (``tests/test_fused_driver.py``), scaled for lz, whose entries reach 2.2e3
  there. The two libraries' sin/cos/pow round differently; measured:
  2.2e-11 on u (entries about 1), 1.8e-9 on lz.line (8.2e-13 of its scale).
- The loop bodies read nothing back: they run while every read-back of a
  tensor raises (the kernel wrappers excepted: on the card each is one
  launch, on the CPU its plain version loops on the host).
- Which driver each entry point picks, and the launch counters under
  replay.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu.algorithms.admm_two_level import \
    admm_two_level_fused as jax_fused
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import IterationInformation as JInfo
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu_torch.algorithms import admm_one_level as one
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.algorithms.carry import Carry, leaves
from exaadmm_tpu_torch.interface import solve_acopf as iface_acopf
from exaadmm_tpu_torch.interface import solve_acopf_rolling as iface_rolling
from exaadmm_tpu_torch.interface import solve_mpacopf as iface_mpacopf
from exaadmm_tpu_torch.interface import solve_mpec as iface_mpec
from exaadmm_tpu_torch.interface import solve_qpsub as iface_qpsub
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.models.qpsub import model as Q
from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
from exaadmm_tpu_torch.ops import bus_cuda, graph_loop, tron_cuda
from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                 Parameters)
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

from . import qpsub_fixture as fx
from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE9 = os.path.join(ROOT, "data", "case9.m")
DEMAND9 = os.path.join(ROOT, "data", "case9_demand")
INFO_FIELDS = ("status", "outer", "inner", "cumul", "objval", "auglag",
               "primres", "dualres", "mismatch", "norm_z_curr",
               "norm_z_prev", "max_cviol", "eps_pri")
KW9 = dict(rho_pq=4e2, rho_va=4e4, verbose=0, device="cpu")


def _qp9():
    """The case9 QP of the reference test, linearized at the base point of
    ``tests/qpsub_fixture.py``."""
    data = opf_loaddata(CASE9, verbose=0)
    va = np.zeros(data.nbus)
    va[data.line_from] = fx.line_var[4]
    va[data.line_to] = fx.line_var[5]
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        fx.pg, fx.qg, np.sqrt(fx.bus_w), va))
    return [qp[k] for k in QP_KEYS]


def _one(res):
    return [(res.info, res.solution)]


# (entry-point call, its (info, solution or None) pairs); each case is a
# pin of the port's CPU suite, cut where the pair would pass a minute (the
# QP to 300 iterations, the mixed and the multi-period solves to 6 and 10
# outer iterations, which on the CPU run about 70 and 40 ms an inner one)
CASES = {
    "case9": (lambda: E.solve_acopf(CASE9, outer_eps=2e-5, outer_iterlim=25,
                                    **KW9), _one),
    "case9 no line limits": (lambda: E.solve_acopf(
        CASE9, outer_eps=2e-4, outer_iterlim=25, use_linelimit=False,
        **KW9), _one),
    "case9 mixed precision": (lambda: E.solve_acopf(
        CASE9, outer_eps=2e-4, outer_iterlim=6, mixed_precision=True,
        **KW9), _one),
    "case9 x 3 periods": (lambda: E.solve_mpacopf(
        CASE9, DEMAND9, end_period=3, outer_iterlim=10, warm_start=False,
        **KW9), _one),
    "MPEC with storage": (lambda: E.solve_acopf_mpec(
        CASE9, outer_iterlim=40, outer_eps=2e-4, storage_ratio=0.3,
        storage_charge_max=0.1, **KW9), _one),
    "rolling 3 periods": (lambda: E.solve_acopf_rolling(
        CASE9, DEMAND9, outer_iterlim=25, outer_eps=2e-4, end_period=3,
        tight_factor=1.0, **KW9),
        lambda r: [(i, None) for i in r[1][:-1]] + [(r[1][-1],
                                                     r[0].solution)]),
    "case9 QP": (lambda: E.solve_qpsub(
        CASE9, *_qp9(), 1e5, outer_iterlim=300, scale=1e-4, rho_pq=4e3,
        rho_va=4e3, outer_eps=2e-6, verbose=0, device="cpu"), _one),
}


def _host_drivers(monkeypatch):
    """Every entry point with its host loop at verbose 0."""
    for mod in (iface_acopf, iface_rolling, iface_mpacopf, iface_mpec):
        monkeypatch.setattr(mod, "two_level_driver",
                            lambda model, mesh=None: two.admm_two_level)
    monkeypatch.setattr(iface_qpsub, "one_level_driver",
                        lambda model, mesh=None: one.admm_one_level)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_host_loop(case, monkeypatch):
    call, periods = CASES[case]
    fused = periods(call())
    with monkeypatch.context() as m:
        _host_drivers(m)
        host = periods(call())
    assert len(fused) == len(host)
    for (i_f, s_f), (i_h, s_h) in zip(fused, host):
        for k in INFO_FIELDS:
            assert getattr(i_f, k) == getattr(i_h, k), k
        if s_f is not None:
            for n, (a, b) in enumerate(zip(leaves(s_f), leaves(s_h),
                                           strict=True)):
                assert a.dtype == b.dtype == torch.float64
                assert torch.equal(a, b), f"solution tensor {n}"
    if case == "case9":
        assert (fused[0][0].status, fused[0][0].outer,
                fused[0][0].cumul) == ("Solved", 25, 1087)


def test_fused_matches_jax_fused(case9_path):
    jpar = JParameters(verbose=0, outer_iterlim=8, outer_eps=2e-5)
    jmodel = JM.build_model(jax_opf_loaddata(case9_path, verbose=0), jpar,
                            dtype=jnp.float64)
    js, ji = jax_fused(jmodel, JM.init_solution(jmodel, 4e2, 4e4), JInfo())
    par = Parameters(verbose=0, outer_iterlim=8, outer_eps=2e-5)
    model = TM.build_model(opf_loaddata(case9_path, verbose=0), par)
    ts, ti = two.admm_two_level_fused(model,
                                      TM.init_solution(model, 4e2, 4e4))
    assert (ti.status, ti.outer, ti.cumul) == (ji.status, ji.outer, ji.cumul)
    assert ti.objval == pytest.approx(ji.objval, rel=1e-10)
    assert par.beta == pytest.approx(jpar.beta, rel=1e-12)
    for got, ref in ((ts.u.gen, js.u.gen), (ts.u.line, js.u.line),
                     (ts.lz.line, js.lz.line)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=0,
            atol=1e-10 * max(1.0, float(np.abs(ref).max())))


def test_fused_solver_is_reused_across_solves(case9_path):
    """One solver, two solves from the same start: the same bits (the
    carry is reset, the first result is a copy of its own); a call with
    loads the solver was not built with raises."""
    par = Parameters(verbose=0, outer_iterlim=3, outer_eps=2e-5)
    model = TM.build_model(opf_loaddata(case9_path, verbose=0), par)
    run = two.make_fused_solver(model)
    s1, i1 = two.admm_two_level_fused(model, TM.init_solution(model, 4e2,
                                                              4e4), run=run)
    s2, i2 = two.admm_two_level_fused(model, TM.init_solution(model, 4e2,
                                                              4e4), run=run)
    assert (i1.outer, i1.cumul) == (i2.outer, i2.cumul) == (3, i1.cumul)
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2)))
    assert not any(a.data_ptr() == b.data_ptr()
                   for a, b in zip(leaves(s1), leaves(s2)))
    with pytest.raises(ValueError, match="built with"):
        two.admm_two_level_fused(model, TM.init_solution(model, 4e2, 4e4),
                                 run=run, Pd=model.grid.Pd)


_READBACKS = ("__bool__", "item", "tolist", "__float__", "__int__", "cpu",
              "numpy")


class _Guard:
    """Patch every read-back of a tensor to raise, except inside the kernel
    wrappers (``unguarded``)."""

    def __init__(self, monkeypatch):
        self.depth = 0
        for name in _READBACKS:
            orig = getattr(torch.Tensor, name)

            def guarded(t, *a, _orig=orig, _name=name, **k):
                if self.depth == 0:
                    raise AssertionError(f"Tensor.{_name} in a loop body")
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, guarded)
        for name in ("tron_alm_branch", "tron_alm_polar", "tron_alm_ramp",
                     "tron_alm_qpsub", "tron_alm_packed"):
            monkeypatch.setattr(tron_cuda, name,
                                self.unguarded(getattr(tron_cuda, name)))

    def unguarded(self, fn):
        def call(*a, **k):
            self.depth += 1
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
        return call


def test_two_level_bodies_read_nothing_back(case9_path, monkeypatch):
    """One outer prestep, two inner iterations and one outer tail of case9
    (with line limits, then without), and of case9 x 2 periods and the
    MPEC with storage, while every read-back raises."""
    data = opf_loaddata(case9_path, verbose=0)
    models = []
    for ll in (True, False):
        m = TM.build_model(data, Parameters(verbose=0), use_linelimit=ll)
        models.append((m, TM.init_solution(m, 4e2, 4e4)))
    from exaadmm_tpu_torch.interface.solve_mpec import build_model as mpec
    from exaadmm_tpu_torch.models.mpacopf import model as MP
    from exaadmm_tpu_torch.models.mpec import model as MM
    from exaadmm_tpu_torch.utils.opfdata import load_time_series
    pd, qd = load_time_series(DEMAND9)
    mp = MP.build_model(data, Parameters(verbose=0), pd, qd, end_period=2)
    models.append((mp, MP.init_solution(mp, 4e2, 4e4)))
    mm = mpec(data, Parameters(verbose=0), storage_ratio=0.3,
              storage_charge_max=0.1)
    models.append((mm, MM.init_solution(mm, 4e2, 4e4)))
    for model, sol in models:
        run = two.make_fused_solver(model)
        run._build(sol, IterationInformation(), None, None, None, None)
        c = run.carry
        run._reset(c, sol, IterationInformation())
        with monkeypatch.context() as m:
            _Guard(m)
            run._pre(c)
            run._inner(c)
            run._inner(c)
            run._tail(c)
            with pytest.raises(AssertionError, match="__bool__"):
                bool(c.v["outer_flag"])
        assert int(c.v["cumul"]) == 2 and int(c.v["outer"]) == 1


def test_one_level_body_reads_nothing_back(monkeypatch):
    data = opf_loaddata(CASE9, verbose=0)
    qp = dict(zip(QP_KEYS, _qp9()))
    model = Q.build_model(data, Parameters(verbose=0, scale=1e-4), qp)
    sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
    prep = model.solve_prep(sol)
    c = one.one_level_carry(sol)
    with monkeypatch.context() as m:
        _Guard(m)
        one.reset_one_level(c, sol, dual_tol=1e-6)
        one.set_one_level_flag(c, model.par.outer_iterlim, outer_tol=1e-6)
        for _ in range(2):
            one.one_level_body(prep, c, outer_tol=1e-6)
    assert int(c.v["it"]) == 2 and int(c.v["flag"]) == 1


def test_one_level_solver_is_reused_across_solves():
    """One one-level solver, solves at two rho: the second, which refills
    the solve's constants and the dual tolerance in the solver's buffers,
    gives the bits of a new solver's solve at that rho."""
    data = opf_loaddata(CASE9, verbose=0)
    qp = dict(zip(QP_KEYS, _qp9()))
    model = Q.build_model(data, Parameters(verbose=0, scale=1e-4,
                                           outer_iterlim=40), qp)
    run = one.make_one_level_solver(model)
    one.admm_one_level_fused(model, Q.init_solution(model, 4e3, 4e3),
                             run=run)
    s2, i2 = one.admm_one_level_fused(model, Q.init_solution(model, 1e3, 2e3),
                                      run=run)
    s3, i3 = one.admm_one_level_fused(model, Q.init_solution(model, 1e3, 2e3))
    for k in INFO_FIELDS:
        assert getattr(i2, k) == getattr(i3, k), k
    assert all(torch.equal(a, b) for a, b in zip(leaves(s2), leaves(s3),
                                                  strict=True))


def test_store_stages_aliases():
    """A body's output that is another buffer (z_prev = z) is copied out
    before the buffers are overwritten; where that buffer is not
    overwritten by the store (z written in place afterwards, as the hooks
    of a model that ``writes_into_carry`` do), it is copied straight, and
    the copy holds the old z exactly."""
    z, zp = torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0])
    from exaadmm_tpu_torch.utils.environment import Blocks
    c = Carry(Blocks(gen=z, line=zp), {})
    gen, line = c.state
    # new gen; line takes the old gen (an alias of a buffer)
    c.store(Blocks(gen=gen + 10.0, line=gen))
    assert c.state[0].tolist() == [11.0, 12.0]
    assert c.state[1].tolist() == [1.0, 2.0]
    assert c.copies == 3    # the clone of gen and the two copies

    # z_prev <- z with z left as it is: one copy, no clone; then z in place
    old = torch.tensor([0.1, 1.0 / 3.0], dtype=torch.float64)
    c = Carry(Blocks(gen=old, line=torch.zeros(2, dtype=torch.float64)), {})
    zb, zpb = c.state
    c.store(Blocks(gen=zb, line=zb))
    assert c.copies == 1 and c.state[0] is zb and c.state[1] is zpb
    torch.mul(zb, 3.0, out=zb)
    assert torch.equal(zpb, old) and not torch.equal(zb, old)
    # the carry's views: ``put`` of a view of its buffer copies nothing
    c = Carry(torch.zeros(1), {"res": torch.zeros(3)}, {"b": ("res", 1)})
    c.v["res"].copy_(torch.tensor([1.0, 2.0, 3.0]))
    assert float(c.v["b"]) == 2.0
    c.put("b", c.v["res"].unbind()[1])
    c.put("b", torch.tensor(5.0))
    assert c.v["res"].tolist() == [1.0, 5.0, 3.0]
    w = c.clone()
    assert w.v["b"].data_ptr() == w.v["res"][1].data_ptr()
    assert w.v["res"].data_ptr() != c.v["res"].data_ptr()


# (model, copies ``Carry.store`` makes in one inner iteration): ACOPF's
# hooks write into the carry, so z_prev's two copies and the new line rows
# of u (returned in a tensor of their own) are left; the multi-period
# model's hooks return fresh tensors, which the body copies in (z_prev's
# two clones and two copies among them)
STORE_COPIES = {
    "case9": (lambda: E.solve_acopf(CASE9, outer_iterlim=2, **KW9), 3),
    "case9 no line limits": (lambda: E.solve_acopf(
        CASE9, outer_iterlim=2, use_linelimit=False, **KW9), 3),
    "case9 x 2 periods": (lambda: E.solve_mpacopf(
        CASE9, DEMAND9, end_period=2, outer_iterlim=2, warm_start=False,
        **KW9), 27),
}


@pytest.mark.parametrize("case", list(STORE_COPIES))
def test_inner_body_store_copies(case, monkeypatch):
    """The copies ``Carry.store`` makes in each inner iteration of a fused
    solve run by the host (``graph_loop.run_on_host``)."""
    call, want = STORE_COPIES[case]
    seen = []
    inner = two.FusedSolver._inner

    def counted(self, c):
        n = c.copies
        inner(self, c)
        seen.append(c.copies - n)
    monkeypatch.setattr(two.FusedSolver, "_inner", counted)
    info = call().info
    assert len(seen) == info.cumul > 2
    assert set(seen) == {want}


def _spy(calls, name):
    def driver(model, sol, info=None, *args, **kwargs):
        calls.append(name)
        return sol, info or IterationInformation()
    return driver


@pytest.mark.parametrize("how", ["verbose=0", "verbose=1"])
def test_entry_points_pick_the_driver(how, monkeypatch):
    """verbose 0 reaches the fused drivers, verbose 1 the host loops, in
    every entry point (spies in place of the drivers)."""
    calls = []
    for name in ("admm_two_level", "admm_two_level_fused"):
        monkeypatch.setattr(two, name, _spy(calls, name))
    for name in ("admm_one_level", "admm_one_level_fused"):
        monkeypatch.setattr(one, name, _spy(calls, name))
    kw = dict(KW9, verbose=int(how[-1]), outer_iterlim=1)
    E.solve_acopf(CASE9, **kw)
    E.solve_acopf_mpec(CASE9, **kw)
    E.solve_acopf_rolling(CASE9, DEMAND9, end_period=2, **kw)
    E.solve_mpacopf(CASE9, DEMAND9, end_period=2, **kw)
    E.solve_qpsub(CASE9, *_qp9(), 1e5, **kw)
    suffix = "_fused" if how == "verbose=0" else ""
    assert calls == [f"admm_two_level{suffix}"] * 7 + [
        f"admm_one_level{suffix}"]


def _on_card(model=None, mesh=None):
    """A stand-in for a model on the card (the drivers read its parameters,
    ``nvar`` and its grid's device and mesh): ``model``'s parameters, its
    grid's mesh ``mesh``."""
    from types import SimpleNamespace
    return SimpleNamespace(
        par=model.par if model is not None else Parameters(verbose=0),
        nvar=10, grid=SimpleNamespace(
            pgmin=SimpleNamespace(device=torch.device("cuda")), mesh=mesh))


def test_driver_choice_rules(case9_path):
    """At verbose 0 the fused drivers run line sorting and any mesh whose
    collectives a graph can hold: NCCL on the card, any backend on the
    CPU. verbose 1 and time_hooks keep the host loop, and so does a gloo
    mesh on the card (its collectives are staged through host memory),
    which the fused solvers refuse by name."""
    from exaadmm_tpu_torch.parallel import sharding
    data = opf_loaddata(case9_path, verbose=0)

    def model(**par):
        return TM.build_model(data, Parameters(**dict(dict(verbose=0),
                                                      **par)))

    fused = two.admm_two_level_fused
    gloo, nccl = (sharding.Mesh(group=object(), rank=0, size=2, backend=b)
                  for b in ("gloo", "nccl"))
    assert two.two_level_driver(model()).func is fused
    sorted_driver = two.two_level_driver(model(sort_lines=True))
    assert sorted_driver.func is fused
    assert sorted_driver.keywords["run"].sorting
    for mesh in (gloo, nccl):
        assert two.two_level_driver(model(), mesh).func is fused
        assert two.two_level_driver(model(sort_lines=True), mesh).func is fused
    for m in (model(verbose=1), model(time_hooks=True)):
        assert two.two_level_driver(m) is two.admm_two_level
    assert two.two_level_driver(_on_card(), nccl).func is fused
    assert two.two_level_driver(_on_card(), gloo) is two.admm_two_level
    with pytest.raises(ValueError, match="gloo stages every collective"):
        two.make_fused_solver(_on_card(mesh=gloo))
    assert two.make_fused_solver(_on_card(mesh=nccl)).sorting is False

    q = Q.build_model(data, Parameters(verbose=0),
                      dict(zip(QP_KEYS, _qp9())))
    fused1 = one.admm_one_level_fused
    assert one.one_level_driver(q).func is fused1
    assert one.one_level_driver(q, gloo).func is fused1
    assert one.one_level_driver(_on_card(q), nccl).func is fused1
    assert one.one_level_driver(_on_card(q), gloo) is one.admm_one_level
    with pytest.raises(ValueError, match="gloo stages every collective"):
        one.make_one_level_solver(_on_card(q, mesh=gloo))


def test_launch_counts_under_replay(monkeypatch):
    """A wrapper counts a launch where it launches: eagerly one on the
    host; while a loop body is captured, a node that adds one to its slot
    of the loop's counters on the device at every replay (here on the CPU,
    where the node runs at once: one replay). The counters read back with
    the scalars after a run go to the host's counts; a slot that counted
    nothing adds nothing."""
    monkeypatch.setattr(tron_cuda, "launches", {"tron_alm_branch_f64": 5})
    monkeypatch.setattr(bus_cuda, "launches", 7)
    monkeypatch.setattr(graph_loop, "launches", 0)

    def branch(n):
        tron_cuda._add_launches("tron_alm_branch_f64", n)

    graph_loop.count_launch(branch, "tron_alm_branch_f64")
    assert tron_cuda.launches == {"tron_alm_branch_f64": 6}
    counts = graph_loop.DeviceCounts(torch.device("cpu"))
    loop_slot = counts.slot("graph_loop", graph_loop._count_set_condition)
    with counts.capturing():
        graph_loop.count_launch(branch, "tron_alm_branch_f64")
        graph_loop.count_launch(bus_cuda._add_launches, "bus_scatter")
        graph_loop.count_launch(bus_cuda._add_launches, "bus_scatter")
        counts.slot("tron_alm_polar_f64", branch)
    assert graph_loop._capturing is None
    assert tron_cuda.launches == {"tron_alm_branch_f64": 6}
    assert bus_cuda.launches == 7
    assert counts.values[:4].tolist() == [0, 1, 2, 0]
    # 40 more replays of the body, 84 runs of set_condition
    counts.values[1:3] *= 41
    loop_slot.fill_(84)
    loop = graph_loop.GraphLoop.__new__(graph_loop.GraphLoop)
    loop.counts = counts
    c = Carry(torch.zeros(2), {"it": torch.tensor(41)})
    assert c.read_back(("it",), loop) == {"it": 41.0}
    assert tron_cuda.launches == {"tron_alm_branch_f64": 47}
    assert bus_cuda.launches == 7 + 82
    assert graph_loop.launches == 84


def test_no_graph_without_support(monkeypatch):
    """A torch without keep_graph raises; a flag off the card is refused;
    nothing runs a host loop instead."""
    class OldGraph:
        def __init__(self):
            pass
    monkeypatch.setattr(torch.cuda, "CUDAGraph", OldGraph)
    with pytest.raises(RuntimeError, match="keep_graph"):
        graph_loop.check_support()
    flag = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 0-d CUDA tensor"):
        graph_loop.GraphLoop((lambda: None,), (flag,), warmup=lambda: None)
