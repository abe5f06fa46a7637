"""The port's tracer (``exaadmm_tpu_torch/utils/tracing.py``) on the CPU.

- Off, it records nothing and makes nothing: no span object, no profiler
  range, no step counter in the loop's carry.
- On, ``solve_acopf``'s fused solve (the host runs the loop bodies) gives
  the span tree of the entry point, the model, the initial point and the
  loop's phases under one root, with the solve's record on ``loop.solve``;
  a tracked call of a kept driver is a tree rooted at ``loop.solve``; the
  one-level solver's solve is one too.
- On and off give bit-identical solutions and the same ``info``.
- ``tron_steps`` equals the sums of ``alm_iters`` and ``minor_iters`` over
  the real lanes of every branch update of the host loop on the same solve,
  as integers.
- Under ``torch.profiler`` a span encloses a ``record_function`` range
  opened inside it, on the profiler's clock.
"""

import os

import pytest
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.algorithms.carry import leaves
from exaadmm_tpu_torch.models.acopf import branch as TB
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.models.mpacopf import model as MP
from exaadmm_tpu_torch.ops import branch_cuda
from exaadmm_tpu_torch.utils import tracing
from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                 Parameters)
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE9 = os.path.join(ROOT, "data", "case9.m")
DEMAND9 = os.path.join(ROOT, "data", "case9_demand")
KW9 = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, verbose=0, device="cpu")
INFO_FIELDS = ("status", "outer", "inner", "cumul", "objval", "auglag",
               "primres", "dualres", "mismatch", "norm_z_curr",
               "norm_z_prev", "max_cviol", "eps_pri", "graph_pool_bytes")
#: the record of a CPU solve on its ``loop.solve`` span
RECORD = {"built", "cumul", "outer", "status", "time_overall", "time_build",
          "ngen", "nline", "nbus", "itemsize", "graph_pool_bytes"}
LOOP_PHASES = ["loop.build", "loop.inputs", "loop.reset", "loop.launch",
               "loop.clone", "loop.read_back"]


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.take()
    tracing.enable()
    yield
    tracing.disable()
    tracing.take()


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def _nested(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_records_nothing_and_makes_nothing(monkeypatch):
    """A solve with tracing off under a recording profiler: no span object,
    no profiler range of the port's, no step counter in the carry."""
    assert not tracing.enabled()
    tracing.take()

    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(tracing, "Span", refuse)
    monkeypatch.setattr(tracing._Open, "__init__", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    par = Parameters(verbose=0, outer_iterlim=2, outer_eps=2e-5)
    model = TM.build_model(opf_loaddata(CASE9, verbose=0), par)
    run = two.make_fused_solver(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        two.admm_two_level_fused(model, TM.init_solution(model, 4e2, 4e4),
                                 run=run)
    assert tracing.take() == []
    assert "tron_steps" not in run.carry.v
    assert tracing.steps is None


def test_span_tree_of_solve_acopf(traced):
    res = E.solve_acopf(CASE9, outer_iterlim=3, **KW9)
    spans = tracing.take()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["entry.solve"]
    root = roots[0]
    assert root.attrs == {"entry": "solve_acopf"}
    assert {s.root for s in spans} == {root.id}
    assert len({s.id for s in spans}) == len(spans)
    assert _children(spans, root) == ["entry.build_model",
                                      "entry.init_solution", "loop.solve"]
    (solve,) = [s for s in spans if s.name == "loop.solve"]
    assert _children(spans, solve) == LOOP_PHASES
    assert not [s for s in spans if s.parent not in
                (None, root.id, solve.id)]
    for s in spans:
        parent = next((p for p in spans if p.id == s.parent), None)
        assert parent is None or _nested(s, parent), s.name
    info = res.info
    assert RECORD <= set(solve.attrs)
    assert solve.attrs["built"] is True
    assert (solve.attrs["cumul"], solve.attrs["outer"],
            solve.attrs["status"]) == (info.cumul, info.outer, info.status)
    assert solve.attrs["time_overall"] == info.time_overall
    assert solve.attrs["time_build"] == info.time_build
    gd = res.model.grid
    assert (solve.attrs["ngen"], solve.attrs["nline"], solve.attrs["nbus"],
            solve.attrs["itemsize"]) == (gd.ngen, gd.nline_padded, gd.nbus, 8)
    assert solve.attrs["graph_pool_bytes"] == info.graph_pool_bytes
    # a CPU solve has no device clock; its loop counted the TRON steps
    assert "device_s" not in solve.attrs
    assert solve.attrs["tron_steps"] > info.cumul
    assert tracing.take() == []


def test_tracked_call_is_rooted_at_loop_solve(traced):
    """A rolling horizon's step: the caller keeps the model and the driver
    and solves with new loads; the second call builds nothing."""
    par = Parameters(verbose=0, outer_iterlim=2, outer_eps=2e-4)
    model = TM.build_model(opf_loaddata(CASE9, verbose=0), par)
    sol = TM.init_solution(model, 4e2, 4e4)
    solve = two.two_level_driver(model)
    pd, qd = load_time_series(DEMAND9)
    for t in range(2):
        tracing.take()
        sol, info = solve(model, sol, IterationInformation(),
                          Pd=torch.as_tensor(pd[:, t]),
                          Qd=torch.as_tensor(qd[:, t]))
        spans = tracing.take()
        roots = [s for s in spans if s.parent is None]
        assert [s.name for s in roots] == ["loop.solve"]
        assert {s.root for s in spans} == {roots[0].id}
        phases = LOOP_PHASES if t == 0 else LOOP_PHASES[1:]
        assert _children(spans, roots[0]) == phases
        assert roots[0].attrs["built"] is (t == 0)
        assert roots[0].attrs["cumul"] == info.cumul


def test_one_level_solve_spans(traced):
    """The QP subproblem's fused one-level solve under ``solve_qpsub``."""
    from .test_torch_fused import _qp9
    res = E.solve_qpsub(CASE9, *_qp9(), 1e5, outer_iterlim=5, scale=1e-4,
                        rho_pq=4e3, rho_va=4e3, outer_eps=2e-6, verbose=0,
                        device="cpu")
    spans = tracing.take()
    (root,) = [s for s in spans if s.parent is None]
    assert root.attrs == {"entry": "solve_qpsub"}
    (solve,) = [s for s in spans if s.name == "loop.solve"]
    assert _children(spans, solve) == ["loop.build", "loop.reset",
                                       "loop.launch", "loop.clone",
                                       "loop.read_back"]
    assert RECORD <= set(solve.attrs)
    assert (solve.attrs["cumul"], solve.attrs["outer"]) == (
        res.info.cumul, res.info.outer) == (5, 5)
    assert "tron_steps" not in solve.attrs


@pytest.mark.parametrize("case", ["case9", "case9 x 2 periods"])
def test_on_and_off_bit_identical(case):
    def call():
        if case == "case9":
            return E.solve_acopf(CASE9, outer_iterlim=6, **KW9)
        return E.solve_mpacopf(CASE9, DEMAND9, end_period=2, outer_iterlim=4,
                               warm_start=False, **KW9)
    off = call()
    tracing.enable()
    try:
        on = call()
    finally:
        tracing.disable()
    assert tracing.take()
    for k in INFO_FIELDS:
        assert getattr(on.info, k) == getattr(off.info, k), k
    for n, (a, b) in enumerate(zip(leaves(on.solution), leaves(off.solution),
                                   strict=True)):
        assert torch.equal(a, b), f"solution tensor {n}"


@pytest.mark.parametrize("case", ["case9", "case9 x 2 periods"])
def test_tron_steps_equal_the_host_loop_stats(case, monkeypatch):
    """The fused loop's count against the host loop's branch stats: the
    sums of ``alm_iters`` and ``minor_iters`` over the real lanes of every
    inner iteration, read back as integers."""
    data = opf_loaddata(CASE9, verbose=0)

    def model_and_start():
        par = Parameters(verbose=0, outer_iterlim=3, outer_eps=2e-5)
        if case == "case9":
            m = TM.build_model(data, par)
            return m, TM.init_solution(m, 4e2, 4e4)
        pd, qd = load_time_series(DEMAND9)
        m = MP.build_model(data, par, pd, qd, end_period=2)
        return m, MP.init_solution(m, 4e2, 4e4)

    tracing.enable()
    try:
        model, sol = model_and_start()
        tracing.take()
        _, i_fused = two.admm_two_level_fused(model, sol)
        (solve,) = [s for s in tracing.take() if s.name == "loop.solve"]
    finally:
        tracing.disable()
    counted = solve.attrs["tron_steps"]

    sums = []
    unpack = branch_cuda.branch_unpack

    def spy(*args, **kwargs):
        out = unpack(*args, **kwargs)
        a, b = out[3][0].item(), out[3][1].item()
        assert a == int(a) and b == int(b)
        sums.append(int(a) + int(b))
        return out
    monkeypatch.setattr(branch_cuda, "branch_unpack", spy)
    model, sol = model_and_start()
    _, i_host = two.admm_two_level(model, sol)
    assert (i_host.outer, i_host.cumul) == (i_fused.outer, i_fused.cumul)
    assert len(sums) == i_host.cumul
    assert isinstance(counted, int) and counted == sum(sums) > 0


@pytest.mark.parametrize("case", ["case9", "case9 x 2 periods"])
def test_build_counts_store_copies(case, monkeypatch):
    """``loop.build``'s ``store_copies``: the copies ``Carry.store`` makes
    in one run of each body, counted by the graph's warm-up
    (``_run_bodies``), so None on the CPU. ACOPF's hooks write into the
    carry, so its inner body copies z_prev (two blocks) and the new line
    rows of u; the multi-period model's return fresh tensors, all copied
    in; each tail copies the new lz."""
    built = []
    build = two.FusedSolver._build

    def spy(self, *args):
        built.append(self)
        return build(self, *args)
    monkeypatch.setattr(two.FusedSolver, "_build", spy)
    tracing.enable()
    try:
        if case == "case9":
            E.solve_acopf(CASE9, outer_iterlim=1, **KW9)
        else:
            E.solve_mpacopf(CASE9, DEMAND9, end_period=2, outer_iterlim=1,
                            warm_start=False, **KW9)
        (span,) = [s for s in tracing.take() if s.name == "loop.build"]
    finally:
        tracing.disable()
    assert span.attrs["store_copies"] is None
    (run,) = built
    run._run_bodies(run.carry.clone())    # the card's warm-up
    want = ({"pre": 0, "inner": 3, "tail": 2} if case == "case9"
            else {"pre": 0, "inner": 27, "tail": 3})
    assert run.store_copies == want


def test_step_counter_of_the_plain_unpack():
    """``branch_unpack_plain`` adds its stats' two sums to a counter, which
    leaves its outputs as they were; ``branch_stats`` refuses a counter
    that is not a 0-d int64 tensor."""
    par = Parameters(verbose=0)
    model = TM.build_model(opf_loaddata(CASE9, verbose=0), par)
    sol = TM.init_solution(model, 4e2, 4e4)
    gd = model.grid
    from exaadmm_tpu_torch.ops import tron_cuda
    *batch, act = branch_cuda.branch_pack(sol, gd, par, 1, True,
                                          torch.float64)
    res = tron_cuda.tron_alm_packed(tron_cuda.BRANCH, *batch, active0=act,
                                    **TB.branch_tolerances(par,
                                                           torch.float64))
    args = (res, sol, gd, act, True, torch.float64)
    steps = torch.full((), 5, dtype=torch.int64)
    plain = TB.branch_unpack_plain(*args)
    counted = TB.branch_unpack_plain(*args, steps)
    assert torch.equal(plain[0], counted[0])
    assert torch.equal(plain[3], counted[3])
    want = (res.alm_iters + res.minor_iters)[act != 0].sum()
    assert int(steps) == 5 + int(want) == 5 + int(counted[2].sum())
    part = torch.zeros((3, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="steps must be"):
        branch_cuda.branch_stats(part, 9, torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="steps must be"):
        branch_cuda.branch_stats(part, 9, torch.zeros(1, dtype=torch.int64))


def test_span_encloses_a_profiler_range(traced):
    """Under a CPU ``torch.profiler`` a span opens a range of its own name
    and encloses, on the profiler's clock, a range opened inside it (within
    0.1 ms); with tracing off it opens none."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.span("loop.launch") as span:
            with torch.profiler.record_function("inside"):
                torch.ones(64).sum()
        tracing.disable()
        with tracing.span("loop.clone") as off:
            torch.ones(64).sum()
    assert off is None
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inside = events["inside"]
    tol = 100_000   # 0.1 ms in ns
    assert span.start_ns <= inside.start_ns() + tol
    assert inside.end_ns() <= span.end_ns + tol
    assert inside.start_ns() <= inside.end_ns()
    assert "loop.launch" in events and "loop.clone" not in events
    assert [s.name for s in tracing.take()] == ["loop.launch"]
