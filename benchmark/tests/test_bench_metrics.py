"""The metric arithmetic: the end-to-end numbers and the per-layer readers
on a made-up run and trace."""

import statistics

import pytest

from benchmark import harness, roofline, stats
from benchmark.trace import DeviceTrace


def _record(trace=None, solves=()):
    reqs = [dict(seconds=0.5 + 0.01 * i, periods=1 if i % 10 else 0,
                 status="Solved" if i % 10 else "IterationLimit",
                 solves=[dict(cumul=100, time_overall=0.25)])
            for i in range(120)]
    return harness.RunRecord(config={}, setup_s=9.5, requests=reqs,
                             window_s=60.0, trace=trace,
                             slice_solves=list(solves))


def test_periods_per_s_counts_all_the_window():
    # a failed request answers nothing, and its time still counts
    assert stats.periods_per_s([1, 0, 1, 1], 2.0) == 1.5
    assert stats.periods_per_s([], 3.0) == 0.0


def test_end_to_end_readers():
    rec = _record()
    # 108 of 120 requests Solved, one period each, over 60 s
    assert harness.load_reader("periods_per_s")(rec) == 108 / 60.0
    assert harness.load_reader("setup_s")(rec) == 9.5


def test_span_readers():
    rec = _record()
    assert harness.load_reader("loop.inner_it_rate")(rec) == pytest.approx(
        400.0)
    assert harness.load_reader("loop.iters_per_period")(rec) == \
        pytest.approx(120 * 100 / 108)
    mean_wall = statistics.fmean(r["seconds"] for r in rec.requests)
    assert harness.load_reader("entry.outside_loop_ms")(rec) == \
        pytest.approx(1e3 * (mean_wall - 0.25))
    # an untraced run records no solves: nothing to read
    for r in rec.requests:
        r["solves"] = []
    assert harness.load_reader("entry.outside_loop_ms")(rec) is None
    assert harness.load_reader("loop.inner_it_rate")(rec) is None


def _trace():
    ms = 1_000_000
    ops = [(0 * ms, 4 * ms, "void tron_alm::tron_alm_kernel<BranchProblem"
            "<double, true>, double>(double const*)", "kernel"),
           (2 * ms, 5 * ms, "acopf_z(double*)", "kernel"),
           (7 * ms, 8 * ms, "Memcpy HtoD (Pageable -> Device)", "memcpy"),
           (8 * ms, 9 * ms, "Memcpy DtoD (Device -> Device)", "memcpy"),
           (30 * ms, 31 * ms, "after the slice", "kernel")]
    spans = [(0, 10 * ms, "request"), (5 * ms, 7 * ms, "loop.build")]
    return DeviceTrace(ops=ops, spans=spans, start=0, end=10 * ms)


def test_device_readers_on_a_made_up_trace():
    t = _trace()
    solve = dict(ngen=10, nline=20, nbus=12, itemsize=8, built=True,
                 cumul=9, outer=2)
    rec = _record(trace=t, solves=[solve])
    # busy: [0, 5] and [7, 9] of a 10 ms slice
    assert t.busy_s() == pytest.approx(7e-3)
    assert harness.load_reader("device.idle_share")(rec) == \
        pytest.approx(30.0)
    # 4 activities start inside the slice; 9 iterations and the warm-up
    assert harness.load_reader("device.activities_per_it")(rec) == 0.4
    assert harness.load_reader("kernel.branch_tron_us_per_it")(rec) == \
        pytest.approx(4e3 / 10)
    per_it, lz = roofline.closed_form_bytes(10, 20, 12)
    least = (10 * per_it + 3 * lz) / roofline.HBM_BYTES_PER_S
    # non-TRON device time that is not a host copy: acopf_z and the DtoD
    assert harness.load_reader("kernel.closed_form_roofline")(rec) == \
        pytest.approx(100 * least / 4e-3)
    b = harness.breakdown(t)
    assert b["device_ops"][0][0].startswith("tron_alm::tron_alm_kernel")
    # the idle stretches: [5, 7] inside loop.build, [9, 10] in the request
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"loop.build": 2e-3, "request": 1e-3})


def test_no_trace_reads_nothing():
    rec = _record()
    for name in ("device.idle_share", "device.activities_per_it",
                 "kernel.branch_tron_us_per_it",
                 "kernel.closed_form_roofline"):
        assert harness.load_reader(name)(rec) is None



def test_recorder_wraps_the_calls_it_is_given_and_names_each_solve():
    import types

    import torch

    from benchmark.trace import Recorder

    class Solver:
        dtype = torch.float64
        carry = None

        def __init__(self, model):
            self.model = model

        def __call__(self):
            return None, types.SimpleNamespace(
                cumul=5, outer=2, status="Solved", time_overall=0.1,
                time_build=0.02)

    class ModelMpacopf:
        grid = types.SimpleNamespace(ngen=3, nline_padded=12, nbus=8)
        T = 8

    class ModelAcopf:
        grid = ModelMpacopf.grid

    real = Solver.__call__
    with Recorder([(Solver, "__call__", "loop.solve")]) as rec:
        assert Solver.__call__ is not real
        for model in (ModelMpacopf(), ModelAcopf()):
            Solver(model)()
    assert Solver.__call__ is real
    assert [(s["model"], s["periods"], s["built"]) for s in rec.take()] == [
        ("ModelMpacopf", 8, True), ("ModelAcopf", 1, True)]
    assert rec.take() == []
