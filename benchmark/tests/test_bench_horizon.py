"""Whole runs of a multi-period request on the CPU: three periods of the
8-bus grid under ``traffic/horizon8.json`` cut to three periods. The sound
run must be correct and answer three periods a request; the control and
the ramp batch left out must come out not correct.

The window's request asks for the week's steepest three hours, Tuesday
06:00-09:00 (the load rises by 12 and 9 points of the day's peak an hour),
so that ramps bind: over the hours drawn from the seed the hourly
optimum of each period alone often keeps within its ramps, and an answer
that leaves the ramp batch out is then right by chance."""

import pytest
import torch

from benchmark import harness, port
from benchmark.tests import tiny_bench
from benchmark.traffic import Traffic

#: Tuesday 06:00, the start of the week's steepest three hours
STEEP = 24 + 6


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("tiny")
    return tiny_bench.with_horizon(tiny_bench.bench(tmp), tmp)


@pytest.fixture
def steep(monkeypatch):
    monkeypatch.setattr(harness, "resolve",
                        tiny_bench.resolve_horizon(harness.resolve))
    monkeypatch.setattr(Traffic, "next", lambda self: self._horizon(STEEP))
    seen = []
    real = harness._window

    def window(*args):
        requests, window_s = real(*args)
        seen.extend(requests)
        return requests, window_s
    monkeypatch.setattr(harness, "_window", window)
    return seen


def test_sound_horizon_is_correct(bench, steep):
    res = tiny_bench.run(bench, tiny_bench.HORIZON)
    assert res["correct"], res["check"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert [r["periods"] for r in steep] == [tiny_bench.PERIODS]
    # the ramps bind: the worst one lies at its limit, to the solver's
    # tolerance
    assert abs(res["check"]["ramp"]["value"]) < 0.05


def test_horizon_control_in_fp32_is_not_correct(bench, steep):
    res = tiny_bench.run(bench, tiny_bench.HORIZON, dtype=torch.float32)
    assert not res["correct"], res["check"]


def test_ramp_batch_left_out_is_not_correct(bench, steep, monkeypatch):
    monkeypatch.setattr(*port.kinds("mpacopf").FAULTS["ramp_batch_left_out"]())
    res = tiny_bench.run(bench, tiny_bench.HORIZON)
    assert not res["correct"], res["check"]
    assert res["check"]["ramp"]["value"] > res["check"]["ramp"]["limit"]
