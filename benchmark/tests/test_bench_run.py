"""Whole runs on the CPU at 8 buses: the command's refusal without a card,
the sound run, the control and the planted faults, each of which must
come out not correct."""

import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny_bench

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_bench.bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def sound(bench):
    """The sound run of each cell, made once for the tests that read it."""
    runs = {}

    def get(cell):
        if cell not in runs:
            runs[cell] = tiny_bench.run(bench, cell)
        return runs[cell]
    return get


#: the check's readings of each cell's sound run before the request kinds
#: moved into ``requests/`` (read on a CPU at the commit before the move):
#: the move changes nothing the check reads
PARENT_READINGS = {
    "synth9241.cold": {
        "consensus": 0.559850092222634, "objective": 0.0,
        "bus_balance": 4.996003610813204e-16, "flows": 0.0,
        "line_overload": -0.17963709683098117, "bounds": 0.0,
        "stationarity": 0.00020453825321348342},
    "synth9241.track": {
        "consensus": 0.845164010511371, "objective": 0.0,
        "bus_balance": 4.579669976578771e-16, "flows": 0.0,
        "line_overload": -0.2033093781620252, "bounds": 0.0,
        "stationarity": 0.0},
}


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         CELLS[0], "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert "{" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(sound, cell):
    res = sound(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"periods_per_s", "setup_s"}


def test_traced_run_reads_the_span_metrics(bench):
    # one cell: the CPU profiler keeps every op of a plain solve, gigabytes
    # of them for a cold one
    cell = "synth9241.track"
    res = tiny_bench.run(bench, cell, traced=True)
    assert res["correct"], res["check"]
    names = {m["name"] for m in harness.metrics_of(
        bench, harness.resolve(bench, cell)[0], True)}
    # the CPU has no device trace: only the spans' metrics are read
    assert set(res["metrics"]) == {n for n in names
                                   if n.split(".")[0] in ("entry", "loop")}


@pytest.mark.parametrize("cell", sorted(PARENT_READINGS))
def test_sound_run_reads_what_it_read_before_the_move(sound, cell):
    assert {k: c["value"] for k, c in sound(cell)["check"].items()} == \
        PARENT_READINGS[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_fp32_is_not_correct(bench, cell):
    res = tiny_bench.run(bench, cell, dtype=torch.float32)
    assert not res["correct"], res["check"]


def _unchanged(real):
    # the line step returns its state as it came, without solving
    def branch_update(sol, *args, **kwargs):
        zero = sol.u.line.new_zeros(())
        return sol.u.line, sol.branch_alm, {
            "avg_auglag_it": zero, "avg_minor_it": zero, "max_cviol": zero,
            "lane_steps": torch.zeros(sol.u.line.shape[0],
                                      dtype=torch.int32)}
    return branch_update


def _half_left_out(real):
    # the old rows are taken before the call: the program may write the
    # new ones over ``sol.u.line``
    def branch_update(sol, *args, **kwargs):
        old = sol.u.line.clone()
        u_line, alm, stats = real(sol, *args, **kwargs)
        half = u_line.shape[0] // 2
        return (torch.cat([u_line[:half], old[half:]]), alm, stats)
    return branch_update


def _flow_altered(real):
    def branch_update(sol, *args, **kwargs):
        u_line, alm, stats = real(sol, *args, **kwargs)
        return u_line + torch.tensor([1e-7] + [0.0] * 7), alm, stats
    return branch_update


FAULTS = {"state_unchanged": _unchanged, "half_batch_left_out":
          _half_left_out, "answer_altered": _flow_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(bench, cell, fault, monkeypatch):
    from exaadmm_tpu_torch.models.acopf import model as acopf_model
    monkeypatch.setattr(acopf_model, "branch_update",
                        FAULTS[fault](acopf_model.branch_update))
    res = tiny_bench.run(bench, cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_objective_altered_is_not_correct(bench, cell, monkeypatch):
    from exaadmm_tpu_torch.models.acopf.model import ModelAcopf
    real = ModelAcopf.update_residual

    def update_residual(self, *args, **kwargs):
        sol, scalars = real(self, *args, **kwargs)
        return sol, dict(scalars, objval=scalars["objval"] * (1 + 1e-7))
    monkeypatch.setattr(ModelAcopf, "update_residual", update_residual)
    res = tiny_bench.run(bench, cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_c1_left_out_of_the_generator_step_is_not_correct(bench, cell,
                                                          monkeypatch):
    # the objective keeps the true cost, so only optimality can see it
    from benchmark import port
    monkeypatch.setattr(*port.kinds("acopf").FAULTS["c1_dropped"]())
    res = tiny_bench.run(bench, cell)
    assert not res["correct"], res["check"]
    assert res["check"]["stationarity"]["value"] > res["check"][
        "stationarity"]["limit"]
