"""The port's profiling utilities and the ADMM loop's optional hook timing.

On the CPU the times are the host clock's (``time.perf_counter``); what is
checked is which hooks are timed, that timing is off by default and changes
no iteration count, and that ``trace`` writes a trace file."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu_torch.models.acopf import model as M
from exaadmm_tpu_torch.models.qpsub import model as Q
from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                 Parameters)
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.print_statistics import print_statistics
from exaadmm_tpu_torch.utils.profiling import (HOOKS, profile_iteration,
                                               trace)

from .test_torch_threads import one_torch_thread  # noqa: F401

TIME_FIELDS = ("time_x_update", "time_xbar_update", "time_z_update",
               "time_l_update", "time_lz_update")


@pytest.fixture(scope="module")
def data(case9_path):
    return opf_loaddata(case9_path, verbose=0)


def test_profile_iteration_acopf_has_five_hooks(data):
    model = M.build_model(data, Parameters(verbose=0))
    sol = M.init_solution(model, 4e2, 4e4)
    t = profile_iteration(model, sol, 1e3, iters=2)
    assert tuple(t) == HOOKS == ("x_update", "xbar_update", "z_update",
                                 "l_update", "residual")
    assert all(v > 0.0 for v in t.values())
    # the branch batch dominates the elementwise updates
    assert t["x_update"] > t["l_update"]


def test_profile_iteration_qp_has_no_z(data):
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    model = Q.build_model(data, Parameters(verbose=0), qp)
    sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))
    t = profile_iteration(model, sol, 1e5, iters=2)
    assert tuple(t) == ("x_update", "xbar_update", "residual")
    assert all(v > 0.0 for v in t.values())


def test_trace_writes_a_chrome_trace(data, tmp_path):
    model = M.build_model(data, Parameters(verbose=0))
    sol = M.init_solution(model, 4e2, 4e4)
    p = tmp_path / "trace.json"
    with trace(str(p)):
        model.update_xbar(sol)
    events = json.loads(p.read_text())["traceEvents"]
    assert len(events) > 0


def _solve(data, time_hooks):
    par = Parameters(verbose=0, outer_iterlim=3, time_hooks=time_hooks)
    model = M.build_model(data, par)
    return admm_two_level(model, M.init_solution(model, 4e2, 4e4))[1]


@pytest.fixture(scope="module")
def untimed(data):
    return _solve(data, False)


def _summary(info) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        print_statistics(info)
    return out.getvalue()


def test_time_fields_zero_with_timing_off(untimed):
    assert untimed.outer == 3 and untimed.cumul > 3
    assert [getattr(untimed, f) for f in TIME_FIELDS] == [0.0] * 5
    assert "Update xbar time (secs)" not in _summary(untimed)


def test_time_fields_positive_with_timing_on(data, untimed):
    info = _solve(data, True)
    # timing changes no iteration count and no result
    assert (info.outer, info.cumul) == (untimed.outer, untimed.cumul)
    assert info.objval == untimed.objval
    times = [getattr(info, f) for f in TIME_FIELDS]
    assert all(t > 0.0 for t in times)
    assert sum(times) <= info.time_overall
    text = _summary(info)
    for hook in ("x", "xbar", "z", "l", "lz"):
        assert f"Update {hook} time (secs)" in text


def test_timing_is_off_by_default():
    assert Parameters().time_hooks is False
    info = IterationInformation()
    assert [getattr(info, f) for f in TIME_FIELDS] == [0.0] * 5
    assert torch.get_num_threads() == 1
