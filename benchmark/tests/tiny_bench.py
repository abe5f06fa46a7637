"""A copy of ``BENCHMARK.json`` whose configurations are cut to a grid of 8
buses that the CPU solves in seconds: the harness's own code paths, at a
size a test run can hold; ``with_horizon`` adds a multi-period
configuration on the same grid and a cell of it."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import harness

SOLVER = dict(rho_pq=1e3, rho_va=1e5, outer_iterlim=20, inner_iterlim=50)


def bench(tmp_path) -> dict:
    b = copy.deepcopy(harness.load_benchmark())
    for entry in b["configs"]:
        c = json.loads((harness.REPO / entry["file"]).read_text())
        c["grid"].update(nbus=8, nline=11, ngen=3, seed=2)
        c["solver"].update(SOLVER)
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(c))
        entry["file"] = str(path)
    return b


#: the multi-period cell ``with_horizon`` adds, and its periods a request
HORIZON, PERIODS = "tinymp.horizon3", 3
#: ramp limit a period, a share of pgmax: ramps bind over the steepest
#: hours of the RTS week on this grid and the horizon stays feasible
RAMP_RATIO = 0.1


def with_horizon(b: dict, tmp_path) -> dict:
    """``b`` with a configuration ``tinymp`` (``model: "mpacopf"``, the
    8-bus grid of the others, ``RAMP_RATIO``, the others' limits and a
    ``ramp`` limit) and the cell ``HORIZON``, which runs it under
    ``traffic/horizon8.json``; ``resolve_horizon`` cuts its horizon to
    ``PERIODS``."""
    b = copy.deepcopy(b)
    c = json.loads(Path(b["configs"][0]["file"]).read_text())
    c.update(model="mpacopf", ramp_ratio=RAMP_RATIO)
    # between the sound horizon's reading (+0.012 over the steep hours)
    # and the ramp batch left out's (+0.59)
    c["limits"]["ramp"] = 0.1
    path = tmp_path / "tinymp.json"
    path.write_text(json.dumps(c))
    b["configs"].append(dict(b["configs"][0], name="tinymp",
                             file=str(path)))
    b["workloads"].append(dict(name=HORIZON, config="tinymp",
                               traffic="horizon8", chips=1, why="CPU test"))
    return b


def resolve_horizon(real):
    """``harness.resolve`` with the horizon of ``HORIZON``'s mix cut to
    ``PERIODS``."""
    def resolve(bench, name):
        cell, config, traffic = real(bench, name)
        if name == HORIZON:
            traffic = dict(traffic, periods=PERIODS)
        return cell, config, traffic
    return resolve


def run(b: dict, cell: str, traced: bool = False, **kw) -> dict:
    """One CPU run of ``cell`` with a window of one request."""
    import time
    return harness.run(b, cell, seed=2**33 + 5, seconds=0.0, traced=traced,
                       t_start=time.perf_counter(), device="cpu", **kw)
