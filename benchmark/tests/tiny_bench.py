"""A copy of ``BENCHMARK.json`` whose configurations are cut to a grid of 8
buses that the CPU solves in seconds: the harness's own code paths, at a
size a test run can hold."""

from __future__ import annotations

import copy
import json

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


def run(b: dict, cell: str, traced: bool = False, **kw) -> dict:
    """One CPU run of ``cell`` with a window of one request."""
    import time
    return harness.run(b, cell, seed=2**33 + 5, seconds=0.0, traced=traced,
                       t_start=time.perf_counter(), device="cpu", **kw)
