"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

Everything that belongs to one cell comes from data that the harness finds
by the names in ``BENCHMARK.json``: the configuration's file (its grid,
made by ``grids/<generator>.py``'s ``make``, its ``model``, whose request
kinds are ``requests/<model>.py``'s (``port.make``), solver settings and
the check's limits), ``traffic/<traffic>.json`` (read by ``traffic.py``),
and one reader per metric, ``metrics/<metric>.py``,
whose ``read(run)`` returns the metric's value from the run's record, or
None when the run holds nothing to read (the metric is then left out).

A run: set-up (imports, the card, the kernel libraries from the build
cache, the grid, and one request of the cell's own shapes) is timed from
the process's start; then one caller sends requests back to back, each
after the last has answered, until ``seconds`` have passed (the window
ends with the last request's answer). With ``--trace 1`` the port's layer
calls are recorded as spans (``trace.Recorder``) through the run, and
set-up and a slice of at least ``TRACE_SECONDS`` of requests after it run
under ``torch.profiler`` before the window. Then the program's state is
freed and the reference judges a seeded sample of the window's answers
(``check.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import HERE, check, port, trace as trace_mod
from . import load as _load
from .traffic import Traffic

REPO = HERE.parent
#: answers kept for the check, besides the slowest
SAMPLE = 8
#: the least length of the traced slice; it runs whole requests
TRACE_SECONDS = 1.0
#: what the process may not hold once the window has closed, by top-level
#: module name
FORBIDDEN = ("jax", "jaxlib", "flax", "exaadmm_tpu")


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads: the configuration, the set-up time, one
    dict per window request (``seconds``, ``periods`` answered (all the
    periods it asked for once Solved, else 0), ``status``,
    and in a traced run the ``solves`` it made, as ``trace.Recorder``
    records them), the window's length, and in a traced run the profiled
    slice (``trace.DeviceTrace``) with the solves it made."""

    config: dict
    setup_s: float
    requests: list
    window_s: float
    trace: trace_mod.DeviceTrace | None = None
    slice_solves: list = dataclasses.field(default_factory=list)


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def resolve(bench: dict, name: str):
    """(cell, configuration, traffic mix) of the cell ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((REPO / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, config, traffic


def metrics_of(bench: dict, cell: dict, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads``
    applies to the cells it lists."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def make_grid(config: dict) -> dict:
    """The configuration's grid: ``grids/<generator>.py``'s ``make`` called
    with the rest of its ``grid`` entry."""
    spec = dict(config["grid"])
    return _load("grids", spec.pop("generator")).make(**spec)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(bench: dict, name: str, *, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", dtype=None) -> dict:
    """One run of the cell ``name``; returns the result line's dict.
    ``dtype`` overrides the configuration's precision (the control)."""
    cell, config, traffic = resolve(bench, name)
    g = make_grid(config)
    request = port.make(config, traffic, g, device, dtype)
    tr = Traffic(traffic, seed)
    sample = check.Sample(SAMPLE, np.random.default_rng([seed, 1]))
    rec = (trace_mod.Recorder(port.traced_calls(config["model"]))
           if traced else None)
    slice_ = (None, [])
    with rec or contextlib.nullcontext():
        if traced:
            slice_ = _traced_setup(request, tr, rec, device)
        else:
            request.setup(tr.warmup())
            _sync(device)
        setup_s = time.perf_counter() - t_start
        requests, window_s = _window(request, tr, seconds, rec, sample)
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
    request.close()
    del request
    record = RunRecord(config, setup_s, requests, window_s, *slice_)
    correct, compared = check.compare(
        check.judge(sample.answers(), g, config), config["limits"])
    metrics = {}
    for m in metrics_of(bench, cell, traced):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(requests),
        "failed": sum(r["status"] != "Solved" for r in requests),
        "metrics": metrics,
        "device": _device(device, cell["chips"], peak, record.trace),
    }
    if record.trace is not None:
        result["breakdown"] = breakdown(record.trace)
    # a reading that is not a finite number is written as text
    result["check"] = {k: {"value": r if np.isfinite(r) else repr(r),
                           "limit": lim} for k, (r, lim) in compared.items()}
    return result


def _window(request, tr, seconds, rec, sample):
    requests = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        ans = request(tr.next())
        b = time.perf_counter()
        requests.append(dict(
            seconds=b - a, status=ans.status,
            periods=len(ans.factors) if ans.status == "Solved" else 0,
            solves=rec.take() if rec else []))
        sample.offer(ans, b - a)
        if b - t0 >= seconds:
            return requests, b - t0


def _traced_setup(request, tr, rec, device):
    """Set-up and the traced slice under the profiler, before the window:
    CUPTI records the kernels inside a CUDA graph only when the graph was
    made while it traced, so the profile opens before set-up builds a
    reused graph (tracking's); the slice's requests follow set-up.
    Returns the slice's trace and the solves the slice made."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        request.setup(tr.warmup())
        _sync(device)
        rec.take()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < TRACE_SECONDS:
            with record_function("request"):
                request(tr.next())
    return trace_mod.reduce_trace(prof), rec.take()


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not read")


def _device(device, chips: int, peak: int, dtrace) -> dict:
    on_card = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak),
           "power_limit": _power_limit() if on_card else "none"}
    if dtrace is not None:
        out["busy_s"] = dtrace.busy_s()
        out["window_s"] = dtrace.window_s
    return out


def breakdown(dtrace: trace_mod.DeviceTrace) -> dict:
    """The ten device operations that took the most time (by name), and
    the idle time of the ten host spans that left the device idle longest
    (the innermost span around each idle stretch)."""
    ops, idle = defaultdict(float), defaultdict(float)
    for s, e, name, _ in dtrace.ops:
        if dtrace.start <= s < dtrace.end:
            ops[trace_mod.short_name(name)] += (e - s) * 1e-9
    for s, e in dtrace.idle_gaps():
        idle[dtrace.host_label((s + e) // 2)] += (e - s) * 1e-9
    return {"device_ops": _top(ops), "idle_gaps": _top(idle)}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def forbidden_modules() -> list:
    """The forbidden top-level modules this process holds, by whole name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
