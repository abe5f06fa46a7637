"""Spans, counters and the device trace of a ``--trace 1`` run.

``Recorder`` wraps, for the run's length, the port's calls at each layer
boundary, from the benchmark's side (``port.traced_calls`` names them):

- ``entry.build_model``: the model's ``build_model`` (grid upload), that
  of the configuration's model (``MODEL`` of ``requests/<model>.py``);
- ``loop.solve``: every call of the fused two-level solver
  (``FusedSolver.__call__``), whose ``IterationInformation`` it keeps:
  inner iterations, outer rounds, ``time_overall`` (launch to read-back),
  ``time_build``, status, the shapes of the model it ran, the model's
  class name and its periods (``model.T``, 1 for a single period);
- ``loop.build``: the solver's build (warm-up, capture, instantiation);
- ``loop.read_back``: the carry's one read-back at the solve's end.

Each wrapper opens a ``torch.profiler.record_function`` range of its name,
so a profiled slice shows what the host was doing at any moment.
``reduce_trace`` turns a profiled slice into device activities (kernels,
copies, fills) and host spans on one clock.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.profiler import record_function

#: span names, from the entry point down; "request" is the harness's own
SPANS = ("request", "entry.build_model", "loop.solve", "loop.build",
         "loop.read_back")


class Recorder:
    """Wraps the port's layer calls ``calls``, (owner, attribute, span)
    each, while open; ``solves`` lists every ``loop.solve`` since the last
    ``take()``."""

    def __init__(self, calls: list):
        self._targets = [
            (owner, attr, span,
             self._record_solve if span == "loop.solve" else None)
            for owner, attr, span in calls]
        self._saved = []
        self.solves = []

    def __enter__(self):
        for owner, attr, span, after in self._targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, _wrap(fn, span, after))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def take(self) -> list:
        out, self.solves = self.solves, []
        return out

    def _record_solve(self, solver, built: bool, result) -> None:
        _, info = result
        model = solver.model
        gd = model.grid
        self.solves.append(dict(
            ngen=gd.ngen, nline=gd.nline_padded, nbus=gd.nbus,
            itemsize=solver.dtype.itemsize, built=built,
            model=type(model).__name__, periods=getattr(model, "T", 1),
            cumul=info.cumul, outer=info.outer, status=info.status,
            time_overall=info.time_overall, time_build=info.time_build))


def _wrap(fn, span, after):
    """``fn`` inside a profiler range named ``span``; ``after(solver,
    built, result)`` sees each call of a solver, with whether it built."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        built = getattr(args[0], "carry", True) is None
        with record_function(span):
            out = fn(*args, **kwargs)
        if after is not None:
            after(args[0], built, out)
        return out
    return call


@dataclasses.dataclass
class DeviceTrace:
    """A profiled slice: ``ops`` the device activities as (start_ns, end_ns,
    name, kind), sorted by start, kind one of "kernel", "memcpy",
    "memset"; ``spans`` the host spans as (start_ns, end_ns, name);
    ``start``/``end`` the slice's bounds (its first request's start, its
    last request's end)."""

    ops: list
    spans: list
    start: int
    end: int

    def slice_ops(self) -> list:
        """The device activities that start inside the slice."""
        return [op for op in self.ops if self.start <= op[0] < self.end]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which at least one device activity ran (their union,
        clipped to the slice)."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for s, e, _, _ in self.ops:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of every stretch of the slice with no device
        activity."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_label(self, t: int) -> str:
        """The innermost host span around time ``t`` ("between requests"
        when none is)."""
        best = None
        for s, e, name in self.spans:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "between requests"


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or not e.name() or e.name() in SPANS \
        or e.name() == "graph_loop.launch"


def _kind(name: str):
    """"memcpy", "memset" or "kernel" for a device activity, by the names
    CUPTI gives them; None for the synchronisation records."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("cuda") or "Sync" in name:
        return None
    return "kernel"


def reduce_trace(prof) -> DeviceTrace:
    """The device activities and host spans of a finished
    ``torch.profiler.profile``; the slice runs from the first "request"
    span's start to the last one's end."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors each host range on the device's
            # timeline; those are no device work
            kind = None if _annotation(e) else _kind(name)
            if kind is not None:
                ops.append((e.start_ns(), e.end_ns(), name, kind))
        elif name in SPANS:
            spans.append((e.start_ns(), e.end_ns(), name))
    ops.sort()
    reqs = [s for s in spans if s[2] == "request"]
    if not reqs:
        raise RuntimeError("the profiled slice holds no request span")
    return DeviceTrace(ops, spans, min(s[0] for s in reqs),
                       max(s[1] for s in reqs))


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list, at most 96 characters."""
    head = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return head.split("(")[0].strip()[:96]


def iterations(solves: list) -> int:
    """Inner iterations the device ran for ``solves``: each solve's own,
    and one more for a solve that built its loop graph (the warm-up pass
    runs every kernel of the inner iteration once before the capture)."""
    return sum(s["cumul"] + s["built"] for s in solves)


def is_tron(name: str) -> bool:
    """Whether a device activity is an instance of the TRON/ALM kernel."""
    return "tron_alm_kernel" in name
