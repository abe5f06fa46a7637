"""Spans and counters of the port's own layers, off by default.

    from exaadmm_tpu_torch.utils import tracing
    tracing.enable()
    res = exaadmm_tpu_torch.solve_acopf(...)
    spans = tracing.take()       # the finished spans, oldest first
    tracing.disable()

A span is a stretch of host time at one layer boundary (``Span``): its
name, its start and end from ``time.time_ns()`` (the clock on which
``torch.profiler`` stamps host events, so spans and a profiled trace lie on
one time line), its own id, its parent's (the span open around it in the
same thread) and the id of the top-level span it belongs to, and a dict of
attributes. The
sites, from the entry point down:

- ``entry.solve``: each entry point of ``interface/`` (attribute
  ``entry``, its name);
- ``entry.build_model``, ``entry.init_solution``: each model's;
- ``loop.solve``: a fused solve (``FusedSolver``, ``OneLevelSolver``), the
  top-level span where no entry point opened one (a caller that keeps
  its own model and driver, as a rolling horizon does). Its attributes are
  the solve's record: ``cumul``, ``outer``, ``status``, ``time_overall``,
  ``time_build``, ``built`` (this call built the loop), ``ngen``,
  ``nline`` (padded), ``nbus``, ``itemsize``, on the card
  ``graph_pool_bytes`` and ``device_s``, and for a two-level solve whose
  loop was built while tracing was on ``tron_steps``;
- inside it ``loop.build`` (with ``loop.build.warmup``,
  ``loop.build.capture`` and ``loop.build.instantiate`` on the card),
  ``loop.inputs`` (the loads and pg bounds copied in), ``loop.reset``,
  ``loop.launch`` (the graph's launch; on the CPU the host's loop),
  ``loop.clone`` (the solution copied out of the loop's buffers) and
  ``loop.read_back`` (the one stacked copy of the scalars).

The two counters of a solve:

- ``device_s``: the seconds the device ran the loop graph, from one pair of
  CUDA events per solver recorded on the launch stream around the launch
  and read after the read-back, which has already waited for them. No
  node is added to the graph.
- ``tron_steps``: the line batch's TRON steps over the solve, the sum over
  inner iterations of ``sum_minor_it + sum_auglag_it`` (``lane_steps``
  over the real lanes; a rank's own lanes under a mesh), in an int64
  buffer of the loop's carry. ``branch_stats`` (``csrc/branch_io.cu``)
  adds to it where it reduces those sums, its plain version in torch on
  the CPU. A loop gets the buffer only if tracing was on when it was
  built, so a graph has the same nodes whether or not tracing is on; the
  count comes back in the read-back's stacked copy.

Off, a site costs one test of the module's flag: it makes no object,
creates no CUDA event, opens no profiler range and allocates nothing. On,
a span also opens a ``torch.profiler.record_function`` of its name while a
profiler is recording, so the spans show in a profiled trace. Spans are
kept in memory until ``take()``. Nothing here synchronizes with the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time

import torch

_on = False
#: finished spans, in the order they ended
_records: list = []
#: each thread's open spans, innermost last
_local = threading.local()
_ids = itertools.count(1)
#: the int64 TRON step counter of the loop whose bodies run or are captured
#: now (``counting_steps``), which ``branch_update`` adds to; else None
steps = None


@dataclasses.dataclass
class Span:
    """One span: ``start_ns``/``end_ns`` on ``time.time_ns()``'s clock;
    ``parent`` None for a top-level span, whose ``root`` is its own id."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``take()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> list:
    """The finished spans since the last call, by start time; clears
    them."""
    global _records
    out, _records = _records, []
    return sorted(out, key=lambda s: (s.start_ns, s.id))


def _stack() -> list:
    if not hasattr(_local, "open"):
        _local.open = []
    return _local.open


class _Off:
    """The context of a span while tracing is off: it does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attrs", "span", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.range = None

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_ids)
        self.span = Span(self.name, 0, 0, sid,
                         None if parent is None else parent.id,
                         sid if parent is None else parent.root, self.attrs)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self.span)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        _stack().pop()
        _records.append(self.span)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """``with span(name) as s:`` records the block as a span; ``s`` is the
    ``Span`` (its ``attrs`` can be added to inside), or None while tracing
    is off."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def spanned(name: str, **attrs):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, dict(attrs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def solve_attrs(grid, dtype, info, loop) -> dict:
    """The record of a fused solve for its ``loop.solve`` span: its
    ``IterationInformation`` (``info``), the shapes of its ``grid`` and,
    on the card, the device seconds of its loop graph's launch (``loop``,
    a ``graph_loop.GraphLoop``, or None on the CPU); call it after the
    read-back."""
    out = dict(cumul=info.cumul, outer=info.outer, status=info.status,
               time_overall=info.time_overall, time_build=info.time_build,
               ngen=grid.ngen, nline=grid.nline_padded, nbus=grid.nbus,
               itemsize=dtype.itemsize,
               graph_pool_bytes=info.graph_pool_bytes)
    device_s = None if loop is None else loop.device_seconds()
    if device_s is not None:
        out["device_s"] = device_s
    return out


@contextlib.contextmanager
def counting_steps(counter):
    """The block in which ``branch_update`` adds the line batch's TRON
    steps to ``counter`` (a 0-d int64 tensor on the batch's device, or None
    to count nothing): a fused loop's capture of its bodies, or their run
    by the host."""
    global steps
    old, steps = steps, counter
    try:
        yield
    finally:
        steps = old
