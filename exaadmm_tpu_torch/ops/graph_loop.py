"""The device-side loop of the fused ADMM drivers (``csrc/graph_loop.cu``).

The JAX package runs a whole solve as one device program: a
``lax.while_loop`` (two nested ones in the two-level driver) whose trips
the device decides. On the card the counterpart is a CUDA graph with
conditional WHILE nodes (CUDA 12.4 or later):

- ``GraphLoop`` captures each loop body from PyTorch
  (``torch.cuda.CUDAGraph(keep_graph=True)``, ``raw_cuda_graph()``) and
  builds one executable graph around them in ``csrc/graph_loop.cu``: an
  outer WHILE around an inner one (``pre``, ``inner``, ``tail``), or one
  WHILE (``body``). Each body sets its loop's flag, an int32 0-d tensor,
  and the library's ``set_condition`` kernel hands the flag to the WHILE
  node. ``launch()`` runs the whole loop with one graph launch and no
  synchronization.
- ``run_on_host`` is the CPU's counterpart: the same bodies under host
  ``while`` loops on the same flags (on the CPU a tensor is host memory).

A body reads and writes static tensors only (its temporaries live in the
graphs' memory pool, which the ``GraphLoop`` keeps alive) and reads nothing
back. A driver older than 12.4 or a torch without ``keep_graph`` raises
(``check_support``); nothing falls back to a host loop.

Collectives. A body of a solve whose lines are split over an NCCL mesh
calls ``torch.distributed`` collectives; their NCCL kernels are captured
like any other work, on the communicator's own stream, forked from and
joined to the capture stream. Three things keep that sound:

- the warm-up runs every body eagerly first, on every rank in the same
  order, so the communicator exists before any capture;
- the capture is ``thread_local``: the process group's watchdog thread may
  query its events while this thread captures;
- ``csrc/graph_loop.cu`` turns every event record and wait node of a
  captured body into an empty node with the same edges (a conditional body
  refuses event nodes); ``rewritten`` counts them.

The NCCL watchdog does not see work inside a graph: a rank that hangs
inside the loop hangs the others until the caller's own time limit.

Launch counts. A kernel wrapper counts its launches where it launches
(``count_launch``; so do the collectives of ``parallel/sharding.py``): on
the host, one per call, unless ``GraphLoop`` is capturing the call, which
then runs at every replay of the graph. There the
wrapper adds a node beside its kernel's that adds one to its counter on the
device (``DeviceCounts``); ``set_condition`` adds one to its own on each
run. A driver reads the counters back with its results and hands them to
the host's counts (``GraphLoop.count``). The warm-up before the capture
launches every kernel of the bodies once more, and is counted as the host
counts any launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import weakref

import torch

from ..utils import tracing
from . import _build

#: the set-condition kernel's launches
launches = 0
#: the counters of the loop bodies being captured, if any
_capturing: DeviceCounts | None = None

_SIGS = {
    "driver_version": [ctypes.c_void_p],
    # (pre, inner, tail, inner_flag, outer_flag, count, device, exec,
    #  bad_node_type, rewritten)
    "graph_loop_two_level": [ctypes.c_void_p] * 6 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3,
    # (body, flag, count, device, exec, bad_node_type, rewritten)
    "graph_loop_one_level": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3,
    "graph_loop_launch": [ctypes.c_void_p] * 2,
    "graph_loop_destroy": [ctypes.c_void_p],
    "graph_node_types": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
}
#: cudaGraphNodeType, by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semaphore_signal",
              "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "other")
#: the first CUDA driver with conditional WHILE nodes (12.4)
MIN_DRIVER = 12040


def library():
    """The loop library, built from ``csrc/graph_loop.cu`` at first call."""
    return _build.load("graph_loop", _SIGS)


def check_support() -> None:
    """Raise unless this torch keeps a captured graph for its caller and
    the CUDA driver has conditional WHILE nodes."""
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise RuntimeError(
            f"torch {torch.__version__}: torch.cuda.CUDAGraph has no "
            "keep_graph, which the fused driver needs") from e
    if not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
        raise RuntimeError(f"torch {torch.__version__}: torch.cuda.CUDAGraph "
                           "has no raw_cuda_graph")
    lib = library()
    version = ctypes.c_int(0)
    _build.check(lib, lib.driver_version(ctypes.byref(version)),
                 "driver_version")
    if version.value < MIN_DRIVER:
        raise RuntimeError(
            f"CUDA driver {version.value}: conditional graph nodes need "
            f"{MIN_DRIVER} (CUDA 12.4) or later")


class DeviceCounts:
    """Launch counters in device memory, for the kernels of captured loop
    bodies: one int64 slot per kernel name (``values``), allocated before
    the capture. A launch captured while the counters are ``capturing``
    adds a node that adds one to its slot, so every replay counts itself.
    ``add`` of a slot is the host count it belongs to: ``fold`` hands it
    the slot's value as read back."""

    SLOTS = 32

    def __init__(self, device):
        self.values = torch.zeros(self.SLOTS, dtype=torch.int64,
                                  device=device)
        self.adds: dict = {}   # name -> (slot, add)

    def slot(self, name: str, add) -> torch.Tensor:
        """The 0-d counter of ``name`` (a view of ``values``)."""
        if name not in self.adds:
            if len(self.adds) == self.SLOTS:
                raise RuntimeError(f"DeviceCounts: more than {self.SLOTS} "
                                   "kernels in one loop")
            self.adds[name] = (len(self.adds), add)
        return self.values[self.adds[name][0]]

    @contextlib.contextmanager
    def capturing(self):
        """The block in which captured launches count here."""
        global _capturing
        _capturing = self
        try:
            yield
        finally:
            _capturing = None

    def fold(self, values) -> None:
        """Hand each slot's count in ``values`` (the slots as read back, a
        sequence of numbers) to its host count; a slot that counted
        nothing adds nothing."""
        for slot, add in self.adds.values():
            if values[slot]:
                add(int(values[slot]))


def count_launch(add, name: str) -> None:
    """Count one launch of the kernel ``name``, at its launch site: ``add(1)``
    now, or, while a ``GraphLoop`` captures the launch, one more on the
    device at every replay (``DeviceCounts``)."""
    if _capturing is None:
        add(1)
    else:
        _capturing.slot(name, add).add_(1)


def node_types(graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    by type (``NODE_TYPES``; child graphs counted through)."""
    lib = library()
    counts = (ctypes.c_int * len(NODE_TYPES))()
    _build.check(lib, lib.graph_node_types(
        ctypes.c_void_p(graph.raw_cuda_graph()), counts, len(NODE_TYPES)),
        "graph_node_types")
    return {NODE_TYPES[i]: n for i, n in enumerate(counts) if n}


def _count_set_condition(n: int) -> None:
    global launches
    launches += n


@contextlib.contextmanager
def no_syncs(device):
    """A block that must not synchronize with the device: on a CUDA device
    it runs under ``torch.cuda.set_sync_debug_mode("error")``, so one that
    does raises. The fused drivers start every solve (the buffers' reset
    and the launch) in it."""
    if device.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def run_on_host(bodies, flags) -> None:
    """The loops of ``GraphLoop`` run by the host: ``bodies`` and ``flags``
    as ``GraphLoop`` takes them, on tensors that live on the CPU. It is
    the CPU's ``loop.launch`` span."""
    with tracing.span("loop.launch"):
        if len(bodies) == 1:
            while bool(flags[0]):
                bodies[0]()
            return
        pre, inner, tail = bodies
        inner_flag, outer_flag = flags
        while bool(outer_flag):
            pre()
            while bool(inner_flag):
                inner()
            tail()


class GraphLoop:
    """Loop bodies captured from PyTorch and run on the device by one CUDA
    graph with conditional WHILE nodes.

    ``bodies`` is ``(pre, inner, tail)`` with ``flags`` ``(inner_flag,
    outer_flag)``: while ``outer_flag``, run ``pre``, then ``inner`` while
    ``inner_flag``, then ``tail``; or ``(body,)`` with ``(flag,)``. Each
    body is a function of no arguments; ``pre`` sets ``inner_flag``,
    ``inner`` sets it again, ``tail`` sets ``outer_flag``, and the caller
    sets the outer flag before ``launch``. ``warmup`` runs the bodies once
    on other buffers first (on a side stream), so that every kernel is
    built and loaded and the allocator primed before the capture.

    ``counts`` holds the launch counters of the bodies' kernels and of
    ``set_condition``, zeroed by ``launch``: a driver reads
    ``counts.values`` back with its results and passes them to ``count``.
    ``build_seconds`` is the time of the warm-up, the capture and the
    instantiation; ``pool_bytes`` the device memory the captured bodies
    hold (their temporaries, in one pool shared by the bodies, which run one
    at a time), as the allocator's reserved memory grew over the capture;
    ``rewritten`` the event nodes of the bodies that the loop graph holds
    as edges; ``node_types()`` the captured bodies' nodes by type. With
    tracing on (``utils/tracing.py``) the build's three steps and each
    launch are spans, and ``device_seconds()`` gives the last launch's
    device time.
    """

    def __init__(self, bodies, flags, warmup):
        if len(bodies) not in (1, 3) or len(flags) != (len(bodies) + 1) // 2:
            raise ValueError("GraphLoop takes (body,) with (flag,) or (pre, "
                             "inner, tail) with (inner_flag, outer_flag)")
        for f in flags:
            if (f.device.type != "cuda" or f.dtype != torch.int32
                    or f.dim() != 0):
                raise ValueError("a loop flag is an int32 0-d CUDA tensor")
        dev = flags[0].device
        check_support()
        lib = library()
        self.device = dev
        self.nested = len(bodies) == 3
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with tracing.span("loop.build.warmup"), torch.cuda.stream(side):
            warmup()
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.counts = DeviceCounts(dev)
        set_count = self.counts.slot("graph_loop", _count_set_condition)
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        # capture_begin/_end, not torch.cuda.graph, which empties the
        # allocator's cache at every capture
        capture = torch.cuda.Stream(dev)
        capture.wait_stream(cur)
        with tracing.span("loop.build.capture"), self.counts.capturing(), \
                torch.cuda.stream(capture):
            for body in bodies:
                g = torch.cuda.CUDAGraph(keep_graph=True)
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    g.capture_end()
                self.graphs.append(g)
        cur.wait_stream(capture)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        raw = [ctypes.c_void_p(g.raw_cuda_graph()) for g in self.graphs]
        ptrs = [ctypes.c_void_p(f.data_ptr()) for f in flags]
        ptrs.append(ctypes.c_void_p(set_count.data_ptr()))
        exec_ = ctypes.c_void_p()
        bad = ctypes.c_int(-1)
        rewritten = ctypes.c_int(0)
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        build = (lib.graph_loop_two_level if self.nested
                 else lib.graph_loop_one_level)
        with tracing.span("loop.build.instantiate"):
            err = build(*raw, *ptrs, index, ctypes.byref(exec_),
                        ctypes.byref(bad), ctypes.byref(rewritten))
        if err != 0:
            refused = (NODE_TYPES[min(bad.value, len(NODE_TYPES) - 1)]
                       if bad.value >= 0 else "none named")
            raise RuntimeError(
                f"graph_loop: building the loop graph failed: CUDA error "
                f"{err}: {lib.error_string(err).decode()}; refused node: "
                f"{refused}; the bodies' nodes: {self.node_types()}")
        self.exec = exec_.value
        self.rewritten = rewritten.value
        self.events, self.timed = None, False
        self._destroy = weakref.finalize(self, lib.graph_loop_destroy,
                                         self.exec)
        self.build_seconds = time.perf_counter() - t0

    def node_types(self) -> list:
        """Each body's nodes by type (child graphs counted through)."""
        return [node_types(g) for g in self.graphs]

    def launch(self) -> None:
        """Run the loop on the current stream, its launch counters zeroed
        first: one graph launch, which returns before the device has run
        it."""
        lib = library()
        self.counts.values.zero_()
        stream = torch.cuda.current_stream(self.device)
        # the span holds the graph's launch alone: on the stream, the
        # device's next activities after its start are the graph's
        with tracing.span("loop.launch") as span:
            self.timed = span is not None
            if self.timed:
                if self.events is None:
                    self.events = tuple(torch.cuda.Event(enable_timing=True)
                                        for _ in range(2))
                self.events[0].record(stream)
            err = lib.graph_loop_launch(self.exec, stream.cuda_stream)
            if self.timed:
                self.events[1].record(stream)
        _build.check(lib, err, "graph_loop_launch")

    def device_seconds(self):
        """The seconds the device ran the last launch, if tracing was on at
        the launch (one pair of CUDA events around it, on its stream; no
        node of the graph); else None. Call it once the launch's results
        have been read back, which waited for the events."""
        if not self.timed:
            return None
        return self.events[0].elapsed_time(self.events[1]) * 1e-3

    def count(self, values) -> None:
        """Add the launches of the last run to the host's counts:
        ``values`` is ``counts.values`` as read back after it."""
        self.counts.fold(values)
