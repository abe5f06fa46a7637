"""Timing of short device work from the host.

``time_ms`` gives a function's device time per call apart from the host's
time to enqueue it: for a kernel of a few microseconds, tens of
microseconds of Python per call would otherwise be what the events time.
"""

from __future__ import annotations

import time

import torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps: int, warmup: int = 2, ahead: bool = True):
    """(device ms, host enqueue ms) per call of ``fn``.

    On the card the host first times its own enqueue of ``reps`` calls;
    then, with ``ahead``, it queues a spin kernel (``torch.cuda._sleep``)
    four times longer than that, and behind it the start event, the reps
    and the end event, so the events time the device's work and not the
    host's enqueue rate. The start event must still be pending once the
    last rep is queued, or the spin is lengthened and the run taken again.
    ``ahead=False`` is for a function that synchronizes inside (the plain
    TRON versions): the events then span the calls as they come. On the
    CPU (rehearsal only) both numbers are the host clock's."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    _sync(dev)
    enqueue_ms = enqueue_s * 1e3 / reps
    if dev.type != "cuda":
        return enqueue_ms, enqueue_ms
    cycles = int(max(enqueue_s, 1e-3) * 4 * 2e9)   # SM clock <= 2 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        pending = not start.query()
        end.synchronize()
        if pending or not ahead:
            return start.elapsed_time(end) / reps, enqueue_ms
        cycles *= 4
    raise AssertionError("time_ms: the device caught up with the host")


def time_pair(fa, fb, dev, reps: int):
    """``time_ms`` of two functions on the same inputs in turns (a, b, b,
    a): ((device ms, enqueue ms) of a, the same of b), each the mean of its
    two runs."""
    a1 = time_ms(fa, dev, reps)
    b1 = time_ms(fb, dev, reps)
    b2 = time_ms(fb, dev, reps)
    a2 = time_ms(fa, dev, reps)
    return (tuple((x + y) / 2 for x, y in zip(a1, a2)),
            tuple((x + y) / 2 for x, y in zip(b1, b2)))
