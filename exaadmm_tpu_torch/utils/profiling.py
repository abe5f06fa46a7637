"""Per-hook timing and profiler traces.

Counterpart of ``exaadmm_tpu/utils/profiling.py`` (the reference's
``@timed`` per-kernel accounting, environment.jl:341-347). The ADMM loops
time nothing by default; ``profile_iteration`` times each ADMM hook of a model on
its own, for tuning: on a CUDA tensor with CUDA events, the host queueing
every repetition ahead of the device (``utils/timing.py``), so the numbers
are the device's work; on the CPU with ``time.perf_counter``.
``Parameters.time_hooks`` instead fills the ``time_*_update`` fields of a
whole solve (``algorithms/admm_two_level.py``).

``trace(path)`` wraps ``torch.profiler.profile`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib

import torch

from .timing import time_ms

#: the hooks ``profile_iteration`` times, in the order an iteration runs them
HOOKS = ("x_update", "xbar_update", "z_update", "l_update", "residual")


def profile_iteration(model, sol, beta, iters: int = 5) -> dict:
    """Time each ADMM hook of ``model`` separately from the state ``sol``
    (one warm-up call, then ``iters`` repetitions); returns
    {hook: seconds per call}.

    A hook the model does not have is left out: the one-level QP model has
    no ``update_z`` and no ``update_l``. Hooks timed apart carry a launch
    overhead each that a loop overlaps, so compare ratios, not sums.

    Each repetition is timed on its own (``time_ms`` with one rep): a hook
    is a hundred or more launches, and the host can only keep ahead of the
    device while they fit CUDA's launch queue (about a thousand)."""
    dev = sol.u.gen.device
    beta = float(beta)
    calls = {
        "x_update": ("update_x", lambda f: f(sol, 1)),
        "xbar_update": ("update_xbar", lambda f: f(sol)),
        "z_update": ("update_z", lambda f: f(sol, beta)),
        "l_update": ("update_l", lambda f: f(sol, beta)),
        "residual": ("update_residual", lambda f: f(sol, beta)),
    }
    out = {}
    for name in HOOKS:
        method, call = calls[name]
        fn = getattr(model, method, None)
        if fn is None:
            continue  # a model without this hook (one-level)
        total_ms = sum(
            time_ms(lambda: call(fn), dev, reps=1, warmup=int(i == 0))[0]
            for i in range(iters))
        out[name] = total_ms / iters / 1e3
    return out


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the CUDA
    device when there is one) and write a Chrome trace to ``path`` (open it
    in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
