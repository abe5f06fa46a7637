"""Device: activities (kernels, copies, fills) of the traced slice per inner
iteration of its solves (profiler)."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    its = trace.iterations(run.slice_solves)
    ops = run.trace.slice_ops()
    if not its or not ops:
        return None
    return len(ops) / its
