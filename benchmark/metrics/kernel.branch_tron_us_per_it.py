"""Kernels: device microseconds of the line subproblems' TRON/ALM kernel
(its line-limit instance) per inner iteration of the traced slice
(profiler)."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    its = trace.iterations(run.slice_solves)
    ns = sum(e - s for s, e, name, _ in run.trace.slice_ops()
             if trace.is_tron(name) and "BranchProblem" in name)
    if not its or not ns:
        return None
    return ns * 1e-3 / its
