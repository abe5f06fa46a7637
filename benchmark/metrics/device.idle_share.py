"""Device: share of the traced slice with no device activity (the union of
the profiler's kernels, copies and fills), in percent."""


def read(run):
    if run.trace is None or not run.trace.slice_ops():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
