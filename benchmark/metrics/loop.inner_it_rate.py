"""Fused driver: inner ADMM iterations per second of the device-resident
loops over the window (the solves' ``cumul`` over their ``time_overall``):
the solver's internal rate."""


def read(run):
    solves = [s for r in run.requests for s in r["solves"]]
    secs = sum(s["time_overall"] for s in solves)
    if secs <= 0:
        return None
    return sum(s["cumul"] for s in solves) / secs
