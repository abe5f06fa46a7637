"""Periods of grid operation answered per second of the window: a request
answers its period once it is Solved (host clock, all the window's work over
all its time)."""

from benchmark import stats


def read(run):
    return stats.periods_per_s([r["periods"] for r in run.requests],
                               run.window_s)
