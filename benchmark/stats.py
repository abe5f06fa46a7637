"""The end-to-end arithmetic over a window's requests."""

from __future__ import annotations


def periods_per_s(periods_answered: list, window_s: float) -> float:
    """Periods of grid operation answered in the window over the window's
    wall time: all the work over all the time (a request that failed
    answered 0)."""
    return sum(periods_answered) / window_s
