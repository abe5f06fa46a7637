"""The one traffic generator: it reads a traffic mix's parameters
(``traffic/<name>.json``) and draws, from the run's seed, the load factor
of every request.

A request asks for one period of grid operation: the grid's loads, which
stand for the week's peak, times one factor, the same for every bus (the
system load's share of each bus is fixed, as in the source of the load
curve). The mix names a week of hourly load: each day's peak as a share of
the week's (``daily_peak``, Monday first) times each hour's load as a share
of the day's peak (``hourly_weekday``, ``hourly_weekend``), in percent.
Two modes:

- ``cold``: every request is a fresh snapshot of one hour of the week,
  solved from a flat start. The hours come in cycles of the week's 168,
  in an order drawn from the seed, and in rounds within a cycle: the
  hours, sorted by load, fall into ``strata`` equal slices, and each round
  asks for one hour of each slice. So every seed asks for the same loads
  in another order, and any window of whole rounds holds as many light
  as heavy hours: runs do the same work. The warm-up request, in
  set-up, asks for the peak (factor 1).
- ``track``: real-time tracking: each request is the next step of
  ``steps_per_hour`` to the hour, its load the week's curve interpolated
  linearly between the hours, from Monday 00:00 on. Every seed tracks the
  same steps (a tracked step's work depends on the whole path of loads
  before it; the seed draws the answers the check samples). Step 0 is
  solved in set-up; the window asks for the steps after it.
"""

from __future__ import annotations

import numpy as np

MODES = ("cold", "track")


def week(spec: dict) -> np.ndarray:
    """The (168,) hourly load factors of the mix's week, Monday 00:00
    first."""
    days = [spec["hourly_weekday"]] * 5 + [spec["hourly_weekend"]] * 2
    return np.concatenate([np.asarray(h, float) * peak / 1e4
                           for h, peak in zip(days, spec["daily_peak"])])


class Traffic:
    """The load factors of one run: ``warmup()`` for the request that set-up
    solves, then ``next()`` for each request of the window."""

    def __init__(self, spec: dict, seed: int):
        if spec["mode"] not in MODES:
            raise ValueError(f"traffic mode {spec['mode']!r} is not one of "
                             f"{MODES}")
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.hours = week(spec)
        self.count = 0
        self._cycle = []

    def warmup(self) -> float:
        return 1.0 if self.spec["mode"] == "cold" else self._step(0)

    def next(self) -> float:
        self.count += 1
        if self.spec["mode"] == "track":
            return self._step(self.count)
        if not self._cycle:
            self._cycle = self._stratified_cycle()
        return float(self._cycle.pop())

    def _stratified_cycle(self) -> list:
        k = self.spec["strata"]
        # (k, rounds): row i the hours of slice i, in a seeded order
        slices = np.argsort(self.hours, kind="stable").reshape(k, -1)
        slices = np.stack([self.rng.permutation(r) for r in slices])
        rounds = [self.rng.permutation(col) for col in slices.T]
        return list(self.hours[np.concatenate(rounds)])

    def _step(self, t: int) -> float:
        h = t / self.spec["steps_per_hour"]
        i = int(h)
        a, b = self.hours[i % 168], self.hours[(i + 1) % 168]
        return float(a + (h - i) * (b - a))


def loads(grid: dict, factor: float) -> tuple[np.ndarray, np.ndarray]:
    """(Pd, Qd) in MW/MVAr: the grid's loads times ``factor``."""
    return grid["Pd"] * factor, grid["Qd"] * factor
