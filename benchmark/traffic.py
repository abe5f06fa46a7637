"""The one traffic generator: it reads a traffic mix's parameters
(``traffic/<name>.json``) and draws, from the run's seed, the load factors
of every request.

A request asks for ``periods`` consecutive hours of grid operation (1 by
default): for each, the grid's loads, which stand for the week's peak,
times one factor, the same for every bus (the system load's share of each
bus is fixed, as in the source of the load curve). The mix names a week of
hourly load: each day's peak as a share of the week's (``daily_peak``,
Monday first) times each hour's load as a share of the day's peak
(``hourly_weekday``, ``hourly_weekend``), in percent. Two modes:

- ``cold``: every request is a fresh snapshot of the horizon of
  ``periods`` hours that starts at one hour of the week (wrapping at
  Sunday 24:00), solved from a flat start. The start hours come in cycles
  of the week's 168, in an order drawn from the seed, and in rounds within
  a cycle: the start hours, sorted by their horizon's load, fall into
  ``strata`` equal slices, and each round asks for one start hour of each
  slice. So every seed asks for the same loads in another order, and any
  window of whole rounds holds as many light as heavy horizons: runs do
  the same work. The warm-up request, in set-up, asks for the horizon
  that starts at the week's peak hour (its first factor 1).
- ``track``: real-time tracking, one period a request: each request is
  the next step of ``steps_per_hour`` to the hour, its load the week's
  curve interpolated linearly between the hours, from Monday 00:00 on.
  Every seed tracks the same steps (a tracked step's work depends on the
  whole path of loads before it; the seed draws the answers the check
  samples). Step 0 is solved in set-up; the window asks for the steps
  after it.

A request's factors are a tuple, one a period.
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
    solves, then ``next()`` for each request of the window, each a tuple of
    one factor a period."""

    def __init__(self, spec: dict, seed: int):
        if spec["mode"] not in MODES:
            raise ValueError(f"traffic mode {spec['mode']!r} is not one of "
                             f"{MODES}")
        periods = spec.get("periods", 1)
        if periods < 1 or (periods > 1 and spec["mode"] == "track"):
            raise ValueError(f"{periods} periods a request under traffic "
                             f"mode {spec['mode']!r}: cold takes 1 or more, "
                             "track 1")
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.hours = week(spec)
        # (168, periods): the hours of the horizon that starts at each hour
        self.horizons = (np.arange(168)[:, None] + np.arange(periods)) % 168
        self.count = 0
        self._cycle = []

    def warmup(self) -> tuple:
        if self.spec["mode"] == "cold":
            return self._horizon(int(np.argmax(self.hours)))
        return (self._step(0),)

    def next(self) -> tuple:
        self.count += 1
        if self.spec["mode"] == "track":
            return (self._step(self.count),)
        if not self._cycle:
            self._cycle = self._stratified_cycle()
        return self._horizon(self._cycle.pop())

    def _horizon(self, start: int) -> tuple:
        return tuple(float(self.hours[h]) for h in self.horizons[start])

    def _stratified_cycle(self) -> list:
        k = self.spec["strata"]
        # (k, rounds): row i the start hours of slice i, in a seeded order
        load = self.hours[self.horizons].sum(axis=1)
        slices = np.argsort(load, kind="stable").reshape(k, -1)
        slices = np.stack([self.rng.permutation(r) for r in slices])
        rounds = [self.rng.permutation(col) for col in slices.T]
        return list(np.concatenate(rounds))

    def _step(self, t: int) -> float:
        h = t / self.spec["steps_per_hour"]
        i = int(h)
        a, b = self.hours[i % 168], self.hours[(i + 1) % 168]
        return float(a + (h - i) * (b - a))


def loads(grid: dict, factor) -> tuple[np.ndarray, np.ndarray]:
    """(Pd, Qd) in MW/MVAr: the grid's loads times ``factor``; for a
    sequence of factors (a horizon), (nbus, T) matrices, column t the
    loads of period t."""
    if np.ndim(factor):
        f = np.asarray(factor, dtype=float)
        return np.outer(grid["Pd"], f), np.outer(grid["Qd"], f)
    return grid["Pd"] * factor, grid["Qd"] * factor
