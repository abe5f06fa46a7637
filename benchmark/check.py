"""The comparison that decides ``correct``: the reference's judgement of a
seeded sample of the answers the window produced, each number beside its
limit.

``Sample`` keeps, while the window runs, a uniform sample of the answers
drawn from the seed (reservoir sampling, ``size`` at a time) and the
slowest answer; the rest are dropped as they come. Once the window has
closed, ``judge`` copies the kept answers to the host and computes each
number for every period of every answer, with that period's own loads,
and keeps the worst:

- ``consensus``: ||u - v|| over the configuration's
  convergence tolerance sqrt(nvar) * outer_eps (limit 1, which the
  configuration states: the solver's own test bounds a larger norm; a
  horizon's nvar holds the ngen rows of its ramp coupling besides a
  period's 2 ngen + 8 nline, as the solver's per-period norm does);
- ``objective``: the reported objective's gap to the cost of the returned
  dispatch, summed over the answer's periods, relative to that cost;
- ``bus_balance``: each bus's power balance of the bus consensus, with the
  loads the request was given (per unit);
- ``flows``: each line's returned flows against those its returned
  voltages give through the line's admittances (per unit);
- ``line_overload``: the worst flow over its rating, as a share of the
  rating (limit 0, the rating the configuration states);
- ``bounds``: generator outputs and voltages outside their bounds, with a
  tracked period's bounds tightened around the last period's output (per
  unit; limit 0, an exact comparison);
- ``stationarity``: optimality: each generator's marginal cost, from the
  grid's costs, against the price its returned multiplier sets, over the
  generators inside their bounds and, in a horizon, off their ramp limits
  (a share of the marginal cost);
- ``ramp``: for answers of two or more periods, the worst change of a
  generator's output between consecutive periods over its limit
  ``ramp_ratio`` x pgmax, less 1 (negative: every ramp inside its limit).

A number the configuration's ``limits`` do not name is not compared; one
that they name and no answer gave (``ramp`` with no horizon) fails.
"""

from __future__ import annotations

import math

import numpy as np

from . import reference as R
from . import traffic as traffic_mod


class Sample:
    """A seeded uniform sample of ``size`` answers, plus the slowest."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.kept = []
        self.seen = 0
        self.slowest = None

    def offer(self, answer, seconds: float) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(answer)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.kept[j] = answer
        if self.slowest is None or seconds > self.slowest[0]:
            self.slowest = (seconds, answer)

    def answers(self) -> list:
        out = list(self.kept)
        if self.slowest is not None and not any(
                a is self.slowest[1] for a in out):
            out.append(self.slowest[1])
        return out


def _host(state: dict) -> dict:
    return {k: v.detach().to("cpu").double().numpy() for k, v in
            state.items()}


def judge(answers, grid: dict, config: dict) -> dict:
    """{number: worst reading} over every period of ``answers`` (each a
    ``port.Answer``)."""
    s, ramp_ratio = config["solver"], config["ramp_ratio"]
    worst = dict(consensus=0.0, objective=0.0, bus_balance=0.0, flows=0.0,
                 line_overload=-math.inf, bounds=0.0, stationarity=0.0)
    ngen, nline = len(grid["pgmin"]), len(grid["line_from"])
    for a in answers:
        T = len(a.factors)
        nvar = 2 * ngen + 8 * nline + (ngen if T > 1 else 0)
        tol = math.sqrt(nvar) * s["outer_eps"]
        states = [_host(st) for st in a.states]
        pg = np.stack([st["u_gen"][:, 0] for st in states])
        free = R.off_ramp_limits(grid, pg, ramp_ratio) if T > 1 else None
        pg_bounds = (None, None)
        if a.pg_prev is not None:
            pg_bounds = R.tightened_bounds(grid, a.pg_prev, ramp_ratio)
        cost = sum(R.cost(grid, p) for p in pg)
        _up(worst, "objective", abs(a.objval - cost) / max(abs(cost), 1.0))
        if T > 1:
            _up(worst, "ramp", R.ramp_excess(grid, pg, ramp_ratio))
        for t, (st, factor) in enumerate(zip(states, a.factors)):
            Pd, Qd = traffic_mod.loads(grid, factor)
            ug, ul = st["u_gen"], st["u_line"][:nline]
            vg, vl = st["v_gen"], st["v_line"][:nline]
            _up(worst, "consensus", R.consensus(ug, vg, ul, vl) / tol)
            _up(worst, "bus_balance", R.bus_balance(grid, vg, vl, Pd, Qd))
            _up(worst, "flows", R.flow_gap(grid, ul))
            _up(worst, "line_overload", R.line_overload(grid, ul))
            _up(worst, "bounds", R.bound_excess(grid, ug, ul, *pg_bounds))
            _up(worst, "stationarity", R.stationarity(
                grid, ug[:, 0], st["l_gen"][:, 0], *pg_bounds,
                free=None if free is None else free[t]))
    return worst


def _up(worst: dict, key: str, value: float) -> None:
    # a NaN reading is worse than any number, and stays
    old = worst.get(key, -math.inf)
    if not math.isnan(old) and not value <= old:
        worst[key] = value


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: [reading, limit]}) for the numbers ``limits``
    names; a reading that is NaN, missing or above its limit fails."""
    out = {k: [readings.get(k, math.nan), limits[k]] for k in limits}
    ok = all(r <= lim for r, lim in out.values())
    return ok, out
