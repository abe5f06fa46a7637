"""The plain reference against the grid generator's known AC-feasible
point."""

import numpy as np
import pytest

from benchmark import reference as R
from benchmark.grids import synthetic


@pytest.fixture(scope="module")
def g():
    return synthetic.make(60, 100, 9, seed=3)


def _feasible_point(g):
    fr, to = g["line_from"], g["line_to"]
    w, th = g["Vm"] ** 2, g["Va"]
    wi, wj, thi, thj = w[fr], w[to], th[fr], th[to]
    f = R.flows(g, wi, wj, thi, thj)
    line = np.stack([*f, wi, wj, thi, thj], axis=1)
    gen = np.stack([g["Pg0"], g["Qg0"]], axis=1)
    return gen, line


def test_balance_at_the_known_feasible_point(g):
    gen, line = _feasible_point(g)
    assert R.bus_balance(g, gen, line, g["Pd"], g["Qd"]) < 1e-12
    # a physical point: positive loads, generators inside their windows
    assert np.all(g["Pd"] > -1e-9) and np.all(g["Qd"] > -1e-9)
    assert np.all((g["pgmin"] >= 0) & (g["pgmin"] <= g["Pg0"])
                  & (g["Pg0"] <= g["pgmax"]))
    assert np.all((g["Vmin"] < g["Vm"]) & (g["Vm"] < g["Vmax"]))
    assert R.flow_gap(g, line) == 0.0
    assert R.consensus(gen, gen, line, line) == 0.0
    # ratings lie 30 % or more above the point's flows, bounds around it
    assert R.line_overload(g, line) < 1 / 1.3 - 1 + 1e-12
    assert R.bound_excess(g, gen, line) == 0.0


def test_each_reading_sees_its_fault(g):
    gen, line = _feasible_point(g)
    bad = line.copy()
    bad[3, R.PIJ] += 1e-6
    assert R.flow_gap(g, bad) == pytest.approx(1e-6, rel=1e-6)
    assert R.bus_balance(g, gen, bad, g["Pd"], g["Qd"]) > 0.9e-6
    hi = gen.copy()
    hi[0, 0] = g["pgmax"][0] + 1e-9
    assert R.bound_excess(g, hi, line) == pytest.approx(1e-9, rel=1e-3)
    tight = R.tightened_bounds(g, gen[:, 0], 0.02)
    assert R.bound_excess(g, gen, line, *tight) == 0.0
    moved = gen[:, 0] + 0.03 * g["pgmax"]
    assert R.bound_excess(g, np.stack([moved, gen[:, 1]], 1), line,
                          *tight) > 0.0
    nan = line.copy()
    nan[0, R.WI] = np.nan
    assert np.isnan(R.flow_gap(g, nan))
    assert np.isnan(R.bound_excess(g, gen, nan))


def test_cost_is_the_quadratic_cost(g):
    pg = g["Pg0"]
    p = 100.0 * pg
    want = sum(c2 * x * x + c1 * x + c0 for c2, c1, c0, x in
               zip(g["c2"], g["c1"], g["c0"], p))
    assert R.cost(g, pg) == pytest.approx(want, rel=1e-13)


def test_counts_and_seed():
    a = synthetic.make(40, 60, 6, seed=0)
    b = synthetic.make(40, 60, 6, seed=0)
    assert len(a["line_from"]) == 60 and len(a["gen_bus"]) == 6
    assert len(set(zip(a["line_from"], a["line_to"]))) == 60
    for k, v in a.items():
        assert np.array_equal(np.asarray(v), np.asarray(b[k])), k


def test_stationarity_sees_a_cost_left_out(g):
    pg = g["Pg0"]
    mc = R.marginal_cost(g, pg)
    assert R.stationarity(g, pg, -mc) == 0.0
    # the price a generator step without c1 would have set
    wrong = mc - g["c1"] * g["baseMVA"]
    assert R.stationarity(g, pg, -wrong) > 0.1
    # generators at a bound are not held to it
    assert R.stationarity(g, pg, -wrong, pgmin=pg, pgmax=pg + 1) == 0.0


def test_ramp_excess_inside_at_and_over_the_limit():
    g = dict(pgmax=np.array([1.0, 2.0]))
    # limits 0.1 and 0.2 a period
    inside = np.array([[0.5, 1.0], [0.55, 0.9], [0.5, 0.95]])
    assert R.ramp_excess(g, inside, 0.1) == pytest.approx(-0.5)
    at = np.array([[0.5, 1.0], [0.625, 1.0], [0.5, 1.25]])
    assert R.ramp_excess(g, at, 0.1) == pytest.approx(0.25)
    at = np.array([[0.5, 1.0], [0.4, 1.0], [0.5, 1.2]])
    assert R.ramp_excess(g, at, 0.1) == pytest.approx(0.0, abs=1e-12)
    over = at.copy()
    over[2, 1] = 1.26
    assert R.ramp_excess(g, over, 0.1) == pytest.approx(0.3)
    # one generator with no ramp at all: still, or any move is infinitely
    # over its limit
    still = dict(pgmax=np.array([1.0, 0.0]))
    assert R.ramp_excess(still, inside[:, :1].repeat(2, 1) * [1, 0],
                         0.1) == pytest.approx(-0.5)
    assert R.ramp_excess(still, inside, 0.1) == np.inf
    nan = inside.copy()
    nan[1, 0] = np.nan
    assert np.isnan(R.ramp_excess(g, nan, 0.1))


def test_stationarity_leaves_out_generators_at_a_ramp_limit():
    g = dict(pgmax=np.array([1.0, 1.0, 1.0]), pgmin=np.zeros(3),
             c2=np.ones(3), c1=np.ones(3), baseMVA=1.0)
    # generator 0 ramps at its limit from period 0 to 1, generator 1 from
    # period 1 to 2 at 0.95 of it (the solver's tolerance), generator 2
    # never
    pg = np.array([[0.5, 0.5, 0.5], [0.6, 0.5, 0.5], [0.6, 0.405, 0.55]])
    free = R.off_ramp_limits(g, pg, 0.1)
    assert free.tolist() == [[False, True, True], [False, False, True],
                             [True, False, True]]
    mc = R.marginal_cost(g, pg[1])
    # the price of generator 0 and 1 carries their ramps' multipliers
    price = -mc * np.array([1.5, 0.5, 1.0])
    assert R.stationarity(g, pg[1], price) == pytest.approx(0.5)
    assert R.stationarity(g, pg[1], price, free=free[1]) == 0.0
