"""The plain reference: what an ACOPF answer must satisfy, in NumPy (fp64).

It imports nothing of the program. From the grid arrays that the
benchmark generated (``grids/``) and the loads it handed to the program,
it works out on its own the admittance flows, the generator costs, every
bus's power balance, the line ratings, the bounds and the marginal costs,
and judges the answer the program returned with them. Each function takes one
period's arrays of an answer, or a horizon's dispatch (``ramp_excess``,
``off_ramp_limits``); ``check.py`` runs them over a sample of the answers.

Layout of the program's answer, the ADMM state of one period:

- ``u_gen``, ``v_gen``: (ngen, 2) rows ``[pg, qg]`` (per unit): ``u`` the
  generators' own values, ``v`` the bus consensus copy; ``l_gen`` the
  multipliers of the rows u - v + z = 0 (cost units per unit of power);
- ``u_line``, ``v_line``: (nline, 8) rows ``[pij, qij, pji, qji, wi, wj,
  thi, thj]``: flows at both ends (per unit), squared voltage magnitudes
  and angles of the two buses. ``u`` is what the line subproblems
  returned, ``v`` what the bus consensus made of it.
"""

from __future__ import annotations

import numpy as np

PIJ, QIJ, PJI, QJI, WI, WJ, THI, THJ = range(8)
#: the share of its limit from which a ramp counts as at the limit: the
#: solver meets a binding ramp only to its tolerance, so a sound answer
#: reads it a little under or over the limit (on an H100, 2,869 buses x 8
#: periods: 0.95-1.11; 8 buses x 8 periods on a CPU: up to 1.22)
AT_LIMIT = 0.9


def flows(grid: dict, wi, wj, thi, thj):
    """(pij, qij, pji, qji) of every line at the given squared voltage
    magnitudes and angles of its two buses: the AC branch equations with
    the line's admittances (MATPOWER's pi model)."""
    vi, vj = np.sqrt(wi), np.sqrt(wj)
    c = vi * vj * np.cos(thi - thj)
    s = vi * vj * np.sin(thi - thj)
    g = grid
    pij = g["YffR"] * wi + g["YftR"] * c + g["YftI"] * s
    qij = -g["YffI"] * wi - g["YftI"] * c + g["YftR"] * s
    pji = g["YttR"] * wj + g["YtfR"] * c - g["YtfI"] * s
    qji = -g["YttI"] * wj - g["YtfI"] * c - g["YtfR"] * s
    return pij, qij, pji, qji


def flow_gap(grid: dict, u_line) -> float:
    """Worst gap (per unit) between the flows a line subproblem returned and
    the flows its own voltages give."""
    f = flows(grid, u_line[:, WI], u_line[:, WJ], u_line[:, THI],
              u_line[:, THJ])
    return float(np.max(np.abs(u_line[:, :4] - np.stack(f, axis=1))))


def cost(grid: dict, pg) -> float:
    """Generator cost of the dispatch ``pg`` (per unit), in the case's cost
    units: sum of c2 (B pg)^2 + c1 B pg + c0."""
    p = grid["baseMVA"] * np.asarray(pg)
    return float(np.sum(grid["c2"] * p * p + grid["c1"] * p + grid["c0"]))


def bus_balance(grid: dict, v_gen, v_line, Pd, Qd) -> float:
    """Worst active or reactive power balance (per unit) over the buses, of
    the bus consensus: at each bus the generation less the load, the shunt
    at the bus's voltage and the flows leaving it on every line. Each
    bus's squared voltage is read from the consensus rows of its lines."""
    g = grid
    nbus = len(g["Pd"])
    fr, to = g["line_from"], g["line_to"]
    w = np.zeros(nbus)
    w[fr] = v_line[:, WI]
    w[to] = v_line[:, WJ]
    p = np.bincount(g["gen_bus"], v_gen[:, 0], nbus)
    q = np.bincount(g["gen_bus"], v_gen[:, 1], nbus)
    p -= np.bincount(fr, v_line[:, PIJ], nbus) + np.bincount(
        to, v_line[:, PJI], nbus)
    q -= np.bincount(fr, v_line[:, QIJ], nbus) + np.bincount(
        to, v_line[:, QJI], nbus)
    p -= np.asarray(Pd) / g["baseMVA"] + g["YshR"] * w
    q -= np.asarray(Qd) / g["baseMVA"] - g["YshI"] * w
    return float(np.maximum(np.max(np.abs(p)), np.max(np.abs(q))))


def consensus(u_gen, v_gen, u_line, v_line) -> float:
    """2-norm of u - v over both blocks: how far the components' values lie
    from the bus consensus, the quantity the solver's convergence test
    bounds."""
    return float(np.sqrt(np.sum((u_gen - v_gen) ** 2)
                         + np.sum((u_line - v_line) ** 2)))


def line_overload(grid: dict, u_line) -> float:
    """Worst apparent-power flow over the rating, as a share of the rating,
    over the lines that have one (negative: every line within its rating),
    from the flows the lines' own voltages give, at both ends."""
    rated = grid["rateA"] > 0
    f = flows(grid, u_line[:, WI], u_line[:, WJ], u_line[:, THI],
              u_line[:, THJ])
    rate = grid["rateA"][rated] / grid["baseMVA"]
    s_fr = np.hypot(f[0], f[1])[rated]
    s_to = np.hypot(f[2], f[3])[rated]
    return float(np.max(np.maximum(s_fr, s_to) / rate - 1.0))


def bound_excess(grid: dict, u_gen, u_line, pgmin=None, pgmax=None) -> float:
    """Largest amount by which a generator output or a bus voltage lies
    outside its bounds (per unit; 0 when all are inside): pg within
    ``pgmin``/``pgmax`` (the grid's, or the tightened bounds of a tracked
    period), qg within the grid's, and the squared voltage magnitudes of
    both ends of every line within [Vmin^2, Vmax^2]."""
    g = grid
    pgmin = g["pgmin"] if pgmin is None else pgmin
    pgmax = g["pgmax"] if pgmax is None else pgmax
    vmin2, vmax2 = g["Vmin"] * g["Vmin"], g["Vmax"] * g["Vmax"]
    parts = [u_gen[:, 0] - pgmax, pgmin - u_gen[:, 0],
             u_gen[:, 1] - g["qgmax"], g["qgmin"] - u_gen[:, 1]]
    for col, bus in ((WI, g["line_from"]), (WJ, g["line_to"])):
        parts += [u_line[:, col] - vmax2[bus], vmin2[bus] - u_line[:, col]]
    return float(np.maximum(0.0, np.max(np.concatenate(parts))))


def tightened_bounds(grid: dict, pg_prev, ramp_ratio: float):
    """The pg bounds of a tracked period: the grid's, narrowed to the last
    period's output plus or minus the ramp rate (ramp_ratio * pgmax)."""
    r = ramp_ratio * grid["pgmax"]
    return (np.maximum(grid["pgmin"], pg_prev - r),
            np.minimum(grid["pgmax"], pg_prev + r))


def marginal_cost(grid: dict, pg):
    """Each generator's marginal cost at the output ``pg`` (per unit), in
    the case's cost units per unit of power: d/dpg of c2 (B pg)^2 + c1 B
    pg."""
    B = grid["baseMVA"]
    return 2.0 * grid["c2"] * B * B * np.asarray(pg) + grid["c1"] * B


def stationarity(grid: dict, pg, l_pg, pgmin=None, pgmax=None,
                 free=None) -> float:
    """Worst gap between a generator's marginal cost and the price its
    multiplier ``l_pg`` sets, as a share of the marginal cost, over the
    generators strictly inside their pg bounds (the grid's, or a tracked
    period's tightened ones): at an optimum the two are equal, since the
    multiplier of the generator's consensus row is the price of power at
    its bus. In a period of a horizon, ``free`` (``off_ramp_limits``'s row
    of the period) also leaves out each generator at the ramp limit to
    either neighbouring period: the multiplier of a ramp at its limit adds
    to that generator's price. 0 when no generator is left."""
    pgmin = grid["pgmin"] if pgmin is None else pgmin
    pgmax = grid["pgmax"] if pgmax is None else pgmax
    inside = (pg > pgmin) & (pg < pgmax)
    if free is not None:
        inside &= free
    mc = marginal_cost(grid, pg)
    gap = np.abs(mc + l_pg)[inside] / np.abs(mc[inside])
    return float(np.max(gap)) if gap.size else 0.0


def ramp_steps(grid: dict, pg, ramp_ratio: float):
    """(T - 1, ngen): each generator's change of output between consecutive
    periods of the (T, ngen) dispatch ``pg`` (per unit), as a share of its
    ramp limit ``ramp_ratio`` * pgmax (a generator that does not move reads
    0 whatever its limit)."""
    step = np.abs(np.diff(np.asarray(pg), axis=0))
    limit = ramp_ratio * grid["pgmax"]
    with np.errstate(divide="ignore"):
        return np.divide(step, limit, out=np.zeros_like(step),
                         where=step != 0)


def ramp_excess(grid: dict, pg, ramp_ratio: float) -> float:
    """Worst ramp of the (T, ngen) dispatch ``pg``: max over periods t >= 2
    and generators of |pg_t - pg_{t-1}| over its limit ``ramp_ratio`` *
    pgmax, less 1, a share of the limit; negative when every ramp is inside
    its limit, NaN with a NaN output."""
    return float(np.max(ramp_steps(grid, pg, ramp_ratio)) - 1.0)


def off_ramp_limits(grid: dict, pg, ramp_ratio: float):
    """(T, ngen) flags of the (T, ngen) dispatch ``pg``: whether each
    generator's ramps from the period before and to the period after
    (where there is one) lie under ``AT_LIMIT`` of their limit."""
    under = ramp_steps(grid, pg, ramp_ratio) < AT_LIMIT
    edge = np.ones((1, under.shape[1]), dtype=bool)
    return np.concatenate([edge, under]) & np.concatenate([under, edge])
