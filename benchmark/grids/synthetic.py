"""A synthetic transmission grid at given counts of buses, lines and
generators, as plain numpy arrays.

The network is made up, drawn from the seed: buses at random places in a
square, lines between neighbours (the Delaunay triangulation's minimum
spanning tree and chords from its other edges), reactances that grow with
a line's length, ratings and generator costs. Its operating point is
physical: loads are positive (a share ``LOAD_FRAC`` of the buses
without a generator carries one, with a power factor of 0.93 to 0.99),
generators run between their minimum and maximum output, and the voltages
solve the AC power flow of that dispatch (Newton's method, to 1e-11 per
unit), so the case holds a known AC-feasible point (``Vm``, ``Va``,
``Pg0``, ``Qg0``) with every voltage inside its bounds. Line ratings lie
30 % or more above the point's flows.

Keys and units are those of the port's ``OPFData``: loads in MW/MVAr,
generator quantities per unit, cost coefficients in raw MATPOWER units.
The harness wraps the arrays in ``OPFData`` on the port's side only; the
reference (``reference.py``) reads them as they are.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import minimum_spanning_tree
from scipy.sparse.linalg import spsolve
from scipy.spatial import Delaunay

BASE_MVA = 100.0
#: the share of the buses without a generator that carry a load, and the
#: mean active load of one (per unit)
LOAD_FRAC, MEAN_LOAD = 0.7, 0.15
#: the share of the lines with a rating
RATE_FRAC = 0.7


def make(nbus: int, nline: int, ngen: int, *, seed: int) -> dict:
    """The grid of ``nbus`` buses, ``nline`` lines and ``ngen`` generators
    (one a bus, bus 0 the reference) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if nline < nbus - 1 or not 0 < ngen <= nbus:
        raise ValueError(f"{nline} lines and {ngen} generators do not make "
                         f"a grid of {nbus} buses")

    # buses at random places in the unit square; the lines join neighbours
    # of the Delaunay triangulation: its minimum spanning tree, then chords
    # drawn from its other edges
    xy = rng.random((nbus, 2))
    edges = _delaunay_edges(xy)
    length = np.hypot(*(xy[edges[:, 0]] - xy[edges[:, 1]]).T)
    tree = minimum_spanning_tree(sp.csr_matrix(
        (length, (edges[:, 0], edges[:, 1])), shape=(nbus, nbus))).tocoo()
    key = edges[:, 0].astype(np.int64) * nbus + edges[:, 1]
    others = edges[~np.isin(key, tree.row.astype(np.int64) * nbus + tree.col)]
    if nline - (nbus - 1) > len(others):
        raise ValueError(f"{nline} lines are more than the triangulation of "
                         f"{nbus} buses holds")
    chords = others[rng.choice(len(others), nline - (nbus - 1),
                               replace=False)]
    ends = np.concatenate([np.stack([tree.row, tree.col], 1), chords])
    line_from, line_to = ends[:, 0].astype(np.int32), ends[:, 1].astype(
        np.int32)
    length = np.hypot(*(xy[line_from] - xy[line_to]).T)

    # r/x of 0.05-0.3, as on transmission lines
    # reactance grows with the line's length, 0.02 at the mean length
    x = np.clip(0.02 * length / length.mean() * rng.uniform(0.7, 1.3, nline),
                0.005, 0.3)
    r = x * rng.uniform(0.05, 0.3, nline)
    b = rng.uniform(0.0, 0.05, nline)
    tap = np.where(rng.random(nline) < 0.1, rng.uniform(0.95, 1.05, nline),
                   1.0)
    shift = np.where(rng.random(nline) < 0.03, rng.uniform(-5.0, 5.0, nline),
                     0.0)
    tap_c = tap * np.exp(1j * np.deg2rad(shift))
    Ys = 1.0 / (r + 1j * x)
    Ytt = Ys + 0.5j * b
    Yff = Ytt / (tap_c * np.conj(tap_c))
    Yft = -Ys / np.conj(tap_c)
    Ytf = -Ys / tap_c
    YshI = np.where(rng.random(nbus) < 0.05, rng.uniform(0.0, 0.2, nbus), 0.0)

    gen_bus = np.concatenate([[0], rng.choice(np.arange(1, nbus), ngen - 1,
                                              replace=False)]).astype(np.int32)
    is_gen = np.zeros(nbus, bool)
    is_gen[gen_bus] = True
    loaded = ~is_gen & (rng.random(nbus) < LOAD_FRAC)
    sigma = 0.8
    pd = np.where(loaded, rng.lognormal(np.log(MEAN_LOAD) - sigma**2 / 2,
                                        sigma, nbus), 0.0)
    qd = pd * np.tan(np.arccos(rng.uniform(0.93, 0.99, nbus)))

    # each generator runs at 40-80 % of its maximum output
    cap = rng.uniform(1.0, 6.0, ngen)
    share = rng.uniform(0.4, 0.8, ngen)
    vset = rng.uniform(0.98, 1.04, ngen)
    Ybus = _ybus(nbus, line_from, line_to, Yff, Yft, Ytf, Ytt, 1j * YshI)
    vm = np.ones(nbus)
    vm[gen_bus] = vset
    va = np.zeros(nbus)
    losses = 0.0
    for _ in range(4):
        # the dispatch covers the load and the last solve's losses, so the
        # reference bus's generator ends at its own share as well
        pg = cap * share
        pg *= (pd.sum() + losses) / pg.sum()
        vm, va = _power_flow(Ybus, gen_bus, pg, pd, qd, vm, va)
        losses = float(np.sum(_sbus(Ybus, vm, va).real))
    s = _sbus(Ybus, vm, va)
    pg_star, qg_star = s.real[gen_bus], s.imag[gen_bus]
    # the loads that the voltages serve exactly: the drawn ones to 1e-11
    pd, qd = np.where(is_gen, 0.0, -s.real), np.where(is_gen, 0.0, -s.imag)

    pgmax = np.maximum(pg_star / share, pg_star + 0.1)
    pgmin = np.minimum(pgmax * rng.uniform(0.0, 0.3, ngen), pg_star)
    qgmax = np.maximum(qg_star, 0.0) + pgmax * rng.uniform(0.3, 0.6, ngen)
    qgmin = np.minimum(qg_star, 0.0) - pgmax * rng.uniform(0.2, 0.4, ngen)
    c2 = rng.uniform(0.01, 0.12, ngen)
    c1 = rng.uniform(1.0, 10.0, ngen)

    V = vm * np.exp(1j * va)
    Vf, Vt = V[line_from], V[line_to]
    Sf = Vf * np.conj(Yff * Vf + Yft * Vt)
    St = Vt * np.conj(Ytf * Vf + Ytt * Vt)
    smax = np.maximum(np.abs(Sf), np.abs(St))
    rateA = np.where(rng.random(nline) < RATE_FRAC,
                     BASE_MVA * smax * rng.uniform(1.3, 3.0, nline), 0.0)
    if not (0.9 < vm.min() and vm.max() < 1.1):
        raise ValueError(f"the power flow's voltages {vm.min():.3f}-"
                         f"{vm.max():.3f} leave [0.9, 1.1]")

    bus_type = np.ones(nbus, dtype=np.int32)
    bus_type[gen_bus] = 2
    bus_type[0] = 3
    return dict(
        case=f"synthetic{nbus}",
        baseMVA=BASE_MVA,
        bus_ref=0,
        bus_i=np.arange(1, nbus + 1, dtype=np.int64),
        bus_type=bus_type,
        Pd=pd * BASE_MVA,
        Qd=qd * BASE_MVA,
        Vmin=np.full(nbus, 0.9),
        Vmax=np.full(nbus, 1.1),
        Vm=vm,
        Va=va,
        YshR=np.zeros(nbus),
        YshI=YshI,
        gen_bus=gen_bus,
        pgmin=pgmin, pgmax=pgmax, qgmin=qgmin, qgmax=qgmax,
        vgm_setpoint=vset,
        Pg0=pg_star,
        Qg0=qg_star,
        ramp_agc=0.02 * pgmax,
        c2=c2, c1=c1, c0=np.zeros(ngen),
        line_from=line_from,
        line_to=line_to,
        YffR=Yff.real.copy(), YffI=Yff.imag.copy(),
        YttR=Ytt.real.copy(), YttI=Ytt.imag.copy(),
        YftR=Yft.real.copy(), YftI=Yft.imag.copy(),
        YtfR=Ytf.real.copy(), YtfI=Ytf.imag.copy(),
        rateA=rateA,
    )


def _delaunay_edges(xy) -> np.ndarray:
    """(E, 2) the edges of the Delaunay triangulation of the points, each
    once, lower index first."""
    t = Delaunay(xy).simplices
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [0, 2]]])
    return np.unique(np.sort(e, axis=1), axis=0)


def _ybus(nbus, fr, to, Yff, Yft, Ytf, Ytt, ysh):
    rows = np.concatenate([fr, fr, to, to, np.arange(nbus)])
    cols = np.concatenate([fr, to, fr, to, np.arange(nbus)])
    vals = np.concatenate([Yff, Yft, Ytf, Ytt, ysh])
    return sp.csr_matrix((vals, (rows, cols)), shape=(nbus, nbus))


def _sbus(Ybus, vm, va):
    """Each bus's injection (generation less load, per unit) at the
    voltages: V conj(Ybus V)."""
    V = vm * np.exp(1j * va)
    return V * np.conj(Ybus @ V)


def _power_flow(Ybus, gen_bus, pg, pd, qd, vm, va, tol=1e-11, maxit=30):
    """Newton's method on the polar AC power flow: bus 0 the reference,
    the other generator buses hold P and |V|, the rest P and Q. Returns
    (vm, va)."""
    nbus = len(vm)
    p = -pd.copy()
    p[gen_bus] += pg
    spec = p - 1j * qd
    pv = gen_bus[1:]
    is_pq = np.ones(nbus, bool)
    is_pq[gen_bus] = False
    pq = np.flatnonzero(is_pq)
    pvpq = np.concatenate([pv, pq])
    for _ in range(maxit):
        V = vm * np.exp(1j * va)
        mis = V * np.conj(Ybus @ V) - spec
        F = np.concatenate([mis.real[pvpq], mis.imag[pq]])
        if np.max(np.abs(F)) < tol:
            return vm, va
        Ibus = Ybus @ V
        dV, dVn = sp.diags(V), sp.diags(V / vm)
        dS_dva = 1j * dV @ (sp.diags(Ibus) - Ybus @ dV).conj()
        dS_dvm = dV @ (Ybus @ dVn).conj() + sp.diags(Ibus.conj()) @ dVn
        a, m = dS_dva.tocsr(), dS_dvm.tocsr()
        J = sp.bmat([[a[pvpq][:, pvpq].real, m[pvpq][:, pq].real],
                     [a[pq][:, pvpq].imag, m[pq][:, pq].imag]], format="csc")
        dx = spsolve(J, -F)
        va[pvpq] += dx[:len(pvpq)]
        vm[pq] += dx[len(pvpq):]
    raise ValueError(f"the power flow did not converge in {maxit} steps "
                     f"(mismatch {np.max(np.abs(F)):.3g})")
