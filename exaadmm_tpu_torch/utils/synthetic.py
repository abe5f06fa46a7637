"""Synthetic grid generator for benchmark-scale cases.

A numpy-only copy of ``exaadmm_tpu/utils/synthetic.py``: the same seed gives
the same grid in both packages.

The reference benchmarks on pegase/ACTIVSg MATPOWER artifacts that are
lazy-downloaded at test time (test/Artifacts.toml) and not redistributable
with this repository. For performance work we generate random but
structurally realistic grids: a spanning tree plus random chords (matching
pegase-like nline/nbus ratios), per-unit impedances in typical ranges, and —
critically — loads/dispatch windows/line ratings derived from a randomly
drawn voltage profile pushed through the network equations, so every case
has a known AC-feasible operating point (stored in Vm/Va/Pg0/Qg0).

These are for throughput and convergence-behaviour work at scale, not for
objective-value regression — use real MATPOWER files for that.
"""

from __future__ import annotations

import numpy as np

from .opfdata import OPFData


def synthetic_case(
    nbus: int,
    *,
    line_ratio: float = 1.7,     # nline / nbus (pegase ~1.7, ACTIVSg70k ~1.26)
    gen_frac: float = 0.15,
    load_frac: float = 0.7,
    rate_frac: float = 0.7,      # fraction of lines with a finite rateA
    seed: int = 0,
) -> OPFData:
    rng = np.random.default_rng(seed)
    nline = int(round(nbus * line_ratio))
    assert nline >= nbus - 1

    # spanning tree: each bus i>=1 attaches to a random earlier bus
    fr_tree = np.array([rng.integers(0, i) for i in range(1, nbus)], dtype=np.int64)
    to_tree = np.arange(1, nbus, dtype=np.int64)
    nchord = nline - (nbus - 1)
    fr_ch = rng.integers(0, nbus, nchord)
    to_ch = (fr_ch + 1 + rng.integers(0, nbus - 1, nchord)) % nbus
    line_from = np.concatenate([fr_tree, fr_ch]).astype(np.int32)
    line_to = np.concatenate([to_tree, to_ch]).astype(np.int32)

    r = rng.uniform(0.001, 0.03, nline)
    x = rng.uniform(0.01, 0.15, nline)
    b = rng.uniform(0.0, 0.10, nline)
    tap = np.where(rng.random(nline) < 0.1, rng.uniform(0.95, 1.05, nline), 0.0)
    shift = np.where(rng.random(nline) < 0.03, rng.uniform(-5.0, 5.0, nline), 0.0)

    tap_c = np.where(tap == 0.0, 1.0, tap).astype(complex)
    tap_c = tap_c * np.exp(1j * shift * np.pi / 180.0)
    Ys = 1.0 / (r + 1j * x)
    Ytt = Ys + 0.5j * b
    Yff = Ytt / (tap_c * np.conj(tap_c))
    Yft = -Ys / np.conj(tap_c)
    Ytf = -Ys / tap_c

    baseMVA = 100.0
    ngen = max(1, int(round(nbus * gen_frac)))
    gen_bus = np.concatenate([[0], rng.choice(np.arange(1, nbus), ngen - 1,
                                              replace=False)]).astype(np.int32)

    # Construct the case around a KNOWN AC-feasible operating point: draw a
    # voltage profile, push it through the network equations, and derive
    # loads, dispatch windows and line ratings from the implied flows. A
    # purely random case (loads drawn independently of the physics) gives an
    # ADMM instance with no nearby feasible point and meaningless
    # convergence behaviour.
    vm = rng.uniform(0.99, 1.03, nbus)
    va = rng.normal(0.0, 0.02, nbus)
    va[0] = 0.0
    V = vm * np.exp(1j * va)
    Vf, Vt = V[line_from], V[line_to]
    # per-line complex flows at the operating point
    Sf = Vf * np.conj(Yff * Vf + Yft * Vt)
    St = Vt * np.conj(Ytf * Vf + Ytt * Vt)
    YshI_arr = np.where(rng.random(nbus) < 0.05, rng.uniform(0, 0.2, nbus), 0.0)
    inj = np.zeros(nbus, complex)
    np.add.at(inj, line_from, Sf)
    np.add.at(inj, line_to, St)
    inj += vm**2 * np.conj(1j * YshI_arr)  # shunt injections

    is_gen = np.zeros(nbus, bool)
    is_gen[gen_bus] = True
    # load buses consume exactly the (possibly negative) implied injection;
    # generator buses supply theirs — the chosen V is then exactly feasible
    Pd = (-inj.real) * ~is_gen
    Qd = (-inj.imag) * ~is_gen
    pg_star = inj.real[gen_bus]
    qg_star = inj.imag[gen_bus]

    pgmax = np.abs(pg_star) + rng.uniform(0.5, 2.0, ngen)
    pgmin = np.minimum(pg_star - 0.3, 0.0)
    qgmax = np.abs(qg_star) + rng.uniform(0.5, 2.0, ngen)
    qgmin = -qgmax
    c2 = rng.uniform(0.01, 0.12, ngen)
    c1 = rng.uniform(1.0, 10.0, ngen)
    c0 = np.zeros(ngen)

    # ratings with 30%+ margin over the operating flows; a fraction unlimited
    smax = np.maximum(np.abs(Sf), np.abs(St))
    rateA = np.where(rng.random(nline) < rate_frac,
                     baseMVA * smax * rng.uniform(1.3, 3.0, nline), 0.0)
    Pd = Pd * baseMVA
    Qd = Qd * baseMVA

    bus_type = np.ones(nbus, dtype=np.int32)
    bus_type[gen_bus] = 2
    bus_type[0] = 3

    return OPFData(
        case=f"synthetic{nbus}",
        baseMVA=baseMVA,
        bus_ref=0,
        bus_i=np.arange(1, nbus + 1, dtype=np.int64),
        bus_type=bus_type,
        Pd=Pd,
        Qd=Qd,
        Vmin=np.full(nbus, 0.9),
        Vmax=np.full(nbus, 1.1),
        Vm=vm,
        Va=va,
        YshR=np.zeros(nbus),
        YshI=YshI_arr,
        gen_bus=gen_bus,
        pgmin=pgmin, pgmax=pgmax, qgmin=qgmin, qgmax=qgmax,
        vgm_setpoint=np.ones(ngen),
        Pg0=pg_star,
        Qg0=qg_star,
        ramp_agc=0.02 * pgmax,
        c2=c2, c1=c1, c0=c0,
        line_from=line_from,
        line_to=line_to,
        YffR=Yff.real.copy(), YffI=Yff.imag.copy(),
        YttR=Ytt.real.copy(), YttI=Ytt.imag.copy(),
        YftR=Yft.real.copy(), YftI=Yft.imag.copy(),
        YtfR=Ytf.real.copy(), YtfI=Ytf.imag.copy(),
        rateA=rateA,
    )


def synthetic_load_profile(data: OPFData, T: int, seed: int = 0):
    """Per-period loads (Pd, Qd), each (nbus, T) in MW/MVAr: the base loads
    times 1 + 0.05 N(0, 1), one factor per period from
    ``default_rng(seed)``. This is the profile of the JAX package's
    multi-period benchmark (``tools/model_bench.py``)."""
    profile = 1.0 + 0.05 * np.random.default_rng(seed).standard_normal(T)
    return (np.outer(np.asarray(data.Pd), profile),
            np.outer(np.asarray(data.Qd), profile))
