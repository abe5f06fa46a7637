"""Host-side OPF data model (numpy).

A numpy-only copy of ``exaadmm_tpu/utils/opfdata.py`` (that package pulls in
jax on import, and the port must not).

Flat, array-oriented equivalent of the reference's record-struct ``OPFData``
(ExaAdmm.jl ``src/utils/opfdata.jl:72-85``): all per-bus / per-gen /
per-branch quantities are numpy columns, and the bus<->component adjacency is
kept as integer index arrays (suitable for ``segment_sum``/gather on device)
instead of Julia's array-of-arrays CSR maps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .parse_matpower import parse_matpower


@dataclasses.dataclass
class OPFData:
    """Parsed, per-unit, active-only OPF case (host-side, numpy)."""

    case: str
    baseMVA: float
    bus_ref: int  # 0-based bus index of the reference bus

    # buses (nbus,)
    bus_i: np.ndarray      # original MATPOWER bus ids (int)
    bus_type: np.ndarray   # 1 PQ, 2 PV, 3 ref (int)
    Pd: np.ndarray         # MW (not per-unit; reference keeps MW and divides in kernels)
    Qd: np.ndarray         # MVAr
    Vmin: np.ndarray
    Vmax: np.ndarray
    Vm: np.ndarray
    Va: np.ndarray         # radians
    YshR: np.ndarray       # Gs/baseMVA
    YshI: np.ndarray       # Bs/baseMVA

    # generators (ngen,) — power quantities per-unit
    gen_bus: np.ndarray    # 0-based bus index (int)
    pgmin: np.ndarray
    pgmax: np.ndarray
    qgmin: np.ndarray
    qgmax: np.ndarray
    vgm_setpoint: np.ndarray  # gen Vg setpoint (for mpec / primary control)
    Pg0: np.ndarray           # case-file gen setpoints (per-unit, warm starts)
    Qg0: np.ndarray
    ramp_agc: np.ndarray      # per-unit ramp limit from MATPOWER column (may be 0)
    c2: np.ndarray         # $/MW^2 h (raw MATPOWER units)
    c1: np.ndarray         # $/MW h
    c0: np.ndarray         # $

    # branches (nline,)
    line_from: np.ndarray  # 0-based bus index (int)
    line_to: np.ndarray    # 0-based bus index (int)
    YffR: np.ndarray
    YffI: np.ndarray
    YttR: np.ndarray
    YttI: np.ndarray
    YftR: np.ndarray
    YftI: np.ndarray
    YtfR: np.ndarray
    YtfI: np.ndarray
    rateA: np.ndarray      # MVA (0 means unlimited)

    @property
    def nbus(self) -> int:
        return len(self.bus_i)

    @property
    def ngen(self) -> int:
        return len(self.gen_bus)

    @property
    def nline(self) -> int:
        return len(self.line_from)


def opf_loaddata(case: str, case_format: str = "matpower", verbose: int = 1) -> OPFData:
    """Load a MATPOWER case into an :class:`OPFData`.

    Mirrors reference ``opf_loaddata`` -> ``opf_loaddata_matpower``
    (opfdata.jl:408-415, 132-395) minus the storage extension (added
    separately when storage is requested).
    """
    d = parse_matpower(case, case_format=case_format, verbose=verbose)
    i2idx = d["bus_i2idx"]

    gen_bus = np.array([i2idx[int(b)] for b in d["gen"]["bus"]], dtype=np.int32)
    line_from = np.array([i2idx[int(b)] for b in d["branch"]["fbus"]], dtype=np.int32)
    line_to = np.array([i2idx[int(b)] for b in d["branch"]["tbus"]], dtype=np.int32)

    return OPFData(
        case=case,
        baseMVA=d["baseMVA"],
        bus_ref=d["bus_ref"],
        bus_i=d["bus"]["bus_i"].astype(np.int64),
        bus_type=d["bus"]["type"].astype(np.int32),
        Pd=d["bus"]["Pd"],
        Qd=d["bus"]["Qd"],
        Vmin=d["bus"]["Vmin"],
        Vmax=d["bus"]["Vmax"],
        Vm=d["bus"]["Vm"],
        Va=d["bus"]["Va"],
        YshR=d["YshR"],
        YshI=d["YshI"],
        gen_bus=gen_bus,
        pgmin=d["gen"]["Pmin"],
        pgmax=d["gen"]["Pmax"],
        qgmin=d["gen"]["Qmin"],
        qgmax=d["gen"]["Qmax"],
        vgm_setpoint=d["gen"]["Vg"],
        Pg0=d["gen"]["Pg"],
        Qg0=d["gen"]["Qg"],
        ramp_agc=d["gen"].get("ramp_agc", np.zeros(len(gen_bus))) / d["baseMVA"],
        c2=d["gencost"]["c2"],
        c1=d["gencost"]["c1"],
        c0=d["gencost"]["c0"],
        line_from=line_from,
        line_to=line_to,
        YffR=d["YffR"], YffI=d["YffI"],
        YttR=d["YttR"], YttI=d["YttI"],
        YftR=d["YftR"], YftI=d["YftI"],
        YtfR=d["YtfR"], YtfI=d["YtfI"],
        rateA=d["branch"]["rateA"],
    )


def load_time_series(prefix: str, load_scale: float = 1.0):
    """Load ``<prefix>.Pd`` / ``<prefix>.Qd`` whitespace-delimited matrices.

    Reference: ``get_load`` (opfdata.jl:121-130). Rows = buses, cols = periods.
    """
    pd = np.loadtxt(prefix + ".Pd", ndmin=2) * load_scale
    qd = np.loadtxt(prefix + ".Qd", ndmin=2) * load_scale
    if pd.shape != qd.shape:
        raise ValueError(f"Pd shape {pd.shape} != Qd shape {qd.shape}")
    return pd, qd
