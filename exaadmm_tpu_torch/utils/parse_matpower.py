"""MATPOWER ``.m`` case parser.

A numpy-only copy of ``exaadmm_tpu/utils/parse_matpower.py``.

Produces a plain dict of numpy arrays (column-oriented), mirroring the
semantics of the reference parser (ExaAdmm.jl ``src/utils/parse_matpower.jl``):

- supports the ``matpower`` and ``pglib`` gen-table layouts
  (reference ``get_field_names``, parse_matpower.jl:18-44),
- filters out inactive generators/branches (``status != 1``) together with the
  matching ``gencost`` rows (parse_matpower.jl add_gen/add_branch),
- converts bus ``Va`` from degrees to radians (parse_matpower.jl add_bus),
- scales gen ``Pg/Qg/Qmax/Qmin/Pmax/Pmin`` to per-unit by ``baseMVA``
  (parse_matpower.jl add_gen),
- computes per-branch admittances Yff/Yft/Ytf/Ytt with tap/phase-shift handling
  and per-bus shunts (parse_matpower.jl add_admittance_shunt).

The implementation itself is a fresh, vectorised numpy design (the reference is
row-of-dicts Julia); only the field conventions match.
"""

from __future__ import annotations

import re

import numpy as np

BUS_FIELDS = [
    "bus_i", "type", "Pd", "Qd", "Gs", "Bs", "area",
    "Vm", "Va", "baseKV", "zone", "Vmax", "Vmin",
]
GEN_FIELDS_MATPOWER = [
    "bus", "Pg", "Qg", "Qmax", "Qmin", "Vg", "mBase", "status", "Pmax", "Pmin",
    "Pc1", "Pc2", "Qc1min", "Qc1max", "Qc2min", "Qc2max", "ramp_agc",
    "ramp_10", "ramp_30", "ramp_q", "apf",
]
GEN_FIELDS_PGLIB = GEN_FIELDS_MATPOWER[:10]
BRANCH_FIELDS = [
    "fbus", "tbus", "r", "x", "b", "rateA", "rateB", "rateC",
    "ratio", "angle", "status", "angmin", "angmax",
]
# Quadratic cost only (reference asserts gentype==2 && n==3).
GENCOST_FIELDS = ["cost_type", "startup", "shutdown", "n", "c2", "c1", "c0"]

_TABLE_KEYS = ("mpc.bus", "mpc.gen", "mpc.branch", "mpc.gencost")


def _read_tables(text: str) -> dict:
    """Extract baseMVA and the numeric matrices from a MATPOWER file."""
    out: dict = {}
    m = re.search(r"mpc\.baseMVA\s*=\s*([0-9eE+\-.]+)\s*;", text)
    if m is None:
        raise ValueError("mpc.baseMVA not found in case file")
    out["baseMVA"] = float(m.group(1))

    for key in _TABLE_KEYS:
        pat = re.compile(re.escape(key) + r"\s*=\s*\[(.*?)\];", re.S)
        m = pat.search(text)
        if m is None:
            if key == "mpc.gencost":
                raise ValueError("mpc.gencost not found (required)")
            raise ValueError(f"{key} not found in case file")
        rows = []
        for line in m.group(1).splitlines():
            line = line.split("%", 1)[0].strip().rstrip(";").strip()
            if not line:
                continue
            rows.append([float(tok) for tok in line.split()])
        ncols = max(len(r) for r in rows)
        mat = np.zeros((len(rows), ncols))
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        out[key] = mat
    return out


def parse_matpower(path: str, case_format: str = "matpower", verbose: int = 1) -> dict:
    """Parse a MATPOWER case into a dict of column arrays.

    Returns a dict with keys: ``baseMVA`` (float); ``bus``, ``gen``, ``branch``,
    ``gencost`` — each a dict of field-name -> 1-D numpy array (active rows
    only for gen/branch); plus index-map helpers ``bus_i2idx`` (dict),
    ``bus_ref`` (0-based index of the reference bus).
    """
    case_format = case_format.lower()
    if case_format not in ("matpower", "pglib"):
        raise ValueError(f"unknown case_format {case_format!r}")

    with open(path) as f:
        raw = _read_tables(f.read())

    baseMVA = raw["baseMVA"]
    data: dict = {"baseMVA": baseMVA, "case_format": case_format}

    # --- buses ---------------------------------------------------------
    bus_mat = raw["mpc.bus"]
    bus = {name: bus_mat[:, k].copy() for k, name in enumerate(BUS_FIELDS)}
    bus["Va"] = bus["Va"] * (np.pi / 180.0)
    refs = np.nonzero(bus["type"].astype(int) == 3)[0]
    if refs.size == 0:
        raise ValueError("reference bus (type 3) not found")
    if refs.size > 1:
        raise ValueError("more than one reference bus present in the data")
    data["bus"] = bus
    data["bus_ref"] = int(refs[0])
    data["bus_i2idx"] = {int(b): i for i, b in enumerate(bus["bus_i"].astype(int))}

    # --- generators (+ matching gencost rows), filter inactive ---------
    gen_fields = GEN_FIELDS_MATPOWER if case_format == "matpower" else GEN_FIELDS_PGLIB
    gen_mat = raw["mpc.gen"]
    cost_mat = raw["mpc.gencost"]
    active = gen_mat[:, gen_fields.index("status")].astype(int) == 1
    gen_mat = gen_mat[active]
    cost_mat = cost_mat[active]
    gen = {}
    for k, name in enumerate(gen_fields):
        col = gen_mat[:, k].copy() if k < gen_mat.shape[1] else np.zeros(len(gen_mat))
        if name in ("Pg", "Qg", "Qmax", "Qmin", "Pmax", "Pmin"):
            col = col / baseMVA
            # cap infinite limits like the reference (opfdata.jl:196-207)
            cap = 999.99 / baseMVA if name in ("Qmax", "Pmax") else -999.99 / baseMVA
            if name in ("Qmax", "Pmax"):
                col = np.where(np.isinf(col), 999.99, col)
            elif name in ("Qmin", "Pmin"):
                col = np.where(np.isinf(col), -999.99, col)
            del cap
        gen[name] = col
    data["gen"] = gen

    gencost = {name: cost_mat[:, k].copy() for k, name in enumerate(GENCOST_FIELDS)}
    if not np.all(gencost["cost_type"].astype(int) == 2):
        raise ValueError("only polynomial (type 2) generator costs are supported")
    if not np.all(gencost["n"].astype(int) == 3):
        raise ValueError("only quadratic (n=3) generator costs are supported")
    data["gencost"] = gencost

    # --- branches, filter inactive -------------------------------------
    br_mat = raw["mpc.branch"]
    active = br_mat[:, BRANCH_FIELDS.index("status")].astype(int) == 1
    br_mat = br_mat[active]
    branch = {name: br_mat[:, k].copy() for k, name in enumerate(BRANCH_FIELDS)}
    data["branch"] = branch

    # --- admittances ----------------------------------------------------
    r, x, b = branch["r"], branch["x"], branch["b"]
    tap = np.where(branch["ratio"] == 0.0, 1.0, branch["ratio"]).astype(complex)
    tap = tap * np.exp(1j * branch["angle"] * (np.pi / 180.0))
    Ys = 1.0 / (r + 1j * x)
    Ytt = Ys + 0.5j * b
    Yff = Ytt / (tap * np.conj(tap))
    Yft = -Ys / np.conj(tap)
    Ytf = -Ys / tap
    data["YffR"], data["YffI"] = Yff.real.copy(), Yff.imag.copy()
    data["YttR"], data["YttI"] = Ytt.real.copy(), Ytt.imag.copy()
    data["YftR"], data["YftI"] = Yft.real.copy(), Yft.imag.copy()
    data["YtfR"], data["YtfI"] = Ytf.real.copy(), Ytf.imag.copy()
    data["YshR"] = bus["Gs"] / baseMVA
    data["YshI"] = bus["Bs"] / baseMVA

    for k in ("YffR", "YffI", "YttR", "YttI", "YftR", "YftI", "YtfR", "YtfI"):
        if not np.all(np.isfinite(data[k])):
            raise ValueError(f"non-finite admittance in {k}")

    if verbose >= 1:
        print(f" ** Statistics of {path}")
        print(f"  # buses     : {len(bus['bus_i']):5d}")
        print(f"  # generators: {len(gen['bus']):5d} active")
        print(f"  # branches  : {len(branch['fbus']):5d} active")

    return data
