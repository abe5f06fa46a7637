"""State carried between the JAX package and the port, as numpy arrays.

Both packages describe the same grid and the same ADMM state with the same
field names. These helpers take and give plain dicts of numpy arrays keyed
by those names, so a caller holding a JAX ``GridData`` or ``Solution`` (one
``np.asarray`` per leaf) can hand it to the port and compare what comes back.

- grid: ``{"nbus": int, ..., "baseMVA": float or 0-d array, "YffR": (N,), ...}``
- solution: ``{"u": {"gen": (ngen, 2), "line": (N, 8)}, ...,
  "branch_alm": {"lam1": (N,), "lam2": (N,), "mu": (N,)}}``
- multi-period solution: ``{"acopf": <solution dict of (T, ...) arrays>,
  "ramp": {"u": (T, ngen), ..., "alm_xi": (T, ngen)}}``
- QP-subproblem solution: ``{"base": <solution dict>, "sqp_line": (N, 6),
  "v_prev": {"gen": ..., "line": ...}, "alm_lam_j": (N,), "alm_lam_k": (N,),
  "alm_mu": (N,)}``
- MPEC solution: a solution dict whose blocks hold ``"gen"``, ``"vg"``,
  ``"fg"``, ``"sto"`` and ``"line"``
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .environment import (QPSUB_ALM_FIELDS, RAMP_FIELDS, SOLUTION_BLOCKS,
                          Blocks, BranchALMState, RampState, Solution,
                          SolutionMpacopf, SolutionQpsub)
from .grid_data import GridData, build_csr
from ..models.mpec.model import MPEC_FIELDS, MpecBlocks, SolutionMpec

_SIZES = ("nbus", "ngen", "nline", "nline_padded")
_INDEX_FIELDS = ("gen_bus", "line_from", "line_to")
# the port's own fields: the bus adjacency, and the mesh of a rank's local
# grid (None on a whole grid)
_DERIVED = ("arc_ptr", "arc_idx", "arc_bus", "gen_ptr", "gen_idx", "mesh")


def grid_data_from_numpy(d: dict, *, dtype=torch.float64,
                         device="cpu") -> GridData:
    """A port :class:`GridData` from the fields of a JAX ``GridData``; the
    bus adjacency (CSR) is rebuilt from ``line_from``/``line_to``/
    ``gen_bus``/``line_mask``."""
    kw = {k: int(d[k]) for k in _SIZES}
    kw["baseMVA"] = float(np.asarray(d["baseMVA"]))
    for f in dataclasses.fields(GridData):
        name = f.name
        if name in kw or name in _DERIVED:
            continue
        a = np.asarray(d[name])
        if name in _INDEX_FIELDS:
            kw[name] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            kw[name] = torch.as_tensor(a.astype(np.float64)).to(
                device=device, dtype=dtype)
    fr = np.asarray(d["line_from"], dtype=np.int64)
    to = np.asarray(d["line_to"], dtype=np.int64)
    mask = np.asarray(d["line_mask"]) > 0.5
    arc_bus = np.concatenate([fr, to])
    arc_ptr, arc_idx = build_csr(arc_bus, kw["nbus"],
                                 valid=np.concatenate([mask, mask]))
    gen_ptr, gen_idx = build_csr(np.asarray(d["gen_bus"]), kw["nbus"])

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return GridData(**kw, arc_ptr=i32(arc_ptr), arc_idx=i32(arc_idx),
                    arc_bus=torch.as_tensor(arc_bus, device=device),
                    gen_ptr=i32(gen_ptr), gen_idx=i32(gen_idx))


def solution_from_numpy(d: dict, *, dtype=torch.float64,
                        device="cpu") -> Solution:
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    blocks = {k: Blocks(gen=t(d[k]["gen"]), line=t(d[k]["line"]))
              for k in SOLUTION_BLOCKS}
    alm = d["branch_alm"]
    return Solution(**blocks, branch_alm=BranchALMState(
        lam1=t(alm["lam1"]), lam2=t(alm["lam2"]), mu=t(alm["mu"])))


def mpacopf_solution_from_numpy(d: dict, *, dtype=torch.float64,
                                device="cpu") -> SolutionMpacopf:
    """A port :class:`SolutionMpacopf` from the nested dicts of
    ``mpacopf_solution_to_numpy``."""
    ramp = {k: torch.as_tensor(np.array(d["ramp"][k], dtype=np.float64)).to(
        device=device, dtype=dtype) for k in RAMP_FIELDS}
    return SolutionMpacopf(
        acopf=solution_from_numpy(d["acopf"], dtype=dtype, device=device),
        ramp=RampState(**ramp))


def qpsub_solution_from_numpy(d: dict, *, dtype=torch.float64,
                              device="cpu") -> SolutionQpsub:
    """A port :class:`SolutionQpsub` from the nested dicts of
    ``qpsub_solution_to_numpy``."""
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    return SolutionQpsub(
        base=solution_from_numpy(d["base"], dtype=dtype, device=device),
        sqp_line=t(d["sqp_line"]),
        v_prev=Blocks(gen=t(d["v_prev"]["gen"]), line=t(d["v_prev"]["line"])),
        **{k: t(d[k]) for k in QPSUB_ALM_FIELDS})


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def grid_to_numpy(gd) -> dict:
    """The fields of a ``GridData`` of either package: sizes as ints, every
    array as numpy."""
    return {f.name: (getattr(gd, f.name) if f.name in _SIZES
                     else _np(getattr(gd, f.name)))
            for f in dataclasses.fields(gd)}


def solution_to_numpy(sol) -> dict:
    """The state of a ``Solution`` of either package as nested numpy dicts."""
    out = {k: {"gen": _np(getattr(sol, k).gen), "line": _np(getattr(sol, k).line)}
           for k in SOLUTION_BLOCKS}
    alm = sol.branch_alm
    out["branch_alm"] = {k: _np(getattr(alm, k)) for k in ("lam1", "lam2", "mu")}
    return out


def mpacopf_solution_to_numpy(sol) -> dict:
    """The state of a ``SolutionMpacopf`` of either package as nested numpy
    dicts."""
    return {"acopf": solution_to_numpy(sol.acopf),
            "ramp": {k: _np(getattr(sol.ramp, k)) for k in RAMP_FIELDS}}


def qpsub_solution_to_numpy(sol) -> dict:
    """The state of a ``SolutionQpsub`` of either package as nested numpy
    dicts."""
    out = {"base": solution_to_numpy(sol.base),
           "sqp_line": _np(sol.sqp_line),
           "v_prev": {"gen": _np(sol.v_prev.gen), "line": _np(sol.v_prev.line)}}
    out.update({k: _np(getattr(sol, k)) for k in QPSUB_ALM_FIELDS})
    return out


def mpec_solution_from_numpy(d: dict, *, dtype=torch.float64,
                             device="cpu") -> SolutionMpec:
    """A port ``SolutionMpec`` from the nested dicts of
    ``mpec_solution_to_numpy``."""
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    blocks = {k: MpecBlocks(**{f: t(d[k][f]) for f in MPEC_FIELDS})
              for k in SOLUTION_BLOCKS}
    alm = d["branch_alm"]
    return SolutionMpec(**blocks, branch_alm=BranchALMState(
        lam1=t(alm["lam1"]), lam2=t(alm["lam2"]), mu=t(alm["mu"])))


def mpec_solution_to_numpy(sol) -> dict:
    """The state of a ``SolutionMpec`` of either package as nested numpy
    dicts."""
    out = {k: {f: _np(getattr(getattr(sol, k), f)) for f in MPEC_FIELDS}
           for k in SOLUTION_BLOCKS}
    alm = sol.branch_alm
    out["branch_alm"] = {k: _np(getattr(alm, k)) for k in ("lam1", "lam2", "mu")}
    return out
