"""State carried between the JAX package and the port, as numpy arrays.

Both packages describe the same grid and the same ADMM state with the same
field names. These helpers take and give plain dicts of numpy arrays keyed
by those names, so a caller holding a JAX ``GridData`` or ``Solution`` (one
``np.asarray`` per leaf) can hand it to the port and compare what comes back.

- grid: ``{"nbus": int, ..., "baseMVA": float or 0-d array, "YffR": (N,), ...}``
- solution: ``{"u": {"gen": (ngen, 2), "line": (N, 8)}, ...,
  "branch_alm": {"lam1": (N,), "lam2": (N,), "mu": (N,)}}``
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .environment import SOLUTION_BLOCKS, Blocks, BranchALMState, Solution
from .grid_data import GridData, build_csr

_SIZES = ("nbus", "ngen", "nline", "nline_padded")
_INDEX_FIELDS = ("gen_bus", "line_from", "line_to")
_DERIVED = ("arc_ptr", "arc_idx", "arc_bus", "gen_ptr", "gen_idx")


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
