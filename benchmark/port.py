"""The system under test: how one request calls the port
(``exaadmm_tpu_torch``). This module and the request kinds under
``requests/`` are the only ones of the benchmark that import it.

A configuration's ``model`` names the file of its request kinds,
``requests/<model>.py``, and a traffic mix's ``mode`` the kind in that
file's ``REQUESTS``: a new model brings a new file and no edit here. Each
file also names ``MODEL``, the port's model module whose ``build_model`` a
traced run records as ``entry.build_model``, and ``FAULTS``, the planted
faults of ``control.py`` that its requests can have.

Every request ends when its dispatch is on the host. The answer keeps, on
the device, what the check reads afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exaadmm_tpu_torch.utils.opfdata import OPFData

from . import HERE, load

DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass
class Answer:
    """One request's result: the final status and objective (over all its
    periods), the dispatch on the host, the load factors it was asked for
    (one a period), and one dict of device tensors a period that the check
    reads: ``states[t]`` maps u_gen, u_line, v_gen, v_line (the
    components' values and the bus consensus of period t, a single
    period's layout) and l_gen (the generators' multipliers) to them."""

    status: str
    objval: float
    dispatch: np.ndarray
    states: list
    factors: tuple
    pg_prev: np.ndarray | None = None


class _Request:
    def __init__(self, config: dict, grid: dict, device, dtype):
        self.config = config
        self.grid = grid
        self.data = OPFData(**grid)
        self.device = torch.device(device)
        self.dtype = dtype
        s = config["solver"]
        self.solver = dict(
            rho_pq=s["rho_pq"], rho_va=s["rho_va"],
            outer_iterlim=s["outer_iterlim"],
            inner_iterlim=s["inner_iterlim"], outer_eps=s["outer_eps"],
            tight_factor=s["tight_factor"], use_linelimit=s["use_linelimit"],
            verbose=0, dtype=dtype, device=self.device)

    def setup(self, factors) -> Answer:
        return self(factors)

    def close(self) -> None:
        pass


def kinds(model: str):
    """The module ``requests/<model>.py``, or None when there is none."""
    if not (HERE / "requests" / f"{model}.py").is_file():
        return None
    return load("requests", model)


def make(config: dict, traffic: dict, grid: dict, device, dtype=None):
    """The request of ``config`` under ``traffic``, solving in ``dtype`` (by
    default the configuration's)."""
    model, mode = config["model"], traffic["mode"]
    mod = kinds(model)
    cls = mod.REQUESTS.get(mode) if mod else None
    if cls is None:
        raise ValueError(f"no request for model {model!r} under traffic "
                         f"mode {mode!r}")
    dtype = dtype or DTYPES[config["solver"]["dtype"]]
    return cls(config, grid, device, dtype)


def traced_calls(model: str) -> list:
    """The port's calls that a traced run of ``model`` records, as (owner,
    attribute, span): the model's build, each fused two-level solve, the
    solver's build and the carry's read-back at a solve's end."""
    from exaadmm_tpu_torch.algorithms import admm_two_level, carry
    return [(kinds(model).MODEL, "build_model", "entry.build_model"),
            (admm_two_level.FusedSolver, "__call__", "loop.solve"),
            (admm_two_level.FusedSolver, "_build", "loop.build"),
            (carry.Carry, "read_back", "loop.read_back")]
