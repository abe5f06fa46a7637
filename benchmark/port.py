"""The system under test: how one request calls the port
(``exaadmm_tpu_torch``), the only module of the benchmark that imports it.

A configuration's ``model`` and a traffic mix's ``mode`` choose the entry
point a request drives:

- ``acopf`` / ``cold``: ``solve_acopf(data=...)`` from a flat start;
- ``acopf`` / ``track``: the rolling horizon's own steps
  (``interface/solve_acopf_rolling.py``): set-up builds the model and its
  fused driver (``two_level_driver``) and solves period 0; each request
  uploads its period's loads, solves warm from the last period's solution,
  then tightens the pg bounds (``update_real_power_current_bounds``).

Every request ends when its dispatch (``u.gen``) is on the host. The
answer keeps, on the device, what the check reads afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.algorithms.admm_two_level import two_level_driver
from exaadmm_tpu_torch.interface.solve_acopf_rolling import \
    update_real_power_current_bounds
from exaadmm_tpu_torch.models.acopf import model as M
from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                 Parameters)
from exaadmm_tpu_torch.utils.opfdata import OPFData

from . import traffic as traffic_mod

DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass
class Answer:
    """One request's result: the final status and objective, the dispatch
    on the host, the load factor it was asked for, and the device tensors
    the check reads: ``state`` maps u_gen, u_line, v_gen, v_line (the
    components' values and the bus consensus) and l_gen (the generators'
    multipliers) to them."""

    status: str
    objval: float
    dispatch: np.ndarray
    state: dict
    factor: float
    pg_prev: np.ndarray | None = None


def _state(sol) -> dict:
    return {"u_gen": sol.u.gen, "u_line": sol.u.line,
            "v_gen": sol.v.gen, "v_line": sol.v.line, "l_gen": sol.l.gen}


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

    def setup(self, factor) -> Answer:
        return self(factor)

    def close(self) -> None:
        pass


class ColdAcopf(_Request):
    def __call__(self, factor) -> Answer:
        Pd, Qd = traffic_mod.loads(self.grid, factor)
        data = dataclasses.replace(self.data, Pd=Pd, Qd=Qd)
        res = E.solve_acopf(data.case, data=data, **self.solver)
        sol = res.solution
        return Answer(res.info.status, res.info.objval,
                      sol.u.gen.cpu().numpy(), _state(sol), factor)


class TrackAcopf(_Request):
    def setup(self, factor) -> Answer:
        s = dict(self.solver)
        par = Parameters(outer_iterlim=s["outer_iterlim"],
                         inner_iterlim=s["inner_iterlim"],
                         outer_eps=s["outer_eps"], verbose=0)
        self.model = M.build_model(self.data, par,
                                   use_linelimit=s["use_linelimit"],
                                   tight_factor=s["tight_factor"],
                                   dtype=self.dtype, device=self.device)
        gd = self.model.grid
        self.ramp_rate = self.config["ramp_ratio"] * gd.pgmax
        self.sol = M.init_solution(self.model, s["rho_pq"], s["rho_va"])
        self.solve = two_level_driver(self.model)
        self.last = None
        return self(factor)

    def __call__(self, factor) -> Answer:
        Pd, Qd = traffic_mod.loads(self.grid, factor)
        dev, dt = self.device, self.dtype
        sol, info = self.solve(
            self.model, self.sol, IterationInformation(),
            Pd=torch.as_tensor(Pd).to(device=dev, dtype=dt),
            Qd=torch.as_tensor(Qd).to(device=dev, dtype=dt))
        gd = self.model.grid
        self.model.pgmin_curr, self.model.pgmax_curr = \
            update_real_power_current_bounds(gd.pgmin, gd.pgmax,
                                             self.ramp_rate, sol.u.gen[:, 0])
        self.sol = sol
        dispatch = sol.u.gen.cpu().numpy()
        pg_prev, self.last = self.last, dispatch[:, 0]
        return Answer(info.status, info.objval, dispatch, _state(sol),
                      factor, pg_prev=pg_prev)

    def close(self) -> None:
        self.model = self.sol = self.solve = None


REQUESTS = {("acopf", "cold"): ColdAcopf, ("acopf", "track"): TrackAcopf}


def make(config: dict, traffic: dict, grid: dict, device, dtype=None):
    """The request of ``config`` under ``traffic``, solving in ``dtype`` (by
    default the configuration's)."""
    key = (config["model"], traffic["mode"])
    if key not in REQUESTS:
        raise ValueError(f"no request for model {key[0]!r} under traffic "
                         f"mode {key[1]!r}")
    dtype = dtype or DTYPES[config["solver"]["dtype"]]
    return REQUESTS[key](config, grid, device, dtype)
