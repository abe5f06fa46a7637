"""Request kinds of a single-period ACOPF configuration (``model:
"acopf"``), one period a request:

- ``cold``: ``solve_acopf(data=...)`` from a flat start;
- ``track``: the rolling horizon's own steps
  (``interface/solve_acopf_rolling.py``): set-up builds the model and its
  fused driver (``two_level_driver``) and solves period 0; each request
  uploads its period's loads, solves warm from the last period's solution,
  then tightens the pg bounds (``update_real_power_current_bounds``).

Every request ends when its dispatch (``u.gen``) is on the host.
"""

from __future__ import annotations

import dataclasses

import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.algorithms.admm_two_level import two_level_driver
from exaadmm_tpu_torch.interface.solve_acopf_rolling import \
    update_real_power_current_bounds
from exaadmm_tpu_torch.models.acopf import model as M
from exaadmm_tpu_torch.ops import acopf_cuda
from exaadmm_tpu_torch.utils.environment import (IterationInformation,
                                                 Parameters)

from benchmark import traffic as traffic_mod
from benchmark.port import Answer, _Request

MODEL = M


def _state(sol) -> dict:
    return {"u_gen": sol.u.gen, "u_line": sol.u.line,
            "v_gen": sol.v.gen, "v_line": sol.v.line, "l_gen": sol.l.gen}


class ColdAcopf(_Request):
    def __call__(self, factors) -> Answer:
        (factor,) = factors
        Pd, Qd = traffic_mod.loads(self.grid, factor)
        data = dataclasses.replace(self.data, Pd=Pd, Qd=Qd)
        res = E.solve_acopf(data.case, data=data, **self.solver)
        sol = res.solution
        return Answer(res.info.status, res.info.objval,
                      sol.u.gen.cpu().numpy(), [_state(sol)], factors)


class TrackAcopf(_Request):
    def setup(self, factors) -> Answer:
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
        return self(factors)

    def __call__(self, factors) -> Answer:
        (factor,) = factors
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
        return Answer(info.status, info.objval, dispatch, [_state(sol)],
                      factors, pg_prev=pg_prev)

    def close(self) -> None:
        self.model = self.sol = self.solve = None


REQUESTS = {"cold": ColdAcopf, "track": TrackAcopf}


def c1_scaled(factor: float):
    """A fault in the generator step: its linear cost coefficient times
    ``factor`` (0: left out), while the objective keeps the true one."""
    real = acopf_cuda.generator_update

    def generator_update(*args, **kwargs):
        args = list(args)
        args[10] = args[10] * factor   # c1
        return real(*args, **kwargs)
    return acopf_cuda, "generator_update", generator_update


FAULTS = {"c1_dropped": lambda: c1_scaled(0.0),
          "c1_halved": lambda: c1_scaled(0.5),
          "c1_plus_10pct": lambda: c1_scaled(1.1)}
