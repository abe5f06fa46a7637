"""Request kinds of a multi-period ACOPF configuration (``model:
"mpacopf"``), a horizon of T periods a request:

- ``cold``: ``solve_mpacopf(data=..., loads=(Pd, Qd), start_period=1,
  end_period=T)`` with the configuration's solver settings and
  ``ramp_ratio`` and the entry point's default warm start (each period
  solved alone by one reused fused solver, then the coupled horizon).

A request ends when the dispatch of all T periods is on the host.
"""

from __future__ import annotations

import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.models.mpacopf import model as M
from exaadmm_tpu_torch.ops import tron_cuda
from exaadmm_tpu_torch.ops.tron import TronALMResult

from benchmark import traffic as traffic_mod
from benchmark.port import Answer, _Request

MODEL = M


class ColdMpacopf(_Request):
    def __call__(self, factors) -> Answer:
        T = len(factors)
        res = E.solve_mpacopf(
            self.data.case, data=self.data,
            loads=traffic_mod.loads(self.grid, factors), start_period=1,
            end_period=T, ramp_ratio=self.config["ramp_ratio"], **self.solver)
        ac = res.solution.acopf
        states = [{"u_gen": ac.u.gen[t], "u_line": ac.u.line[t],
                   "v_gen": ac.v.gen[t], "v_line": ac.v.line[t],
                   "l_gen": ac.l.gen[t]} for t in range(T)]
        return Answer(res.info.status, res.info.objval,
                      ac.u.gen.cpu().numpy(), states, factors)


REQUESTS = {"cold": ColdMpacopf}


def ramp_left_out():
    """A fault in the ramp batch: it returns its start unchanged, without
    solving, so pg of periods 2..T, the ramp copies and the slacks stay as
    the pack read them."""
    real = tron_cuda.tron_alm_packed

    def tron_alm_packed(inst, x0, xl, xu, P, lam0, mu0, **kwargs):
        if inst != tron_cuda.RAMP:
            return real(inst, x0, xl, xu, P, lam0, mu0, **kwargs)
        steps = torch.zeros(x0.shape[1], dtype=torch.int32, device=x0.device)
        return TronALMResult(x0, lam0, mu0, steps, steps,
                             torch.zeros_like(mu0))
    return tron_cuda, "tron_alm_packed", tron_alm_packed


FAULTS = {"ramp_batch_left_out": ramp_left_out}
