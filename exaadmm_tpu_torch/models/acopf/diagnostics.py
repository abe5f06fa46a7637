"""Solution-quality diagnostics.

Counterpart of ``exaadmm_tpu/models/acopf/diagnostics.py``: the
per-constraint errors the reference carries in ``ComponentInformation``
(environment.jl:277-326: err_pg/err_qg/err_vm/err_real/err_reactive/
err_rateA, the rateA violation count), computed in one pass from a state.
Its bus sums go through the bus-scatter kernel (``ops/bus_cuda.py``): the
line terms over the arc CSR, the generator terms over the generator CSR.
"""

from __future__ import annotations

import torch

from ...ops import bus_cuda
from ...utils.grid_data import GridData


def compute_violations(gd: GridData, u, v, Pd=None, Qd=None) -> dict:
    """The largest violations of the original ACOPF constraints at u/v:

    - err_pg/err_qg: generator bound violations of u
    - err_vm: voltage-magnitude bound violation of the line-owned w copies
    - err_real/err_reactive: bus power-balance residuals from the u flows
      and the consensus voltage copies
    - err_rateA: squared-flow line-limit violation (p^2 + q^2 - rateA)_+
    - num_rateA_viols: the number of lines violating their limit
    - err_consensus: max |u - v|
    """
    if Pd is None:
        Pd = gd.Pd
    if Qd is None:
        Qd = gd.Qd
    m = gd.line_mask
    uL = u.line
    zero = torch.zeros((), dtype=uL.dtype, device=uL.device)

    pg, qg = u.gen[:, 0], u.gen[:, 1]
    err_pg = torch.amax(torch.maximum(
        torch.maximum(gd.pgmin - pg, pg - gd.pgmax), zero))
    err_qg = torch.amax(torch.maximum(
        torch.maximum(gd.qgmin - qg, qg - gd.qgmax), zero))

    wi, wj = uL[:, 4], uL[:, 5]
    vm_lo_i = gd.fr_vm_bound[:, 0] * gd.fr_vm_bound[:, 0]
    vm_hi_i = gd.fr_vm_bound[:, 1] * gd.fr_vm_bound[:, 1]
    vm_lo_j = gd.to_vm_bound[:, 0] * gd.to_vm_bound[:, 0]
    vm_hi_j = gd.to_vm_bound[:, 1] * gd.to_vm_bound[:, 1]
    err_vm = torch.amax(torch.maximum(torch.maximum(
        torch.maximum(vm_lo_i - wi, wi - vm_hi_i),
        torch.maximum(vm_lo_j - wj, wj - vm_hi_j)), zero) * m)

    # bus power balance from the u flows and the generator injections, the
    # consensus w for the shunts: per arc (p, q, w, 1), per generator (p, q)
    arcs = torch.cat([
        torch.stack([uL[:, 0], uL[:, 1], v.line[:, 4], torch.ones_like(m)],
                    dim=-1),
        torch.stack([uL[:, 2], uL[:, 3], v.line[:, 5], torch.ones_like(m)],
                    dim=-1),
    ]) * torch.cat([m, m])[:, None]
    flow, fq, w_sum, cnt = bus_cuda.bus_scatter(
        arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx).unbind(-1)
    gp, gq = bus_cuda.bus_scatter(u.gen.contiguous(), gd.gen_bus, gd.gen_ptr,
                                  gd.gen_idx).unbind(-1)
    p_inj = gp - flow - Pd / gd.baseMVA
    q_inj = gq - fq - Qd / gd.baseMVA
    w_bus = w_sum / torch.clamp_min(cnt, 1.0)
    err_real = torch.amax(torch.abs(p_inj - gd.YshR * w_bus))
    err_reactive = torch.amax(torch.abs(q_inj + gd.YshI * w_bus))

    sq_ij = uL[:, 0] * uL[:, 0] + uL[:, 1] * uL[:, 1]
    sq_ji = uL[:, 2] * uL[:, 2] + uL[:, 3] * uL[:, 3]
    rate_viol = torch.maximum(torch.maximum(sq_ij, sq_ji) - gd.rate_a,
                              zero) * m
    err_rateA = torch.amax(rate_viol)
    num_rateA = torch.sum(rate_viol > 1e-8).to(uL.dtype)

    err_consensus = torch.maximum(
        torch.amax(torch.abs(u.gen - v.gen)),
        torch.amax(torch.abs(uL - v.line) * m[:, None]))

    # one read-back for all of them
    vals = torch.stack([err_pg, err_qg, err_vm, err_real, err_reactive,
                        err_rateA, num_rateA, err_consensus]).tolist()
    out = dict(zip(("err_pg", "err_qg", "err_vm", "err_real", "err_reactive",
                    "err_rateA", "num_rateA_viols", "err_consensus"), vals))
    out["num_rateA_viols"] = int(out["num_rateA_viols"])
    return out
