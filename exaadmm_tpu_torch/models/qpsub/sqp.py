"""SQP-side construction of the qpsub QP inputs from a base point (numpy).

Counterpart of ``exaadmm_tpu/models/qpsub/sqp.py``, line for line. The
reference treats these inputs as caller-supplied (its SQP outer loop lives
out of tree); its test derives them inline from a hard-coded base point
(qpsub_update_cpu.jl:33-140). This module packages that derivation,
vectorized over lines, so a qpsub solve can be driven from any base point.

Rows of ``line_var``: (w_ijR, w_ijI, w_i, w_j, theta_i, theta_j); rows of
``line_fl``: (p_ij, q_ij, p_ji, q_ji), the reference's sqp_line/ls/us
ordering (qpsub_model.jl:8-31).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...utils.opfdata import OPFData


@dataclasses.dataclass
class SqpBasePoint:
    pg: np.ndarray        # (ngen,) p.u.
    qg: np.ndarray
    vm: np.ndarray        # (nbus,)
    va: np.ndarray        # (nbus,) rad

    @classmethod
    def from_power_flow(cls, data: OPFData, *, verbose: int = 0):
        """The NR power-flow warm start, the natural SQP linearization
        point (host-side numpy/scipy)."""
        from ..pf.newton import solve_pf
        res = solve_pf(data, start_method="warm", verbose=verbose)
        return cls(pg=res.pg, qg=res.qg, vm=res.vm, va=res.va)


def _host(a) -> np.ndarray:
    """A GridData field as a float64 numpy array, wherever it lies."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a, np.float64)


def build_qp_inputs(data: OPFData, gd, base: SqpBasePoint,
                    *, pi_14: np.ndarray | None = None) -> dict:
    """QP inputs for :func:`exaadmm_tpu_torch.solve_qpsub`.

    ``gd`` is the case's ``GridData`` (its per-line bounds and limits are
    read). ``pi_14``: (4, nline) multipliers of the 14h/14i/14j/14k
    constraints at the base point (they weight the constraint Hessians in
    Hs); the reference test uses -1 everywhere, kept as the default.
    """
    nl, nb = data.nline, data.nbus
    g = lambda a: np.asarray(a, np.float64)  # noqa: E731
    f, t = np.asarray(data.line_from), np.asarray(data.line_to)
    vm, va = g(base.vm), g(base.va)
    if pi_14 is None:
        pi_14 = -np.ones((4, nl))

    # base-point line variables and flows
    vi, vj = vm[f], vm[t]
    thi, thj = va[f], va[t]
    dth = thi - thj
    lv = np.stack([vi * vj * np.cos(dth), vi * vj * np.sin(dth),
                   vi**2, vj**2, thi, thj])           # (6, nl)
    YftR, YftI = g(data.YftR), g(data.YftI)
    YffR, YffI = g(data.YffR), g(data.YffI)
    YtfR, YtfI = g(data.YtfR), g(data.YtfI)
    YttR, YttI = g(data.YttR), g(data.YttI)
    lf = np.stack([
        YffR * lv[2] + YftR * lv[0] + YftI * lv[1],
        -YffI * lv[2] - YftI * lv[0] + YftR * lv[1],
        YttR * lv[3] + YtfR * lv[0] - YtfI * lv[1],
        -YttI * lv[3] - YtfI * lv[0] - YtfR * lv[1],
    ])                                                 # (4, nl)

    # delta bounds around the base point (qpsub_update_cpu.jl:60-76)
    fr_vm = _host(gd.fr_vm_bound)[:nl]
    to_vm = _host(gd.to_vm_bound)[:nl]
    fr_va = _host(gd.fr_va_bound)[:nl]
    to_va = _host(gd.to_va_bound)[:nl]
    ls = np.zeros((nl, 6)); us = np.zeros((nl, 6))
    ls[:, 0] = ls[:, 1] = -2 * fr_vm[:, 1] * to_vm[:, 1]
    us[:, 0] = us[:, 1] = 2 * fr_vm[:, 1] * to_vm[:, 1]
    ls[:, 2] = fr_vm[:, 0]**2 - lv[2]; us[:, 2] = fr_vm[:, 1]**2 - lv[2]
    ls[:, 3] = to_vm[:, 0]**2 - lv[3]; us[:, 3] = to_vm[:, 1]**2 - lv[3]
    ls[:, 4] = fr_va[:, 0] - lv[4]; us[:, 4] = fr_va[:, 1] - lv[4]
    ls[:, 5] = to_va[:, 0] - lv[5]; us[:, 5] = to_va[:, 1] - lv[5]

    # residual loads at the base point
    pgb = np.bincount(np.asarray(data.gen_bus), weights=g(base.pg),
                      minlength=nb)
    qgb = np.bincount(np.asarray(data.gen_bus), weights=g(base.qg),
                      minlength=nb)
    pft = np.bincount(f, weights=lf[0], minlength=nb)
    ptf = np.bincount(t, weights=lf[2], minlength=nb)
    qft = np.bincount(f, weights=lf[1], minlength=nb)
    qtf = np.bincount(t, weights=lf[3], minlength=nb)
    bus_w = vm**2
    Pd = data.baseMVA * (g(data.Pd) / data.baseMVA
                         - (pgb - pft - ptf - g(data.YshR) * bus_w))
    Qd = data.baseMVA * (g(data.Qd) / data.baseMVA
                         - (qgb - qft - qtf + g(data.YshI) * bus_w))

    # Hs: constraint-Hessian-weighted base QP (qpsub_update_cpu.jl:85-130)
    Hs = np.zeros((nl, 6, 6))
    Hs[:, 0, 0] = Hs[:, 1, 1] = 2 * pi_14[0]
    Hs[:, 2, 3] = Hs[:, 3, 2] = -pi_14[0]
    c1_ = pi_14[1] * np.cos(dth)
    c2_ = pi_14[1] * np.sin(dth)
    # NOTE the reference evaluates cons_3 with a fixed second index
    # line_var[1,2] (1-based); kept verbatim for parity with its QP
    c3_ = pi_14[1] * (-lv[0] * np.sin(dth) + lv[0, min(1, nl - 1)] * np.cos(dth))
    Hs[:, 0, 4] = Hs[:, 4, 0] = c1_
    Hs[:, 0, 5] = Hs[:, 5, 0] = -c1_
    Hs[:, 1, 4] = Hs[:, 4, 1] = c2_
    Hs[:, 1, 5] = Hs[:, 5, 1] = -c2_
    Hs[:, 4, 4] = Hs[:, 5, 5] = c3_
    Hs[:, 4, 5] = Hs[:, 5, 4] = -c3_
    z = np.zeros(nl)
    supY = np.stack([
        np.stack([YftR, YftI, YffR, z, z, z], -1),
        np.stack([-YftI, YftR, -YffI, z, z, z], -1),
        np.stack([YtfR, -YtfI, z, YttR, z, z], -1),
        np.stack([-YtfI, -YtfR, z, -YttI, z, z], -1),
    ], axis=1)                                         # (nl, 4, 6)
    Hs += -2 * pi_14[2, :, None, None] * (
        np.einsum("li,lj->lij", supY[:, 0], supY[:, 0])
        + np.einsum("li,lj->lij", supY[:, 1], supY[:, 1]))
    Hs += -2 * pi_14[3, :, None, None] * (
        np.einsum("li,lj->lij", supY[:, 2], supY[:, 2])
        + np.einsum("li,lj->lij", supY[:, 3], supY[:, 3]))
    Hs += 4.0 * np.eye(6)[None]

    # linearized constraint rows (qpsub_update_cpu.jl:78-84,131-140)
    LH_1h = np.stack([2 * lv[0], 2 * lv[1], -lv[3], -lv[2]], -1)
    RH_1h = -lv[0]**2 - lv[1]**2 + lv[2] * lv[3]
    LH_1i = np.stack([np.sin(dth), -np.cos(dth),
                      lv[0] * np.cos(dth) + lv[1] * np.sin(dth),
                      -lv[0] * np.cos(dth) - lv[1] * np.sin(dth)], -1)
    RH_1i = -lv[0] * np.sin(dth) + lv[1] * np.cos(dth)
    rateA = _host(gd.rate_a)[:nl]
    LH_1j = np.stack([2 * lf[0], 2 * lf[1]], -1)
    RH_1j = -(lf[0]**2 + lf[1]**2 - rateA)
    LH_1k = np.stack([2 * lf[2], 2 * lf[3]], -1)
    RH_1k = -(lf[2]**2 + lf[3]**2 - rateA)

    return dict(
        Hs=Hs, LH_1h=LH_1h, RH_1h=RH_1h, LH_1i=LH_1i, RH_1i=RH_1i,
        LH_1j=LH_1j, RH_1j=RH_1j, LH_1k=LH_1k, RH_1k=RH_1k, ls=ls, us=us,
        pgmax=g(data.pgmax) - g(base.pg), pgmin=g(data.pgmin) - g(base.pg),
        qgmax=g(data.qgmax) - g(base.qg), qgmin=g(data.qgmin) - g(base.qg),
        c1=g(data.c1) + 2 * g(data.c2) * g(base.pg), c2=g(data.c2).copy(),
        Pd=Pd, Qd=Qd,
    )
