"""Sparse Newton-Raphson power flow (host-side, numpy/scipy).

A copy of ``exaadmm_tpu/models/pf/newton.py`` (numpy and scipy only; the
port does not import the JAX package). Functional equivalent of the
reference's CPU power-flow solver (``src/models/pf/pf_struct.jl``,
``pf_eval_f_cpu.jl``, ``pf_eval_jac_cpu.jl``, ``src/interface/
solve_pf.jl``): the same unknown partition (Va at PV+PQ buses, Vm at PQ
buses; generator P/Q held fixed) and the same warm/flat starts, formulated
on the complex bus-injection equations S(V) = V * conj(Ybus V) with the
standard analytic dS/dV Jacobians and one scipy sparse solve per iteration.
The reference runs it on the host too; it is not a device path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ...utils.opfdata import OPFData, opf_loaddata


def build_ybus(data: OPFData) -> sp.csr_matrix:
    nb, nl = data.nbus, data.nline
    f, t = data.line_from, data.line_to
    Yff = data.YffR + 1j * data.YffI
    Yft = data.YftR + 1j * data.YftI
    Ytf = data.YtfR + 1j * data.YtfI
    Ytt = data.YttR + 1j * data.YttI
    Ysh = data.YshR + 1j * data.YshI
    Cf = sp.coo_matrix((np.ones(nl), (np.arange(nl), f)), shape=(nl, nb))
    Ct = sp.coo_matrix((np.ones(nl), (np.arange(nl), t)), shape=(nl, nb))
    Yf = sp.diags(Yff) @ Cf + sp.diags(Yft) @ Ct
    Yt = sp.diags(Ytf) @ Cf + sp.diags(Ytt) @ Ct
    return (Cf.T @ Yf + Ct.T @ Yt + sp.diags(Ysh)).tocsr()


def _dSbus_dV(Ybus, V):
    ib = Ybus @ V
    diagV = sp.diags(V)
    diagIbus = sp.diags(ib)
    diagVnorm = sp.diags(V / np.abs(V))
    dS_dVm = diagV @ np.conj(Ybus @ diagVnorm) + np.conj(diagIbus) @ diagVnorm
    dS_dVa = 1j * diagV @ np.conj(diagIbus - Ybus @ diagV)
    return dS_dVm, dS_dVa


@dataclasses.dataclass
class PowerFlowResult:
    vm: np.ndarray
    va: np.ndarray
    pg: np.ndarray
    qg: np.ndarray
    residual: float
    iterations: int
    converged: bool


def solve_pf_core(
    data: OPFData,
    vm0, va0, pg0, qg0,
    *,
    Pd=None,
    Qd=None,
    tol: float = 1e-6,
    max_iter: int = 50,
    verbose: int = 0,
) -> PowerFlowResult:
    """NR on the mismatch S_inj(V) - S_gen + S_load = 0 with the standard
    PV/PQ/slack partition; pg/qg enter as fixed injections (reference keeps
    them out of the solved columns, solve_pf.jl rslice/cslice).

    ``Pd``/``Qd`` override the base-case loads — required for multi-period
    projection, where each period must be projected onto its own power flow
    (mpacopf ``admm_poststep`` uses that period's load columns)."""
    nb = data.nbus
    Ybus = build_ybus(data)
    bt = data.bus_type
    pq = np.nonzero(bt == 1)[0]
    pv = np.nonzero(bt == 2)[0]
    pvpq = np.concatenate([pv, pq])
    pvpq.sort()

    Cg = sp.coo_matrix(
        (np.ones(data.ngen), (data.gen_bus, np.arange(data.ngen))),
        shape=(nb, data.ngen),
    ).tocsr()
    if Pd is None:
        Pd = data.Pd
    if Qd is None:
        Qd = data.Qd
    Sload = (Pd + 1j * Qd) / data.baseMVA

    vm = vm0.copy()
    va = va0.copy()
    Sgen = Cg @ (pg0 + 1j * qg0)

    def mismatch(vm, va):
        V = vm * np.exp(1j * va)
        S = V * np.conj(Ybus @ V)
        mis = S - Sgen + Sload
        return V, np.concatenate([mis.real[pvpq], mis.imag[pq]])

    V, F = mismatch(vm, va)
    residual = np.max(np.abs(F)) if F.size else 0.0
    if verbose > 0:
        print(f"  NR power flow: {len(pq)} PQ, {len(pv)} PV buses")
        print(f"  {0:6d}  {residual:.6e}")

    it = 0
    while it < max_iter and residual > tol:
        it += 1
        dS_dVm, dS_dVa = _dSbus_dV(Ybus, V)
        J11 = dS_dVa[np.ix_(pvpq, pvpq)].real
        J12 = dS_dVm[np.ix_(pvpq, pq)].real
        J21 = dS_dVa[np.ix_(pq, pvpq)].imag
        J22 = dS_dVm[np.ix_(pq, pq)].imag
        J = sp.bmat([[J11, J12], [J21, J22]], format="csc")
        dx = spla.spsolve(J, -F)
        va[pvpq] += dx[: len(pvpq)]
        vm[pq] += dx[len(pvpq):]
        V, F = mismatch(vm, va)
        residual = np.max(np.abs(F)) if F.size else 0.0
        if verbose > 0:
            print(f"  {it:6d}  {residual:.6e}")

    return PowerFlowResult(
        vm=vm, va=va, pg=pg0.copy(), qg=qg0.copy(),
        residual=float(residual), iterations=it, converged=residual <= tol,
    )


def solve_pf(
    case_or_data,
    *,
    case_format: str = "matpower",
    start_method: str = "warm",
    tol: float = 1e-6,
    max_iter: int = 50,
    verbose: int = 1,
) -> PowerFlowResult:
    """Standalone power-flow entry (reference ``solve_pf``, solve_pf.jl:1-5)."""
    if isinstance(case_or_data, OPFData):
        data = case_or_data
    else:
        data = opf_loaddata(case_or_data, case_format=case_format,
                            verbose=verbose)
    if start_method == "warm":
        vm0 = np.clip(data.Vm, data.Vmin, data.Vmax)
        va0 = data.Va.copy()
        # warm start uses the case's gen setpoints (init_start_x_warm)
        pg0 = np.clip(data.Pg0, data.pgmin, data.pgmax)
        qg0 = np.clip(data.Qg0, data.qgmin, data.qgmax)
    elif start_method == "flat":
        vm0 = 0.5 * (data.Vmin + data.Vmax)
        va0 = np.zeros(data.nbus)
        pg0 = 0.5 * (data.pgmin + data.pgmax)
        qg0 = 0.5 * (data.qgmin + data.qgmax)
    else:
        raise ValueError(f"unknown start_method {start_method!r}")

    res = solve_pf_core(data, vm0, va0, pg0, qg0, tol=tol, max_iter=max_iter,
                        verbose=verbose)
    if verbose > 0:
        print(f" ** NR results: residual={res.residual:.2e} "
              f"iters={res.iterations} converged={res.converged}")
    return res
