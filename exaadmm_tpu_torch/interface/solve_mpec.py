"""ACOPF with complementarity constraints (MPEC): voltage and frequency
primary control plus storage.

Counterpart of ``exaadmm_tpu/interface/solve_mpec.py`` (reference
solve_acopf_mpec, solve_mpec.jl, disabled upstream): the same arguments and
defaults, plus ``device`` (as in ``solve_acopf``: ``"cuda"`` by default,
raising ``RuntimeError`` without a CUDA device; ``"cpu"`` runs the plain
versions) and ``data`` (an already loaded or generated case). ``mesh``
splits the lines across the ranks of a multi-process run and
``pad_lines_to`` pads the line batch (it defaults to the mesh size), as in
``solve_acopf``, whose driver rule it follows (``two_level_driver``): the
fused driver at ``verbose=0``, over a mesh too, except a gloo mesh on CUDA
tensors, which runs the host loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..algorithms.admm_two_level import two_level_driver
from ..models.mpec import model as MM
from ..parallel.sharding import default_pad, run_sharded
from ..utils import tracing
from ..utils.environment import AdmmEnv, IterationInformation, Parameters
from ..utils.grid_data import build_csr, build_grid_data
from ..utils.opfdata import OPFData, opf_loaddata


@dataclasses.dataclass
class MpecResult:
    data: OPFData
    model: "MM.ModelMpec"
    solution: "MM.SolutionMpec"
    info: IterationInformation
    freq_change: float
    vm_dev: float
    env: AdmmEnv | None = None


def make_storage(data: OPFData, storage_ratio: float,
                 storage_charge_max: float, dtype=torch.float64,
                 device="cpu", seed: int = 0) -> MM.StorageData:
    """Random storage placement (reference opf_loaddata_matpower:224-241,
    Random.randperm there): ceil(nbus * storage_ratio) units at the first
    buses of ``np.random.default_rng(seed).permutation``, the JAX package's
    buses."""
    nsto = int(np.ceil(data.nbus * storage_ratio)) if storage_ratio > 0 else 0
    buses = np.random.default_rng(seed).permutation(data.nbus)[:nsto]
    ptr, idx = build_csr(buses, data.nbus)

    def f(x):
        return torch.full((nsto,), x, dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return MM.StorageData(
        bus=torch.as_tensor(buses.astype(np.int64), device=device),
        chg_min=f(0.0),
        chg_max=f(storage_charge_max),
        energy_min=f(0.0),
        energy_max=f(1.2 * storage_charge_max),
        energy_setpoint=f(0.5 * 1.2 * storage_charge_max),
        eta_chg=f(0.9),
        eta_dis=f(1.1),
        ptr=i32(ptr), idx=i32(idx),
    )


@tracing.spanned("entry.build_model")
def build_model(data: OPFData, par: Parameters, *, storage_ratio: float = 0.0,
                storage_charge_max: float = 1.0, droop: float = 0.04,
                use_linelimit: bool = True, tight_factor: float = 0.99,
                pad_lines_to: int = 1, dtype=torch.float64,
                device="cpu") -> MM.ModelMpec:
    """The MPEC model of ``data``: the grid, the storage of
    ``make_storage`` and the primary-control data (opfdata.jl:860-901)."""
    gd = build_grid_data(data, tight_factor=tight_factor,
                         pad_lines_to=pad_lines_to, dtype=dtype,
                         device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=device,
                                                               dtype=dtype)

    vgmin = t(data.Vmin[data.gen_bus])
    vgmax = t(data.Vmax[data.gen_bus])
    return MM.ModelMpec(
        grid=gd, par=par,
        storage=make_storage(data, storage_ratio, storage_charge_max, dtype,
                             device),
        alpha=t(-(1.0 / droop) * data.pgmax),
        pg_setpoint=t(0.5 * (data.pgmin + data.pgmax)),
        vgmin=vgmin, vgmax=vgmax, vm_setpoint=0.5 * (vgmin + vgmax),
        use_linelimit=use_linelimit)


@tracing.spanned("entry.solve", entry="solve_acopf_mpec")
def solve_acopf_mpec(
    case: str,
    *,
    case_format: str = "matpower",
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 400.0,
    rho_va: float = 40000.0,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    storage_ratio: float = 0.0,
    storage_charge_max: float = 1.0,
    use_linelimit: bool = True,
    tight_factor: float = 0.99,
    outer_eps: float = 2e-5,
    droop: float = 0.04,
    verbose: int = 1,
    dtype=torch.float64,
    mesh=None,
    pad_lines_to: int = 1,
    device="cuda",
    data: OPFData | None = None,
) -> MpecResult:
    """Solve the MPEC of ``case`` (a MATPOWER file; pass ``data``, an
    already loaded or generated case, to skip the file) with two-level
    ADMM."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but CUDA is not "
                           "available")
    if data is None:
        data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    pad_lines_to = default_pad(pad_lines_to, mesh)

    par = Parameters(outer_iterlim=outer_iterlim, inner_iterlim=inner_iterlim,
                     obj_scale=obj_scale, scale=scale, outer_eps=outer_eps,
                     verbose=verbose)
    model = build_model(data, par, storage_ratio=storage_ratio,
                        storage_charge_max=storage_charge_max, droop=droop,
                        use_linelimit=use_linelimit,
                        tight_factor=tight_factor, pad_lines_to=pad_lines_to,
                        dtype=dtype, device=dev)
    sol = MM.init_solution(model, rho_pq, rho_va)
    sol, info = run_sharded(two_level_driver(model, mesh), model, sol, mesh)

    freq_change = float(sol.v.fg[0]) if model.grid.ngen > 0 else 0.0
    vm_dev = float(torch.amax(torch.abs(
        torch.sqrt(torch.clamp_min(sol.u.vg, 0.0)) - model.vm_setpoint)))
    if verbose > 0 and (mesh is None or mesh.rank == 0):
        print(f"Frequency change = {freq_change: 12.6e}")
        print(f"|VM-VM^sp|_infty = {vm_dev: 12.6e}")
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit,
                  storage_ratio=storage_ratio, droop=droop)
    return MpecResult(data=data, model=model, solution=sol, info=info,
                      freq_change=freq_change, vm_dev=vm_dev, env=env)
