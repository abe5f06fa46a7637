"""What one rank runs in tests/test_torch_sharding.py and
tests/test_torch_fused_mesh.py.

``spawn_ranks`` starts the ranks as new processes, which find their function
by module name; this module imports only torch and the port, so a rank
starts without jax or pytest. Every function takes (mesh, device, ...) and
returns plain numbers and numpy arrays (rank 0's go back to the test)."""

import contextlib
import os

import numpy as np
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.algorithms import admm_one_level as one
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.algorithms.admm_one_level import admm_one_level
from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu_torch.algorithms.carry import leaves
from exaadmm_tpu_torch.interface import solve_acopf as iface_acopf
from exaadmm_tpu_torch.interface import solve_qpsub as iface_qpsub
from exaadmm_tpu_torch.models.acopf import model as M
from exaadmm_tpu_torch.models.mpacopf import model as MP
from exaadmm_tpu_torch.parallel import sharding
from exaadmm_tpu_torch.utils.checkpoint import (load_solution_sharded,
                                                save_solution_sharded,
                                                _leaves)
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata


#: the ``IterationInformation`` fields a fused solve and its host loop agree on
INFO_FIELDS = ("status", "outer", "inner", "cumul", "objval", "auglag",
               "primres", "dualres", "mismatch", "norm_z_curr",
               "norm_z_prev", "max_cviol", "eps_pri")


def _info(info):
    return dict(status=info.status, outer=info.outer, cumul=info.cumul,
                objval=info.objval, primres=info.primres,
                max_cviol=info.max_cviol)


def acopf(mesh, dev, case, kw):
    res = E.solve_acopf(case, mesh=mesh, device=dev, **kw)
    return dict(_info(res.info), gen=res.solution.u.gen.numpy(),
                line=res.solution.u.line.numpy(), beta=res.model.par.beta,
                nline_padded=res.model.grid.nline_padded)


def acopf_sorted(mesh, dev, case, kw):
    """``Parameters(**kw)`` (``sort_lines`` among them) through the model and
    the ADMM loop, as ``solve_acopf`` has no ``sort_lines``; also counts the
    rounds that sorted this rank's lines."""
    rounds = []
    reorder = M.ModelAcopf.with_line_order

    def counted(self, ids):
        rounds.append(ids.shape[0])
        return reorder(self, ids)

    M.ModelAcopf.with_line_order = counted
    try:
        data = opf_loaddata(case, verbose=0)
        model = M.build_model(data, Parameters(**kw), device=dev,
                              pad_lines_to=1 if mesh is None else mesh.size)
        sol, info = sharding.run_sharded(
            admm_two_level, model, M.init_solution(model, 4e2, 4e4), mesh)
    finally:
        M.ModelAcopf.with_line_order = reorder
    return dict(_info(info), line=sol.u.line.numpy(),
                sorted_rounds=len(rounds))


def mpacopf(mesh, dev, case, kw):
    """Multi-period, sharded through the model and the ADMM loop (there is no
    ``mesh`` on ``solve_mpacopf``, as in the JAX package)."""
    data = opf_loaddata(case, verbose=0)
    prefix = os.path.join(os.path.dirname(case), "case9_demand")
    pd_mat, qd_mat = load_time_series(prefix)
    par = Parameters(verbose=0, **kw)
    model = MP.build_model(data, par, pd_mat, qd_mat, start_period=1,
                           end_period=3, pad_lines_to=mesh.size, device=dev)
    sol = MP.init_solution(model, 4e2, 4e4)
    sol, info = sharding.run_sharded(admm_two_level, model, sol, mesh)
    return dict(_info(info), gen=sol.acopf.u.gen.numpy(),
                line_shape=tuple(sol.acopf.u.line.shape))


def qpsub(mesh, dev, case, qp_args, kw):
    res = E.solve_qpsub(case, *qp_args, mesh=mesh, device=dev, **kw)
    return dict(_info(res.info), gen=res.solution.base.u.gen.numpy(),
                sqp_line=res.solution.sqp_line.numpy(),
                dual_infeas=res.sqp_out["dual_infeas"])


def mpec(mesh, dev, case, kw):
    res = E.solve_acopf_mpec(case, mesh=mesh, device=dev, **kw)
    return dict(_info(res.info), gen=res.solution.u.gen.numpy(),
                sto=res.solution.u.sto.numpy(), freq_change=res.freq_change,
                line_shape=tuple(res.solution.u.line.shape))


def collectives(mesh, dev, case, inner):
    """The collectives of ``inner`` inner iterations of the two-level loop
    on this rank's local model, with nothing gathered."""
    data = opf_loaddata(case, verbose=0)
    par = Parameters(verbose=0, outer_iterlim=1, inner_iterlim=inner)
    model = M.build_model(data, par, pad_lines_to=mesh.size, device=dev)
    sol = sharding.local_solution(M.init_solution(model, 4e2, 4e4), mesh)
    local = sharding.local_model(model, mesh)
    sharding.reset_counts()
    sharding.log = []
    _, info = admm_two_level(local, sol)
    log, sharding.log = sharding.log, None
    return dict(cumul=info.cumul, log=log, counts=dict(sharding.counts),
                nbus=data.nbus)


def sharded_checkpoint(mesh, dev, case, path):
    """Two outer iterations on the local model, then the local state saved
    and loaded per rank; returns whether every leaf came back bit-equal and
    the gathered u.line beside the local shapes."""
    data = opf_loaddata(case, verbose=0)
    par = Parameters(verbose=0, outer_iterlim=2)
    model = M.build_model(data, par, pad_lines_to=mesh.size, device=dev)
    template = sharding.local_solution(M.init_solution(model, 4e2, 4e4), mesh)
    sol, info = admm_two_level(sharding.local_model(model, mesh), template)
    save_solution_sharded(path, sol, mesh, meta={"outer": info.outer,
                                                 "beta": par.beta})
    back, meta = load_solution_sharded(path, template, mesh)
    same = all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(sol), _leaves(back)))
    same = bool(sharding.all_reduce_sum(
        torch.tensor(0.0 if same else 1.0), mesh) == 0.0)
    full = sharding.gather_solution(back, mesh)
    return dict(same=same, meta=meta, files=sorted(os.listdir(path)),
                local_lines=sol.u.line.shape[0],
                line=full.u.line.numpy(), cumul=info.cumul)


@contextlib.contextmanager
def host_loops():
    """``solve_acopf`` and ``solve_qpsub`` with their host loops at verbose
    0 (each interface module's driver choice, swapped)."""
    saved = (iface_acopf.two_level_driver, iface_qpsub.one_level_driver)
    iface_acopf.two_level_driver = lambda model, mesh=None: admm_two_level
    iface_qpsub.one_level_driver = lambda model, mesh=None: admm_one_level
    try:
        yield
    finally:
        iface_acopf.two_level_driver, iface_qpsub.one_level_driver = saved


@contextlib.contextmanager
def counted(module, name: str, calls: list):
    """``module.name`` wrapped to append ``name`` to ``calls``."""
    fn = getattr(module, name)

    def call(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _same(a, b) -> bool:
    """Every tensor of two solution records bit-identical."""
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b), strict=True))


def _pair(fused, host, sol_f, sol_h, calls):
    return dict(fused=_info(fused), host=_info(host),
                info_equal=all(getattr(fused, k) == getattr(host, k)
                               for k in INFO_FIELDS),
                same=_same(sol_f, sol_h), calls=list(calls))


def fused_against_host(mesh, dev, case, kw, qp_args=None, qp_kw=None,
                       sort_kw=None):
    """Over ``mesh``, each solve by the fused driver and by the host loop:
    ``solve_acopf`` at ``kw``; with ``qp_args``, ``solve_qpsub``; with
    ``sort_kw``, ``Parameters(sort_lines=True, **sort_kw)`` through the
    model and ``run_sharded``. Each pair gives both infos, whether the infos
    are equal and every tensor of the gathered solutions bit-identical, and
    which fused drivers ran. Then the collectives of the fused loop: its
    bodies for ``kw``'s first outer iteration on this rank's local model,
    logged and counted, with nothing gathered."""
    out = {}
    calls = []
    with counted(two, "admm_two_level_fused", calls):
        fused = E.solve_acopf(case, mesh=mesh, device=dev, **kw)
    with host_loops():
        host = E.solve_acopf(case, mesh=mesh, device=dev, **kw)
    out["acopf"] = dict(_pair(fused.info, host.info, fused.solution,
                              host.solution, calls),
                        gen=fused.solution.u.gen.numpy(),
                        line=fused.solution.u.line.numpy())
    if qp_args is not None:
        calls = []
        with counted(one, "admm_one_level_fused", calls):
            fused = E.solve_qpsub(case, *qp_args, mesh=mesh, device=dev,
                                  **qp_kw)
        with host_loops():
            host = E.solve_qpsub(case, *qp_args, mesh=mesh, device=dev,
                                 **qp_kw)
        out["qpsub"] = dict(_pair(fused.info, host.info, fused.solution,
                                  host.solution, calls),
                            gen=fused.solution.base.u.gen.numpy())
    if sort_kw is not None:
        data = opf_loaddata(case, verbose=0)

        def solve(driver):
            model = M.build_model(data, Parameters(sort_lines=True,
                                                   **sort_kw),
                                  pad_lines_to=mesh.size, device=dev)
            return sharding.run_sharded(driver(model), model,
                                        M.init_solution(model, 4e2, 4e4),
                                        mesh)

        calls = []
        with counted(two, "admm_two_level_fused", calls):
            sol_f, info_f = solve(lambda m: two.two_level_driver(m, mesh))
        sol_h, info_h = solve(lambda m: admm_two_level)
        out["sorted"] = dict(_pair(info_f, info_h, sol_f, sol_h, calls),
                             line=sol_f.u.line.numpy())

    data = opf_loaddata(case, verbose=0)
    model = M.build_model(data, Parameters(verbose=0, outer_iterlim=1),
                          pad_lines_to=mesh.size, device=dev)
    sol = sharding.local_solution(M.init_solution(model, 4e2, 4e4), mesh)
    local = sharding.local_model(model, mesh)
    sharding.reset_counts()
    sharding.log = []
    _, info = two.admm_two_level_fused(local, sol)
    log, sharding.log = sharding.log, None
    out["collectives"] = dict(cumul=info.cumul, log=log,
                              counts=dict(sharding.counts), nbus=data.nbus)
    return out
