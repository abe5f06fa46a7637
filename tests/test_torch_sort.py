"""Line-difficulty sorting (``Parameters.sort_lines``) against the JAX
package.

Tolerances:
- ``permute_lines`` / ``permute_solution_lines`` on a seeded permutation:
  every array equal to JAX's (a permutation moves numbers, it computes
  none). The arc CSR derived on the device for the new order equals
  ``build_csr`` of the permuted arcs exactly, and the bus sums walked over
  it agree with the unpermuted ones within 1e-14 of each channel's largest
  sum (the same numbers added in another order).
- a sorted two-level solve of the synthetic 300-bus case for 3 outer
  rounds: the same outer and cumul as JAX's sorted solve, the objective
  within 1e-10 relative, u back in canonical order and within 1e-7 of
  JAX's on >= 95 % of the lines and within 1e-5 on all. At this size a
  lane's TRON decision may flip on rounding, and the bus consensus spreads
  it: 11 of 510 lines beyond 1e-7, median 2.7e-9, max 1.4e-6 measured
  (the port's own sorted and unsorted solves differ by 7e-10). Against the
  port's unsorted solve: cumul within 2 and the objective within 1e-9, the
  contract of JAX's own test (tests/test_solve_acopf.py).
- ``ModelAcopf.with_line_order``: one inner iteration of the hooks on the
  reordered model and state gives the canonical iteration's rows in the
  new order, within 1e-12 of each block's largest entry, and its scalars
  within 1e-12 relative (the bus sums add in another order).
- two gloo ranks, each sorting its own line window, against one sorted
  process: cumul within 2 and the objective within 1e-8.
"""

import os

import numpy as np
import pytest
import torch

from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import IterationInformation as JInfo
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.environment import \
    permute_solution_lines as jax_permute_solution_lines
from exaadmm_tpu.utils.grid_data import permute_lines as jax_permute_lines
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu_torch.models.acopf import kernels
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.ops import bus_cuda
from exaadmm_tpu_torch.parallel import sharding
from exaadmm_tpu_torch.parallel.distributed import spawn_ranks
from exaadmm_tpu_torch.utils import checkpoint as TC
from exaadmm_tpu_torch.utils.convert import solution_to_numpy
from exaadmm_tpu_torch.utils.environment import (Parameters,
                                                 permute_solution_lines)
from exaadmm_tpu_torch.utils.grid_data import (LINE_FIELDS, build_csr,
                                               permute_lines)
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from . import torch_sharding_workers as W
from .test_torch_threads import one_torch_thread  # noqa: F401

SYNTH_KW = dict(verbose=0, outer_iterlim=3, inner_iterlim=30, outer_eps=2e-4)
CASE9_KW = dict(verbose=0, outer_iterlim=4, outer_eps=2e-5)


def _data(case):
    if case == "synth300":
        return synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                        case + ".m")
    return opf_loaddata(path, verbose=0), jax_opf_loaddata(path, verbose=0)


def _random_state(model, seed):
    """``init_solution`` with every line-indexed tensor filled from a numpy
    seed (so that a permutation shows)."""
    sol = TM.init_solution(model, 4e2, 4e4)
    rng = np.random.default_rng(seed)

    def fill(t):
        return torch.as_tensor(rng.normal(0, 1, tuple(t.shape)))

    return sharding._map_lines(sol, fill)


def _csr_walk(vals, ptr, idx):
    """The bus sums of ``vals`` walked over a CSR in its listed order, one
    add at a time, as ``csrc/bus_scatter.cu`` walks it."""
    vals, ptr, idx = vals.numpy(), ptr.numpy(), idx.numpy()
    out = np.zeros((len(ptr) - 1, vals.shape[1]))
    for b in range(len(ptr) - 1):
        for r in idx[ptr[b]:ptr[b + 1]]:
            out[b] += vals[r]
    return out


@pytest.mark.parametrize("case", ["case9", "synth300"])
def test_permute_lines_matches_jax(case):
    tdata, jdata = _data(case)
    tmodel = TM.build_model(tdata, Parameters(verbose=0), pad_lines_to=4)
    jmodel = JM.build_model(jdata, JParameters(verbose=0), pad_lines_to=4)
    n = tmodel.grid.nline_padded
    assert n > tdata.nline   # padded lanes move too
    ids = np.random.default_rng(5).permutation(n)
    tg = permute_lines(tmodel.grid, torch.as_tensor(ids))
    jg = jax_permute_lines(jmodel.grid, ids)
    for k in LINE_FIELDS:
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)

    # the arc CSR of the new order: build_csr's, ascending rows per bus
    valid = torch.cat([tg.line_mask, tg.line_mask]).numpy() > 0.5
    ptr, idx = build_csr(tg.arc_bus.numpy(), tg.nbus, valid=valid)
    np.testing.assert_array_equal(tg.arc_ptr.numpy(), ptr)
    np.testing.assert_array_equal(tg.arc_idx.numpy(), idx)
    assert tg.arc_idx.dtype == torch.int32
    np.testing.assert_array_equal(
        tg.arc_bus.numpy(), np.concatenate([tg.line_from.numpy(),
                                            tg.line_to.numpy()]))

    # the state moves with the lines, as in JAX
    sol = _random_state(tmodel, 6)
    psol = permute_solution_lines(sol, torch.as_tensor(ids))
    jsol = jax_permute_solution_lines(
        _to_jax(solution_to_numpy(sol), JM.init_solution(jmodel, 4e2, 4e4)),
        ids)
    got, ref = solution_to_numpy(psol), solution_to_numpy(jsol)
    for k, v in ref.items():
        for kk, arr in v.items():
            np.testing.assert_array_equal(got[k][kk], arr, err_msg=k + kk)

    # the bus sums over the new CSR are the unpermuted ones, reordered adds
    vals = kernels.bus_arc_values(sol.u, sol.z, sol.l, sol.rho,
                                  tmodel.grid)
    pvals = kernels.bus_arc_values(psol.u, psol.z, psol.l, psol.rho, tg)
    base = _csr_walk(vals, tmodel.grid.arc_ptr, tmodel.grid.arc_idx)
    scale = np.abs(base).max(axis=0)
    for got in (_csr_walk(pvals, tg.arc_ptr, tg.arc_idx),
                bus_cuda.bus_scatter(pvals, tg.arc_bus, tg.arc_ptr,
                                     tg.arc_idx).numpy()):
        assert (np.abs(got - base).max(axis=0) <= 1e-14 * scale).all()


def _to_jax(arrays, template):
    """A JAX Solution with ``template``'s structure holding ``arrays``
    (``solution_to_numpy``'s nested dict)."""
    import jax.numpy as jnp
    from exaadmm_tpu.utils.environment import Blocks, BranchALMState
    changes = {}
    for k, v in arrays.items():
        if k == "branch_alm":
            changes[k] = BranchALMState(**{kk: jnp.asarray(a)
                                           for kk, a in v.items()})
        else:
            changes[k] = Blocks(**{kk: jnp.asarray(a) for kk, a in v.items()})
    return template.replace(**changes)


def _jax_solve(jdata, par_kw, **build_kw):
    model = JM.build_model(jdata, JParameters(scale=1e-4, **par_kw),
                           **build_kw)
    sol, info = admm_two_level_fused(model, JM.init_solution(model, 4e2, 4e4),
                                     JInfo())
    return sol, info, model


def _port_solve(tdata, par_kw, **build_kw):
    model = TM.build_model(tdata, Parameters(**par_kw), **build_kw)
    grid = model.grid
    sol, info = admm_two_level(model, TM.init_solution(model, 4e2, 4e4))
    assert model.grid is grid   # the caller's model keeps its grid
    return sol, info, model


def _spread(sol, grid):
    """The largest spread of a bus's w over the line copies of it (0 when
    every row sits where the grid says its line is)."""
    v = sol.v.line.numpy()
    fr, to = grid.line_from.numpy(), grid.line_to.numpy()
    real = grid.line_mask.numpy() > 0.5
    return max(float(np.ptp(np.concatenate([v[(fr == b) & real, 4],
                                            v[(to == b) & real, 5]])))
               for b in range(grid.nbus) if ((fr == b) | (to == b)).any())


def test_sorted_solve_matches_jax():
    tdata, jdata = _data("synth300")
    jsol, jinfo, _ = _jax_solve(jdata, dict(SYNTH_KW, sort_lines=True))
    tsol, tinfo, tmodel = _port_solve(tdata, dict(SYNTH_KW, sort_lines=True))
    usol, uinfo, _ = _port_solve(tdata, SYNTH_KW)
    print(f"sorted: port {tinfo.outer} / {tinfo.cumul} / {tinfo.objval!r},"
          f" JAX {jinfo.outer} / {jinfo.cumul} / {jinfo.objval!r}; "
          f"unsorted port {uinfo.cumul} / {uinfo.objval!r}")
    assert (tinfo.outer, tinfo.cumul) == (jinfo.outer, jinfo.cumul)
    assert tinfo.objval == pytest.approx(jinfo.objval, rel=1e-10)
    du = np.abs(tsol.u.line.numpy() - np.asarray(jsol.u.line)).max(axis=1)
    print(f"u: {int((du > 1e-7).sum())} of {du.size} lines beyond 1e-7, "
          f"p50 {np.median(du):.3e} max {du.max():.3e}")
    assert (du <= 1e-7).mean() >= 0.95
    assert du.max() <= 1e-5
    # canonical order: every line copy of a bus's w agrees
    assert _spread(tsol, tmodel.grid) == 0.0
    # against the unsorted solve: JAX's own contract for a sorted batch
    assert abs(tinfo.cumul - uinfo.cumul) <= 2
    assert tinfo.objval == pytest.approx(uinfo.objval, rel=1e-9)
    np.testing.assert_allclose(tsol.u.line.numpy(), usol.u.line.numpy(),
                               atol=1e-6)


@pytest.fixture(scope="module")
def case9_unsorted():
    return _port_solve(_data("case9")[0], CASE9_KW)


def _inner_iteration(model, sol, beta=1e3):
    sol = model.inner_prestep(sol)
    sol, _ = model.update_x(sol, 1)
    sol = model.update_z(model.update_xbar(sol), beta)
    return model.update_residual(model.update_l(sol, beta), beta)


@pytest.mark.parametrize("use_linelimit", [True, False])
def test_with_line_order(use_linelimit):
    """The reordered model is a copy that shares everything but the grid's
    line arrays and CSR, and one inner iteration on it is the canonical
    one with its line rows reordered: no hook depends on the line order."""
    tdata, _ = _data("synth300")
    model = TM.build_model(tdata, Parameters(verbose=0), pad_lines_to=4,
                           use_linelimit=use_linelimit)
    grid = model.grid
    ids = torch.as_tensor(np.random.default_rng(7).permutation(
        grid.nline_padded))
    m = model.with_line_order(ids)
    assert model.grid is grid and m is not model
    assert (m.par, m.use_linelimit, m.pgmin_curr) == (
        model.par, model.use_linelimit, model.pgmin_curr)
    for k in LINE_FIELDS:
        assert torch.equal(getattr(m.grid, k), getattr(grid, k)[ids]), k
    assert torch.equal(m.grid.pgmin, grid.pgmin)

    sol = TM.init_solution(model, 4e2, 4e4)
    ref, ref_scalars = _inner_iteration(model, sol)
    got, got_scalars = _inner_iteration(m, permute_solution_lines(sol, ids))
    back = solution_to_numpy(permute_solution_lines(got, torch.argsort(ids)))
    for k, blocks in solution_to_numpy(ref).items():
        for kk, a in blocks.items():
            scale = max(float(np.abs(a).max()), 1.0)
            assert np.abs(back[k][kk] - a).max() <= 1e-12 * scale, k + kk
    for k, v in ref_scalars.items():
        assert float(got_scalars[k]) == pytest.approx(float(v), rel=1e-12,
                                                      abs=1e-300), k


def test_sorted_ranks_match_one_process(case9_path):
    kw = dict(CASE9_KW, sort_lines=True)
    one = W.acopf_sorted(None, "cpu", case9_path, kw)
    got = spawn_ranks(W.acopf_sorted, (case9_path, kw), nprocs=2,
                      device="cpu", timeout=60.0, join_timeout=150.0,
                      threads=1)
    assert one["sorted_rounds"] == got["sorted_rounds"] > 0
    assert got["outer"] == one["outer"]
    assert abs(got["cumul"] - one["cumul"]) <= 2
    assert got["objval"] == pytest.approx(one["objval"], rel=1e-8)
    # both in canonical order: the real lines agree, the padded lane is 0
    np.testing.assert_allclose(got["line"][:9], one["line"], atol=1e-6)
    np.testing.assert_array_equal(got["line"][9:], 0.0)


def test_checkpoint_round_trip_sorted(tmp_path, case9_unsorted):
    tdata, _ = _data("case9")
    sol, info, model = _port_solve(tdata, dict(CASE9_KW, sort_lines=True))
    usol = case9_unsorted[0]
    path = os.path.join(tmp_path, "sorted.npz")
    TC.save_solution(path, sol, meta={"outer": info.outer})
    back, meta = TC.load_solution(path, TM.init_solution(model, 4e2, 4e4))
    assert meta["outer"] == info.outer
    for (name, a), (_, b) in zip(TC._leaves(sol), TC._leaves(back)):
        assert torch.equal(a, b), name
    # what was saved is in canonical order
    np.testing.assert_allclose(back.u.line.numpy(), usol.u.line.numpy(),
                               atol=1e-6)
    assert _spread(back, model.grid) == 0.0


def test_only_the_acopf_model_sorts():
    """As in the JAX package, only the single-period ACOPF model declares
    ``supports_line_sort``: the driver leaves the multi-period, MPEC and QP
    models' lines in their order whatever ``Parameters.sort_lines`` says."""
    from exaadmm_tpu_torch.models.mpacopf.model import ModelMpacopf
    from exaadmm_tpu_torch.models.mpec.model import ModelMpec
    from exaadmm_tpu_torch.models.qpsub.model import ModelQpsub
    assert TM.ModelAcopf.supports_line_sort is True
    for cls in (ModelMpacopf, ModelMpec, ModelQpsub):
        assert not getattr(cls, "supports_line_sort", False), cls
