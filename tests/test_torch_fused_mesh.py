"""The fused drivers under a mesh and with line sorting, on the CPU.

- Under a mesh of 2 and 4 gloo ranks (real processes, ``spawn_ranks``, as
  in tests/test_torch_sharding.py), the fused driver against the host loop
  under the same mesh: the same status, counts and info, and every tensor
  of the gathered solutions bit-identical (``torch.equal``): the same
  bodies, the same collectives in the same order.
- The same solves against the JAX package's sharded fused drivers on a mesh
  of as many virtual CPU devices (``make_sharded_fused_solver`` through
  ``solve_acopf(mesh=...)``, ``make_sharded_one_level`` through
  ``solve_qpsub(mesh=...)``): equal outer and cumul (iterations for the
  QP), the objective within 1e-8 relative, u within 1e-6 on the real lines
  and the generators, as ``test_torch_sharding.py::
  test_case9_sharded_matches_jax`` (summing per-rank partial sums is
  another reduction order than XLA's).
- ``Parameters(sort_lines=True)`` in one process: the fused solve against
  the sorted host loop (bit-identical) and against the JAX package's fused
  solve with ``sort_lines=True`` (equal counts, the objective within 1e-9
  relative, JAX's own sorted-against-unsorted contract); and sorting under
  a mesh of 2 ranks, fused against the host loop (bit-identical).
- The collectives of the fused loop's bodies: four all-reduces per inner
  iteration, no gather.

Case9 throughout, at the sharding tests' 6 outer iterations; the ranks run
every pair in one start.
"""

import os

import numpy as np
import pytest
import torch

import exaadmm_tpu
from exaadmm_tpu.algorithms.admm_two_level import \
    admm_two_level_fused as jax_fused
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.parallel.sharding import make_mesh as jax_mesh
from exaadmm_tpu.utils.environment import IterationInformation as JInfo
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.algorithms.carry import leaves
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
from exaadmm_tpu_torch.parallel.distributed import spawn_ranks
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

from . import torch_sharding_workers as W
from .test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, outer_iterlim=6, verbose=0)
QP_KW = dict(outer_iterlim=150, rho_pq=4e3, rho_va=4e3, outer_eps=2e-6,
             verbose=0)
SORT_KW = dict(verbose=0, outer_iterlim=4, outer_eps=2e-5)
CASE9 = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                     "case9.m")


def _qp_args():
    data = opf_loaddata(CASE9, verbose=0)
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    return tuple(qp[k] for k in QP_KEYS)


@pytest.fixture(scope="module")
def ranks():
    """Rank 0's pairs on 2 ranks (every solve) and on 4 (the ACOPF)."""
    out = {}
    for n, extra in ((2, (_qp_args(), QP_KW, SORT_KW)), (4, ())):
        out[n] = spawn_ranks(W.fused_against_host, (CASE9, KW) + extra,
                             nprocs=n, device="cpu", timeout=60.0,
                             join_timeout=150.0, threads=1)
    return out


def _held(pair, fused: str):
    assert pair["calls"] == [fused]
    assert pair["info_equal"], (pair["fused"], pair["host"])
    assert pair["same"]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_fused_mesh_matches_host_loop(ranks, nprocs):
    pair = ranks[nprocs]["acopf"]
    _held(pair, "admm_two_level_fused")
    assert pair["fused"]["outer"] == 6


@pytest.mark.parametrize("nprocs", [2, 4])
def test_fused_mesh_matches_jax(ranks, nprocs):
    """Against ``make_sharded_fused_solver`` on a mesh of ``nprocs`` virtual
    CPU devices."""
    ref = exaadmm_tpu.solve_acopf(CASE9, mesh=jax_mesh(nprocs), **KW)
    got = ranks[nprocs]["acopf"]
    info = got["fused"]
    assert (info["outer"], info["cumul"]) == (ref.info.outer, ref.info.cumul)
    assert info["status"] == ref.info.status
    assert info["objval"] == pytest.approx(ref.info.objval, rel=1e-8)
    np.testing.assert_allclose(got["gen"], np.asarray(ref.solution.u.gen),
                               atol=1e-6)
    np.testing.assert_allclose(got["line"][:9],
                               np.asarray(ref.solution.u.line)[:9], atol=1e-6)
    np.testing.assert_array_equal(got["line"][9:], 0.0)


def test_fused_one_level_mesh(ranks):
    """The QP over 2 ranks: fused against the host loop, then against
    ``make_sharded_one_level`` on 2 virtual devices."""
    pair = ranks[2]["qpsub"]
    _held(pair, "admm_one_level_fused")
    ref = exaadmm_tpu.solve_qpsub(CASE9, *_qp_args(), mesh=jax_mesh(2),
                                  **QP_KW)
    info = pair["fused"]
    assert info["cumul"] == info["outer"] == ref.info.cumul == 150
    assert info["objval"] == pytest.approx(ref.info.objval, rel=1e-8)
    np.testing.assert_allclose(pair["gen"],
                               np.asarray(ref.solution.base.u.gen),
                               atol=1e-6)


def test_fused_sorted_mesh(ranks):
    """Each rank sorting its own line window inside the fused loop, against
    the sorted host loop over the same mesh."""
    pair = ranks[2]["sorted"]
    _held(pair, "admm_two_level_fused")
    assert pair["fused"]["outer"] == SORT_KW["outer_iterlim"]
    # the rows back in canonical order: the padded lane is last, and 0
    np.testing.assert_array_equal(pair["line"][9:], 0.0)


def test_fused_collective_guard(ranks):
    """The fused loop's bodies make exactly the host loop's collectives:
    the branch effort sums (2,) and max_cviol, the bus sums (nbus, 8) and
    the residual partials (7,) per inner iteration, and no gather."""
    for n in (2, 4):
        got = ranks[n]["collectives"]
        kinds = [(k, shape) for k, shape, _ in got["log"]]
        per_iteration = [("all_reduce_sum", (2,)), ("all_reduce_max", ()),
                         ("all_reduce_sum", (got["nbus"], 8)),
                         ("all_reduce_sum", (7,))]
        assert got["cumul"] > 1
        assert kinds == per_iteration * got["cumul"]
        assert got["counts"] == {"all_reduce_sum": 3 * got["cumul"],
                                 "all_reduce_max": got["cumul"],
                                 "all_gather": 0}


@pytest.fixture(scope="module")
def sorted_pair():
    """The sorted case9 solve by the host loop and by the driver at
    verbose 0 (the fused one), from one model."""
    data = opf_loaddata(CASE9, verbose=0)
    model = TM.build_model(data, Parameters(sort_lines=True, **SORT_KW))
    driver = two.two_level_driver(model)
    assert driver.func is two.admm_two_level_fused
    host = two.admm_two_level(model, TM.init_solution(model, 4e2, 4e4))
    fused = driver(model, TM.init_solution(model, 4e2, 4e4))
    return host, fused


def test_fused_sorted_matches_host_loop(sorted_pair):
    (sh, ih), (sf, i_f) = sorted_pair
    for k in W.INFO_FIELDS:
        assert getattr(i_f, k) == getattr(ih, k), k
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(sf), leaves(sh), strict=True))


def test_fused_sorted_matches_jax(sorted_pair):
    """Against the JAX package's fused solve with ``sort_lines=True``."""
    jdata = jax_opf_loaddata(CASE9, verbose=0)
    jmodel = JM.build_model(jdata, JParameters(scale=1e-4, sort_lines=True,
                                               **SORT_KW))
    _, jinfo = jax_fused(jmodel, JM.init_solution(jmodel, 4e2, 4e4), JInfo())
    _, info = sorted_pair[1]
    assert (info.outer, info.cumul) == (jinfo.outer, jinfo.cumul)
    assert info.objval == pytest.approx(jinfo.objval, rel=1e-9)
