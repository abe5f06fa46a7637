"""Lines split across ranks: the port's ranks against the port's one process
and against the JAX package's one-process solve on the same inputs.

The ranks are real processes over gloo on the CPU (``spawn_ranks``: a free
port, a group timeout and a join timeout, so a hang fails instead of
sticking). The contract is the JAX package's (tests/test_sharding.py): the
same iteration counts, the objective within 1e-8 (1e-6 multi-period), not
bit-identity, since summing per-rank partial sums is a second reduction
order. With 9 lines, 2 ranks pad 1 lane on the last rank and 4 ranks pad 3.
"""

import os

import numpy as np
import pytest

import exaadmm_tpu
import exaadmm_tpu_torch as E
from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu_torch.models.mpacopf import model as MP
from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
from exaadmm_tpu_torch.parallel import sharding
from exaadmm_tpu_torch.parallel.distributed import spawn_ranks
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata

from . import torch_sharding_workers as W
from .test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, outer_iterlim=6, verbose=0)


def _spawn(fn, args, nprocs):
    return spawn_ranks(fn, args, nprocs=nprocs, device="cpu", timeout=60.0,
                       join_timeout=150.0, threads=1)


@pytest.fixture(scope="module")
def single(case9_path):
    return E.solve_acopf(case9_path, device="cpu", **KW)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_case9_sharded_matches_single(case9_path, single, nprocs):
    got = _spawn(W.acopf, (case9_path, KW), nprocs)
    assert got["cumul"] == single.info.cumul
    assert got["outer"] == single.info.outer
    assert got["objval"] == pytest.approx(single.info.objval, rel=1e-8)
    assert got["primres"] == pytest.approx(single.info.primres, rel=1e-6)
    assert got["max_cviol"] == pytest.approx(single.info.max_cviol,
                                             rel=1e-6, abs=1e-12)
    assert got["beta"] == single.model.par.beta
    np.testing.assert_allclose(got["gen"], single.solution.u.gen.numpy(),
                               atol=1e-8)
    # every rank gets the padded global length; compare the real lines
    assert got["nline_padded"] == -(-9 // nprocs) * nprocs
    assert got["line"].shape == (got["nline_padded"], 8)
    np.testing.assert_allclose(got["line"][:9],
                               single.solution.u.line.numpy(), atol=1e-6)
    np.testing.assert_array_equal(got["line"][9:], 0.0)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_case9_sharded_matches_jax(case9_path, nprocs):
    """The ranks against the JAX package's one process on the same case and
    settings: the same counts, the objective within 1e-8 relative, u within
    1e-6 on the real lines and the generators."""
    ref = exaadmm_tpu.solve_acopf(case9_path, **KW)
    got = _spawn(W.acopf, (case9_path, KW), nprocs)
    assert (got["outer"], got["cumul"]) == (ref.info.outer, ref.info.cumul)
    assert got["status"] == ref.info.status
    assert got["objval"] == pytest.approx(ref.info.objval, rel=1e-8)
    assert got["primres"] == pytest.approx(ref.info.primres, rel=1e-6)
    np.testing.assert_allclose(got["gen"], np.asarray(ref.solution.u.gen),
                               atol=1e-6)
    np.testing.assert_allclose(got["line"][:9],
                               np.asarray(ref.solution.u.line)[:9], atol=1e-6)


def test_case9_sharded_full_solve(case9_path):
    got = _spawn(W.acopf, (case9_path, dict(KW, outer_iterlim=25)), 2)
    assert got["status"] == "Solved"
    assert 5296.0 <= got["objval"] <= 5304.5
    assert (got["outer"], got["cumul"]) == (25, 1087)


def test_pad_lines_to_in_one_process(case9_path, single):
    """Padding alone (no mesh) runs in one process and changes no count."""
    res = E.solve_acopf(case9_path, device="cpu", pad_lines_to=8, **KW)
    assert res.solution.u.line.shape == (16, 8)
    assert (res.info.outer, res.info.cumul) == (single.info.outer,
                                                single.info.cumul)
    assert res.info.objval == pytest.approx(single.info.objval, rel=1e-12)


def test_mpacopf_sharded_matches_single(case9_path):
    kw = dict(outer_iterlim=4, outer_eps=2e-4)
    data = opf_loaddata(case9_path, verbose=0)
    prefix = os.path.join(os.path.dirname(case9_path), "case9_demand")
    pd_mat, qd_mat = load_time_series(prefix)
    m1 = MP.build_model(data, Parameters(verbose=0, **kw), pd_mat, qd_mat,
                        start_period=1, end_period=3)
    s1, i1 = admm_two_level(m1, MP.init_solution(m1, 4e2, 4e4))
    got = _spawn(W.mpacopf, (case9_path, kw), 2)
    assert got["cumul"] == i1.cumul
    assert got["objval"] == pytest.approx(i1.objval, rel=1e-6)
    assert got["line_shape"] == (3, 10, 8)
    np.testing.assert_allclose(got["gen"], s1.acopf.u.gen.numpy(), atol=1e-7)


def test_qpsub_sharded_matches_single(case9_path):
    data = opf_loaddata(case9_path, verbose=0)
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    args = tuple(qp[k] for k in QP_KEYS)
    kw = dict(outer_iterlim=150, rho_pq=4e3, rho_va=4e3, outer_eps=2e-6,
              verbose=0)
    one = E.solve_qpsub(case9_path, *args, device="cpu", **kw)
    padded = E.solve_qpsub(case9_path, *args, device="cpu", pad_lines_to=8,
                           **kw)
    assert padded.info.cumul == one.info.cumul
    assert padded.info.objval == pytest.approx(one.info.objval, rel=1e-12)
    got = _spawn(W.qpsub, (case9_path, args, kw), 2)
    assert got["cumul"] == one.info.cumul == 150
    assert got["objval"] == pytest.approx(one.info.objval, rel=1e-8)
    assert got["primres"] == pytest.approx(one.info.primres, rel=1e-6)
    np.testing.assert_allclose(got["gen"], one.solution.base.u.gen.numpy(),
                               atol=1e-8)
    assert got["sqp_line"].shape == (10, 6)
    np.testing.assert_allclose(got["sqp_line"][:9],
                               one.solution.sqp_line.numpy(), atol=1e-6)
    np.testing.assert_allclose(got["dual_infeas"], one.sqp_out["dual_infeas"],
                               atol=1e-6)


def test_mpec_sharded_matches_single(case9_path):
    kw = dict(rho_pq=4e2, rho_va=4e4, outer_iterlim=4, outer_eps=2e-4,
              storage_ratio=0.3, storage_charge_max=0.1, verbose=0)
    one = E.solve_acopf_mpec(case9_path, device="cpu", **kw)
    padded = E.solve_acopf_mpec(case9_path, device="cpu", pad_lines_to=8,
                                **kw)
    assert padded.info.cumul == one.info.cumul
    got = _spawn(W.mpec, (case9_path, kw), 2)
    assert got["cumul"] == one.info.cumul
    assert got["objval"] == pytest.approx(one.info.objval, rel=1e-8)
    assert got["freq_change"] == pytest.approx(one.freq_change, rel=1e-6,
                                               abs=1e-10)
    assert got["line_shape"] == (10, 8)
    np.testing.assert_allclose(got["gen"], one.solution.u.gen.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(got["sto"], one.solution.u.sto.numpy(),
                               atol=1e-8)


def test_collective_guard(case9_path):
    """One inner ACOPF iteration with line limits makes exactly four
    all-reduces, the bus sums (nbus, 8), the residual partials (7,), the
    branch effort sums (2,) and the scalar max_cviol, and gathers nothing:
    a later edit cannot slip in a per-iteration gather or a fifth
    reduction unnoticed."""
    got = _spawn(W.collectives, (case9_path, 5), 2)
    assert got["cumul"] == 5
    kinds = [(k, shape) for k, shape, _ in got["log"]]
    per_iteration = [("all_reduce_sum", (2,)), ("all_reduce_max", ()),
                     ("all_reduce_sum", (got["nbus"], 8)),
                     ("all_reduce_sum", (7,))]
    assert kinds == per_iteration * 5
    assert got["counts"] == {"all_reduce_sum": 15, "all_reduce_max": 5,
                             "all_gather": 0}
    # bytes per inner iteration: fp64 payloads
    assert sum(b for _, _, b in got["log"][:4]) == 8 * (2 + 1 + 72 + 7)


def test_collectives_are_identity_without_mesh():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    sharding.reset_counts()
    for mesh in (None, sharding.make_mesh()):
        assert sharding.all_reduce_sum(x, mesh) is x
        assert sharding.all_reduce_max(x, mesh) is x
        assert sharding.all_gather(x, mesh) is x
    assert sharding.make_mesh().size == 1
    assert sum(sharding.counts.values()) == 0
    with pytest.raises(ValueError, match="not divisible"):
        sharding.line_window(9, sharding.Mesh(group=None, rank=0, size=2))


def test_local_grid_windows(case9_path):
    """A rank's grid: its window of the line arrays, the arc CSR over its
    real lines only, and the whole grid's line count kept."""
    data = opf_loaddata(case9_path, verbose=0)
    gd = build_grid_data(data, pad_lines_to=4)
    arcs = 0
    for rank in range(4):
        mesh = sharding.Mesh(group=None, rank=rank, size=4)
        loc = sharding.local_grid(gd, mesh)
        assert (loc.nline, loc.nline_padded) == (9, 3)
        assert loc.mesh is mesh
        assert loc.line_from.tolist() == gd.line_from[3 * rank:
                                                      3 * rank + 3].tolist()
        real = int(loc.line_mask.sum())
        assert real == (3 if rank < 3 else 0)
        assert loc.arc_idx.shape[0] == 2 * real
        assert loc.arc_ptr.shape[0] == data.nbus + 1
        arcs += int(loc.arc_ptr[-1])
    assert arcs == 2 * 9


def test_sharded_checkpoint_roundtrip(case9_path, tmp_path):
    path = str(tmp_path / "ckpt")
    got = _spawn(W.sharded_checkpoint, (case9_path, path), 2)
    assert got["same"]
    assert got["meta"]["outer"] == 2
    assert got["files"] == ["meta.json", "rank00000-of-00002.npz",
                            "rank00001-of-00002.npz"]
    assert got["local_lines"] == 5 and got["line"].shape == (10, 8)
    one = E.solve_acopf(case9_path, device="cpu", rho_pq=4e2, rho_va=4e4,
                        outer_iterlim=2, verbose=0)
    assert got["cumul"] == one.info.cumul
    np.testing.assert_allclose(got["line"][:9], one.solution.u.line.numpy(),
                               atol=1e-6)
