"""The port's checkpoint against the JAX package's, in one file format.

- round trip: every leaf of ``Solution``, ``SolutionMpacopf``,
  ``SolutionQpsub`` and the MPEC state comes back bit-equal, with the meta;
- cross-load: a file written by the JAX package's ``save_solution`` loads
  into the port's template and a file written by the port loads into the
  JAX package's, every leaf equal (exact: the file holds the numbers);
- the resume test of tests/test_checkpoint.py on the port;
- a leaf-count or shape mismatch raises ``ValueError``.

The states are filled from a numpy seed, so every leaf differs."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from exaadmm_tpu.interface.solve_mpec import solve_acopf_mpec as jax_mpec
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.models.mpacopf import model as JMP
from exaadmm_tpu.models.mpec import model as JMM
from exaadmm_tpu.models.qpsub import model as JQ
from exaadmm_tpu.utils import checkpoint as JC
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu_torch.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu_torch.interface.solve_mpec import build_model as build_mpec
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.models.mpacopf import model as TMP
from exaadmm_tpu_torch.models.mpec import model as TMM
from exaadmm_tpu_torch.models.qpsub import model as TQ
from exaadmm_tpu_torch.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
from exaadmm_tpu_torch.utils import checkpoint as TC
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.grid_data import build_grid_data
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata

from .test_torch_threads import one_torch_thread  # noqa: F401

STORAGE = dict(storage_ratio=0.3, storage_charge_max=0.1)
KINDS = ("acopf", "mpacopf", "qpsub", "mpec")


def _templates(kind, case9_path):
    """(the port's flat-start state, the JAX package's) of one kind."""
    tdata = opf_loaddata(case9_path, verbose=0)
    jdata = jax_opf_loaddata(case9_path, verbose=0)
    tpar, jpar = Parameters(verbose=0), JParameters(verbose=0)
    if kind == "acopf":
        return (TM.init_solution(TM.build_model(tdata, tpar), 4e2, 4e4),
                JM.init_solution(JM.build_model(jdata, jpar), 4e2, 4e4))
    if kind == "mpacopf":
        pd, qd = load_time_series(
            os.path.join(os.path.dirname(case9_path), "case9_demand"))
        kw = dict(start_period=1, end_period=3)
        return (TMP.init_solution(TMP.build_model(tdata, tpar, pd, qd, **kw),
                                  4e2, 4e4),
                JMP.init_solution(JMP.build_model(jdata, jpar, pd, qd, **kw),
                                  4e2, 4e4))
    if kind == "qpsub":
        qp = build_qp_inputs(tdata, build_grid_data(tdata), SqpBasePoint(
            pg=tdata.Pg0, qg=tdata.Qg0, vm=tdata.Vm, va=tdata.Va))
        return (TQ.init_solution(TQ.build_model(tdata, tpar, qp), 4e3, 4e3),
                JQ.init_solution(JQ.build_model(jdata, jpar, qp), 4e3, 4e3))
    jres = jax_mpec(case9_path, outer_iterlim=0, verbose=0, **STORAGE)
    return (TMM.init_solution(build_mpec(tdata, tpar, **STORAGE), 4e2, 4e4),
            JMM.init_solution(jres.model, 4e2, 4e4))


def _seeded(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def _fill_torch(template, values):
    return TC._rebuild(template, iter(torch.as_tensor(v) for v in values))


def _fill_jax(template, values):
    leaves, treedef = jax.tree_util.tree_flatten(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(v) for v in values])


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_bit_equal(kind, case9_path, tmp_path):
    template, _ = _templates(kind, case9_path)
    leaves = TC._leaves(template)
    sol = _fill_torch(template, _seeded([tuple(v.shape) for _, v in leaves]))
    p = str(tmp_path / "ckpt.npz")
    TC.save_solution(p, sol, meta={"outer": 3, "beta": 6e3, "kind": kind})
    back, meta = TC.load_solution(p, template)
    assert meta == {"outer": 3, "beta": 6e3, "kind": kind}
    assert type(back) is type(sol)
    for (name, a), (_, b) in zip(TC._leaves(sol), TC._leaves(back)):
        assert b.dtype == a.dtype and torch.equal(a, b), name
    assert len(leaves) == {"acopf": 21, "mpacopf": 30, "qpsub": 27,
                           "mpec": 48}[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_cross_load_with_jax(kind, case9_path, tmp_path):
    ttemplate, jtemplate = _templates(kind, case9_path)
    tleaves = TC._leaves(ttemplate)
    jleaves = jax.tree_util.tree_leaves(jtemplate)
    # the same structure: leaf count, order and shapes
    assert [tuple(v.shape) for _, v in tleaves] == [
        tuple(np.shape(v)) for v in jleaves]
    values = _seeded([tuple(v.shape) for _, v in tleaves], seed=1)

    # the JAX package writes, the port reads
    pj = str(tmp_path / "jax.npz")
    JC.save_solution(pj, _fill_jax(jtemplate, values), meta={"by": "jax"})
    got, meta = TC.load_solution(pj, ttemplate)
    assert meta == {"by": "jax"}
    for (name, g), v in zip(TC._leaves(got), values):
        np.testing.assert_array_equal(g.numpy(), v, err_msg=name)

    # the port writes, the JAX package reads; the key names are the same
    pt = str(tmp_path / "torch.npz")
    TC.save_solution(pt, _fill_torch(ttemplate, values), meta={"by": "torch"})
    with np.load(pj) as a, np.load(pt) as b:
        assert a.files == b.files
    jgot, meta = JC.load_solution(pt, jtemplate)
    assert meta == {"by": "torch"}
    assert (jax.tree_util.tree_structure(jgot)
            == jax.tree_util.tree_structure(jtemplate))
    for g, v in zip(jax.tree_util.tree_leaves(jgot), values):
        np.testing.assert_array_equal(np.asarray(g), v)


def test_load_takes_dtype_from_template(case9_path, tmp_path):
    data = opf_loaddata(case9_path, verbose=0)
    m64 = TM.build_model(data, Parameters(verbose=0))
    m32 = TM.build_model(data, Parameters(verbose=0), dtype=torch.float32)
    p = str(tmp_path / "c.npz")
    TC.save_solution(p, TM.init_solution(m64, 4e2, 4e4))
    back, meta = TC.load_solution(p, TM.init_solution(m32, 4e2, 4e4))
    assert meta == {}
    assert back.v.line.dtype == torch.float32
    assert back.v.line.device.type == "cpu"


def test_checkpoint_roundtrip_and_resume(case9_path, tmp_path):
    """tests/test_checkpoint.py on the port: five outer iterations, save,
    load into a fresh flat start, resume with the saved beta to Solved."""
    data = opf_loaddata(case9_path, verbose=0)
    par = Parameters(verbose=0, outer_iterlim=5, outer_eps=2e-5)
    model = TM.build_model(data, par)
    sol5, info5 = admm_two_level(model, TM.init_solution(model, 4e2, 4e4))

    p = str(tmp_path / "ckpt.npz")
    TC.save_solution(p, sol5, meta={"outer": info5.outer, "beta": par.beta})
    restored, meta = TC.load_solution(p, TM.init_solution(model, 4e2, 4e4))
    assert meta["outer"] == 5
    for (name, a), (_, b) in zip(TC._leaves(sol5), TC._leaves(restored)):
        assert torch.equal(a, b), name

    par2 = Parameters(verbose=0, outer_iterlim=20, outer_eps=2e-5,
                      initial_beta=meta["beta"])
    model2 = TM.build_model(data, par2)
    _, infoF = admm_two_level(model2, restored)
    assert infoF.status == "Solved"
    assert 5296.0 <= infoF.objval <= 5304.5


def test_mismatches_raise(case9_path, tmp_path):
    data = opf_loaddata(case9_path, verbose=0)
    model = TM.build_model(data, Parameters(verbose=0))
    sol = TM.init_solution(model, 4e2, 4e4)
    p = str(tmp_path / "c.npz")
    TC.save_solution(p, sol)
    # another line count: a shape mismatch
    padded = TM.build_model(data, Parameters(verbose=0), pad_lines_to=8)
    with pytest.raises(ValueError, match="leaf shape mismatch"):
        TC.load_solution(p, TM.init_solution(padded, 4e2, 4e4))
    # another record: a leaf-count mismatch
    with pytest.raises(ValueError, match="21 leaves, template has 2"):
        TC.load_solution(p, sol.u)
    # one process reads a one-rank directory; another mesh size is refused
    d = str(tmp_path / "dir")
    TC.save_solution_sharded(d, sol, meta={"outer": 0})
    back, meta = TC.load_solution_sharded(d, sol)
    assert meta == {"outer": 0} and torch.equal(back.v.line, sol.v.line)
    from exaadmm_tpu_torch.parallel.sharding import Mesh
    with pytest.raises(ValueError, match="written by 1 ranks"):
        TC.load_solution_sharded(d, sol, Mesh(group=None, rank=0, size=2))


def test_exports():
    import exaadmm_tpu
    import exaadmm_tpu_torch as E
    for name in ("AdmmEnv", "save_solution", "load_solution"):
        assert name in E.__all__ and name in exaadmm_tpu.__all__
    assert E.save_solution is TC.save_solution
    assert [f.name for f in dataclasses.fields(E.AdmmEnv)][:5] == [
        "case", "data", "initial_rho_pq", "initial_rho_va", "params"]
