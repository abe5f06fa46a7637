"""The port's grid data against the JAX package's, field by field.

Both packages build the grid from the same numpy arithmetic, so every field
must be equal exactly (tolerance 0). The port's bus adjacency (CSR) must
reproduce ``np.add.at`` sums exactly, since both add the rows of a bus in
ascending order.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.grid_data import build_grid_data as jax_build_grid_data
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.utils.convert import (grid_data_from_numpy,
                                             grid_to_numpy,
                                             solution_from_numpy,
                                             solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.grid_data import GridData, build_grid_data
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from .test_torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
CASES = ["case9", "case118", "case9_pglib", "synth300"]
_DERIVED = {"arc_ptr", "arc_idx", "arc_bus", "gen_ptr", "gen_idx", "mesh"}


def _load(case):
    """(port OPFData, JAX OPFData) of one case."""
    if case == "synth300":
        return synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)
    path = os.path.join(DATA, case + ".m")
    return opf_loaddata(path, verbose=0), jax_opf_loaddata(path, verbose=0)


@pytest.mark.parametrize("pad", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_grid_fields_equal_jax(case, pad):
    data, jdata = _load(case)
    gd = build_grid_data(data, pad_lines_to=pad)
    jgd = jax_build_grid_data(jdata, pad_lines_to=pad)
    jd = grid_to_numpy(jgd)
    for f in dataclasses.fields(GridData):
        if f.name in _DERIVED:
            continue
        got = getattr(gd, f.name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, jd[f.name], err_msg=f.name)
    assert gd.nline_padded % pad == 0
    # padded lanes point at bus 0 and are masked out
    pad_rows = gd.line_mask.numpy() < 0.5
    assert pad_rows.sum() == gd.nline_padded - gd.nline
    assert (gd.line_from.numpy()[pad_rows] == 0).all()


def test_synthetic_same_seed_same_grid():
    data, jdata = _load("synth300")
    for f in dataclasses.fields(data):
        np.testing.assert_array_equal(np.asarray(getattr(data, f.name)),
                                      np.asarray(getattr(jdata, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("case", CASES)
def test_csr_reproduces_add_at(case):
    data, _ = _load(case)
    gd = build_grid_data(data, pad_lines_to=4)
    rng = np.random.default_rng(0)
    mask = np.concatenate([gd.line_mask.numpy()] * 2)
    for ptr, idx, ids, nrows in (
            (gd.arc_ptr, gd.arc_idx, gd.arc_bus, 2 * gd.nline_padded),
            (gd.gen_ptr, gd.gen_idx, gd.gen_bus, gd.ngen)):
        vals = rng.standard_normal((nrows, 8)) * 1e3
        if nrows == mask.shape[0]:
            vals = vals * mask[:, None]   # padded arcs carry zeros
        ref = np.zeros((gd.nbus, 8))
        np.add.at(ref, ids.numpy(), vals)
        ptr_n, idx_n = ptr.numpy(), idx.numpy()
        assert ptr_n.shape == (gd.nbus + 1,) and ptr_n[0] == 0
        got = np.zeros((gd.nbus, 8))
        for b in range(gd.nbus):
            rows = idx_n[ptr_n[b]:ptr_n[b + 1]]
            assert (np.diff(rows) > 0).all()       # ascending arc order
            assert (ids.numpy()[rows] == b).all()
            for r in rows:
                got[b] += vals[r]
        np.testing.assert_array_equal(got, ref)
    # the arc CSR holds every real arc once and no padded one
    assert gd.arc_idx.shape == (2 * gd.nline,)


def test_convert_round_trip(case9_path):
    data = opf_loaddata(case9_path, verbose=0)
    jmodel = JM.build_model(jax_opf_loaddata(case9_path, verbose=0),
                            JParameters(verbose=0), pad_lines_to=4)
    gd = grid_data_from_numpy(grid_to_numpy(jmodel.grid))
    ref = build_grid_data(data, pad_lines_to=4)
    for f in dataclasses.fields(GridData):
        a, b = getattr(gd, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name

    d = solution_to_numpy(JM.init_solution(jmodel, 4e2, 4e4))
    sol = solution_from_numpy(d)
    back = solution_to_numpy(sol)
    for k, v in d.items():
        for kk, arr in v.items():
            np.testing.assert_array_equal(back[k][kk], arr)
    # the port's own init_solution gives the same state
    port = solution_to_numpy(TM.init_solution(
        TM.ModelAcopf(ref, Parameters(verbose=0)), 4e2, 4e4))
    for k, v in d.items():
        for kk, arr in v.items():
            np.testing.assert_array_equal(port[k][kk], arr, err_msg=k + kk)


def test_dtype_and_device_follow_arguments():
    data, _ = _load("case9")
    gd = build_grid_data(data, dtype=torch.float32)
    assert gd.YffR.dtype == torch.float32
    assert gd.line_from.dtype == torch.int64
    assert gd.arc_ptr.dtype == torch.int32
    assert gd.to("cpu").YffR.device.type == "cpu"
