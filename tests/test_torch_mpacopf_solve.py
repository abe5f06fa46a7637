"""The port's multi-period solve (``solve_mpacopf``) against the JAX
package's pins, case9 with the in-repo demand series, 3 periods, fp64.

The pins are those of ``tests/test_mpacopf.py``: the port runs the same
iteration as the JAX package, so the integers must be equal and the
objective within 1e-8 relative (the JAX test holds its own solve to 1e-10;
the two differ by rounding only)."""

import os

import numpy as np
import pytest
import torch

import exaadmm_tpu_torch
from exaadmm_tpu_torch.utils.synthetic import (synthetic_case,
                                               synthetic_load_profile)

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMAND = os.path.join(ROOT, "data", "case9_demand")
KW = dict(start_period=1, end_period=3, rho_pq=4e2, rho_va=4e4,
          outer_eps=2e-4, verbose=0, device="cpu")


def test_no_warm_start_hits_the_pins(case9_path):
    res = exaadmm_tpu_torch.solve_mpacopf(case9_path, DEMAND, outer_iterlim=30,
                                          warm_start=False, **KW)
    info = res.info
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (20, 1007)
    assert abs(info.objval - 16015.6958770167) / 16015.6958770167 < 1e-8
    assert res.err_ramp <= 1e-3
    assert res.env.load_specified and res.env.horizon_length == 3


def test_warm_start_hits_the_pins(case9_path):
    res = exaadmm_tpu_torch.solve_mpacopf(case9_path, DEMAND, outer_iterlim=25,
                                          **KW)
    info = res.info
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (4, 12)
    assert abs(info.objval - 16019.152412382537) / 16019.152412382537 < 1e-8
    assert res.err_ramp <= 1e-3
    # per-period generation tracks the per-period load ordering
    pg = res.solution.acopf.u.gen[:, :, 0].sum(dim=1).numpy()
    assert pg[1] > pg[0] > 0


def test_generated_case_and_loads_run():
    """The ``data``/``loads`` arguments (a generated grid and load profile,
    as the card's full-width run uses them) in fp32."""
    data = synthetic_case(30, seed=0)
    res = exaadmm_tpu_torch.solve_mpacopf(
        data.case, data=data, loads=synthetic_load_profile(data, 2),
        end_period=2, outer_iterlim=1, inner_iterlim=3, warm_start=False,
        verbose=0, dtype=torch.float32, device="cpu")
    assert res.info.cumul == 3
    assert res.solution.acopf.u.line.shape == (2, data.nline, 8)
    assert res.solution.acopf.u.line.dtype == torch.float32
    assert np.isfinite(res.info.mismatch) and np.isfinite(res.err_ramp)


def test_projection_is_not_ported(case9_path):
    with pytest.raises(NotImplementedError):
        exaadmm_tpu_torch.solve_mpacopf(case9_path, DEMAND, end_period=2,
                                        verbose=0, use_projection=True,
                                        device="cpu")


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exaadmm_tpu_torch.solve_mpacopf(case9_path, DEMAND, end_period=2,
                                        verbose=0, device="cuda")
