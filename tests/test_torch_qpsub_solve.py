"""The port's ``solve_qpsub`` end to end on the CPU.

The pin is the reference regression that the JAX package reproduces
exactly (``test_qpsub.py:144-171``): the case9 QP at rho (4000, 4000),
scale 1e-4, outer_eps 2e-6 solves in 5107 one-level iterations to the
objective -21.92744641968529 (within 1e-8). About 95 s on one CPU thread;
it has this file to itself so that it runs on its own test worker.

``poststep`` is checked against the JAX ``poststep`` on the port's final
state, converted: every output within 1e-9 relative to its largest
magnitude (the JAX version differentiates with jax.grad, the port with
torch.autograd, and their sums run in other orders).
"""

import numpy as np
import pytest
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu.models.qpsub import model as JQ
from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS

from .test_torch_qpsub import _jax_solution, _models, _qp_inputs
from .test_torch_threads import one_torch_thread  # noqa: F401

PIN_ITERS, PIN_OBJ = 5107, -21.92744641968529
PIN_KW = dict(outer_iterlim=10000, inner_iterlim=1, scale=1e-4,
              obj_scale=1.0, rho_pq=4000.0, rho_va=4000.0, outer_eps=2e-6,
              onelevel=True, device="cpu")


def _args():
    (_, tq), _ = _qp_inputs("case9")
    return [tq[k] for k in QP_KEYS] + [1e5]


@pytest.fixture(scope="module")
def pin_result(case9_path):
    return E.solve_qpsub(case9_path, *_args(), verbose=0, **PIN_KW)


def test_case9_pin(pin_result):
    info = pin_result.info
    assert info.status == "Solved"
    assert info.outer == PIN_ITERS
    assert info.cumul == PIN_ITERS
    assert info.inner == 1
    assert info.objval == pytest.approx(PIN_OBJ, abs=1e-8)
    out = pin_result.sqp_out
    assert out["dual_infeas"].shape == (3 + 6 * 9,)
    assert out["lambda"].shape == (4, 9)
    assert np.all(out["lambda"][2:] <= 1e-12)
    for v in out.values():
        assert np.isfinite(v).all()


def test_poststep_matches_jax(pin_result):
    from exaadmm_tpu_torch.utils.convert import qpsub_solution_to_numpy

    _, jm = _models("case9")
    ref = JQ.poststep(jm, _jax_solution(
        qpsub_solution_to_numpy(pin_result.solution)))
    got = pin_result.sqp_out
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k], r, rtol=0,
                                   atol=1e-9 * max(float(np.abs(r).max()),
                                                   1e-300), err_msg=k)


@pytest.mark.parametrize("kw,match", [
    (dict(onelevel=False), "two-level"),
])
def test_unported_options_raise(case9_path, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        E.solve_qpsub(case9_path, *_args(), verbose=0, device="cpu", **kw)


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.solve_qpsub(case9_path, *_args(), verbose=0, device="cuda")


def test_verbose_prints_every_50th_iteration(case9_path, capsys):
    res = E.solve_qpsub(case9_path, *_args(), verbose=1, outer_iterlim=60,
                        rho_pq=4000.0, rho_va=4000.0,
                        branch_backend="pallas", pallas_tile=256,
                        bus_backend="kr", device="cpu")
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    iters = [int(r[0]) for r in rows if r and r[0].isdigit()]
    assert iters == [1, 51]
    assert res.info.status == "IterationLimit"
    assert res.info.outer == res.info.cumul == 60


def test_fp32_solve_runs(case9_path):
    """An fp32 solve runs the same path (the wrapper's tolerances floor at
    the dtype's epsilon) and ends finite."""
    res = E.solve_qpsub(case9_path, *_args(), verbose=0, outer_iterlim=200,
                        rho_pq=4000.0, rho_va=4000.0, dtype=torch.float32,
                        device="cpu")
    assert res.solution.base.u.line.dtype == torch.float32
    assert np.isfinite(res.info.objval) and np.isfinite(res.info.mismatch)
    _, jm = _models("case9")
    assert res.model.nvar == jm.nvar
