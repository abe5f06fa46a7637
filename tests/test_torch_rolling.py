"""The port's rolling-horizon solve against the JAX package's pins, case9
with the in-repo demand series, periods 1-3, fp64.

The pins are the JAX package's own results on the CPU (``solve_acopf_rolling``
with tight_factor 1.0): the port runs the same iterations, so the integers
must be equal and each period's objective within 1e-8 relative (the two
differ by rounding only). ``update_real_power_current_bounds`` is elementwise
max/min and must be exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu.interface.solve_acopf_rolling import \
    update_real_power_current_bounds as jax_bounds
from exaadmm_tpu_torch.interface.solve_acopf_rolling import \
    update_real_power_current_bounds

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMAND = os.path.join(ROOT, "data", "case9_demand")
KW = dict(rho_pq=4e2, rho_va=4e4, outer_iterlim=25, outer_eps=2e-4,
          end_period=3, tight_factor=1.0, verbose=0)
PINS = [(20, 973, 5286.652017310178), (9, 166, 5403.734908384519),
        (7, 91, 5355.780080975317)]


@pytest.fixture(scope="module")
def rolling(case9_path):
    return E.solve_acopf_rolling(case9_path, DEMAND, device="cpu", **KW)


@pytest.mark.parametrize("period", [1, 2, 3])
def test_period_pins(rolling, period):
    _, infos = rolling
    assert len(infos) == 3
    info = infos[period - 1]
    outer, cumul, obj = PINS[period - 1]
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (outer, cumul)
    assert abs(info.objval - obj) / obj < 1e-8


def test_last_period_result_and_bounds(rolling):
    res, infos = rolling
    assert res.info is infos[-1]
    gd = res.model.grid
    # the bounds after the last period: within ramp of its dispatch
    pg = res.solution.u.gen[:, 0]
    ramp = 0.02 * gd.pgmax
    assert bool((res.model.pgmin_curr >= gd.pgmin).all())
    assert bool((res.model.pgmax_curr <= gd.pgmax).all())
    assert bool((res.model.pgmax_curr - res.model.pgmin_curr
                 <= 2 * ramp + 1e-12).all())
    assert bool((pg >= res.model.pgmin_curr - 1e-9).all())


def test_bounds_update_matches_jax():
    rng = np.random.default_rng(0)
    pgmin = rng.uniform(0.0, 1.0, 16)
    pgmax = pgmin + rng.uniform(0.0, 2.0, 16)
    ramp = 0.02 * pgmax
    pg = rng.uniform(-0.5, 3.0, 16)
    got = update_real_power_current_bounds(
        *(torch.as_tensor(a) for a in (pgmin, pgmax, ramp, pg)))
    ref = jax_bounds(*(jnp.asarray(a) for a in (pgmin, pgmax, ramp, pg)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bad_periods_raise(case9_path):
    with pytest.raises(ValueError, match="periods"):
        E.solve_acopf_rolling(case9_path, DEMAND, start_period=2,
                              end_period=1, verbose=0, device="cpu")


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.solve_acopf_rolling(case9_path, DEMAND, verbose=0, device="cuda")
