"""case118 end to end on the port: the correctness anchor above case9 size,
after tests/test_case118.py.

The reference pins Solved, outer 20 and the objective 129645.676 for
case118 at rho_pq=4e2 / rho_va=4e4 / outer_eps=2e-5; as in the JAX test the
objective is held within 1e-4 relative (both solvers stop at a loose
consensus tolerance) and the port's own trajectory is pinned exactly:
outer and cumul, which equal the JAX package's 20 / 1281, and the objective
to 1e-10 relative (CPU, fp64, one torch thread). The JAX package's own
objective, taken on 8 virtual CPU devices, differs from the port's by 1e-8
relative (another reduction order). At a cut depth the two packages run
side by side on the same case and settings."""

import os

import numpy as np
import pytest

import exaadmm_tpu
import exaadmm_tpu_torch as E

from .test_torch_threads import one_torch_thread  # noqa: F401

CASE118 = os.path.join(os.path.dirname(__file__), "..", "data", "case118.m")

PIN_OUTER = 20
PIN_CUMUL = 1281
PIN_OBJ = 129638.3553876704
JAX_PIN_OBJ = 129638.35360544993


def test_case118_two_level_pinned():
    res = E.solve_acopf(CASE118, outer_iterlim=25, rho_pq=4e2, rho_va=4e4,
                        outer_eps=2e-5, verbose=0, device="cpu")
    info = res.info
    assert info.status == "Solved"
    # the reference's anchor: the same outer count, the objective within
    # cross-implementation slack
    assert info.outer == 20
    assert abs(info.objval - 129645.676) / 129645.676 < 1e-4
    # the port's own trajectory
    assert info.outer == PIN_OUTER
    assert info.cumul == PIN_CUMUL
    assert abs(info.objval - PIN_OBJ) / PIN_OBJ < 1e-10
    assert abs(info.objval - JAX_PIN_OBJ) / JAX_PIN_OBJ < 1e-7
    assert res.solution.u.line.shape == (186, 8)


@pytest.mark.parametrize("outer_iterlim", [3])
def test_case118_cut_depth_matches_jax(outer_iterlim):
    """The first outer iterations of the same solve through both packages:
    the same iteration counts, the objective within 1e-8 relative, the
    residuals within 1e-6 relative, u within 1e-6 (two implementations of
    the branch TRON solve stop at slightly different points within its
    tolerance, which the iterates carry along)."""
    kw = dict(outer_iterlim=outer_iterlim, rho_pq=4e2, rho_va=4e4,
              outer_eps=2e-5, verbose=0)
    ref = exaadmm_tpu.solve_acopf(CASE118, **kw)
    got = E.solve_acopf(CASE118, device="cpu", **kw)
    assert got.info.status == ref.info.status == "IterationLimit"
    assert (got.info.outer, got.info.inner, got.info.cumul) == (
        ref.info.outer, ref.info.inner, ref.info.cumul)
    np.testing.assert_allclose(got.info.objval, ref.info.objval, rtol=1e-8)
    for name in ("primres", "dualres", "mismatch", "norm_z_curr"):
        np.testing.assert_allclose(getattr(got.info, name),
                                   getattr(ref.info, name), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(got.solution.u.gen.numpy(),
                               np.asarray(ref.solution.u.gen), atol=1e-6)
    np.testing.assert_allclose(got.solution.u.line.numpy(),
                               np.asarray(ref.solution.u.line)[:186],
                               atol=1e-6)
