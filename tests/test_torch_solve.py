"""The port's two-level ADMM solve against the JAX package's, on case9.

Tolerances:
- one inner iteration, hook by hook: every block within 1e-9 of the JAX
  state (the branch solves agree to ~1e-12; the margin covers sin/cos/pow
  rounding that differs between the libraries), and the reference's golden
  line block within 2e-5 (its own solver's termination point).
- three outer iterations: the integers equal and objval, primres and
  mismatch within 1e-8 relative: the two trajectories differ only by
  rounding, which the ADMM contraction keeps small.
- the full solve (fp64): the JAX package's own pins, 25 outer / 1087 inner
  and the objective within 1e-8 relative of 5300.5962555071965 (the JAX
  test holds its own solve to 1e-10).
"""

import numpy as np
import pytest
import torch

import exaadmm_tpu
import exaadmm_tpu_torch
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.utils.convert import solution_to_numpy
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

from .test_acopf_golden import U_BR, U_GEN
from .test_solve_acopf import PIN_CUMUL, PIN_OBJ, PIN_OUTER
from .test_torch_threads import one_torch_thread  # noqa: F401

RHO_PQ, RHO_VA, BETA = 4e2, 4e4, 1e3


def _chain(model, sol):
    """z_prev <- z; x; xbar; z; l; residual; lz: one inner iteration and the
    outer lz step through the model's hooks (both packages name them alike),
    as the golden test of the JAX package runs them."""
    out = {"x": model.update_x(model.inner_prestep(sol), 1)[0]}
    out["xbar"] = model.update_xbar(out["x"])
    out["z"] = model.update_z(out["xbar"], BETA)
    out["l"] = model.update_l(out["z"], BETA)
    out["r"], scalars = model.update_residual(out["l"], BETA)
    out["lz"] = model.update_lz(out["r"], BETA)
    return out, scalars


@pytest.fixture(scope="module")
def one_iter(case9_path):
    jmodel = JM.build_model(jax_opf_loaddata(case9_path, verbose=0),
                            JParameters(verbose=0, scale=1e-4))
    tmodel = TM.build_model(opf_loaddata(case9_path, verbose=0),
                            Parameters(verbose=0, scale=1e-4))
    jout, jsc = _chain(jmodel, JM.init_solution(jmodel, RHO_PQ, RHO_VA))
    tout, tsc = _chain(tmodel, TM.init_solution(tmodel, RHO_PQ, RHO_VA))
    return jout, jsc, tout, tsc


@pytest.mark.parametrize("stage", ["x", "xbar", "z", "l", "r", "lz"])
def test_hook_chain_matches_jax(one_iter, stage):
    jout, _, tout, _ = one_iter
    a, b = solution_to_numpy(tout[stage]), solution_to_numpy(jout[stage])
    for k, v in b.items():
        for kk, ref in v.items():
            np.testing.assert_allclose(a[k][kk], ref, rtol=0, atol=1e-9,
                                       err_msg=f"{stage}: {k}.{kk}")


def test_hook_chain_scalars_and_golden(one_iter):
    _, jsc, tout, tsc = one_iter
    for k in jsc:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-9)
    np.testing.assert_allclose(tout["x"].u.gen.numpy(), U_GEN, atol=1e-6)
    np.testing.assert_allclose(tout["x"].u.line.numpy(), U_BR, atol=2e-5)


def test_three_outer_iterations_match_jax(case9_path):
    kw = dict(rho_pq=RHO_PQ, rho_va=RHO_VA, outer_eps=2e-5, outer_iterlim=3,
              verbose=0)
    ref = exaadmm_tpu.solve_acopf(case9_path, **kw).info
    got = exaadmm_tpu_torch.solve_acopf(case9_path, device="cpu", **kw).info
    assert (got.outer, got.inner, got.cumul) == (ref.outer, ref.inner,
                                                 ref.cumul)
    assert got.status == ref.status
    for name in ("objval", "primres", "mismatch", "dualres", "norm_z_curr"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-8, err_msg=name)


def test_case9_full_solve_hits_the_pins(case9_path):
    res = exaadmm_tpu_torch.solve_acopf(
        case9_path, outer_iterlim=25, rho_pq=RHO_PQ, rho_va=RHO_VA,
        outer_eps=2e-5, verbose=0, device="cpu")
    info = res.info
    assert info.status == "Solved"
    assert 5296.0 <= info.objval <= 5304.5
    pg_mw = res.solution.u.gen[:, 0].numpy() * 100.0
    np.testing.assert_allclose(pg_mw, [89.8, 134.32, 94.19], atol=1.0)
    assert info.outer == PIN_OUTER
    assert info.cumul == PIN_CUMUL
    assert abs(info.objval - PIN_OBJ) / PIN_OBJ < 1e-8
    assert res.solution.u.line.dtype == torch.float64


def test_verbose_prints_one_line_per_outer(case9_path, capsys):
    res = exaadmm_tpu_torch.solve_acopf(
        case9_path, outer_iterlim=2, rho_pq=RHO_PQ, rho_va=RHO_VA, verbose=1,
        device="cpu")
    lines = capsys.readouterr().out.splitlines()
    head = [i for i, ln in enumerate(lines) if ln.split()[:2] == ["Outer",
                                                                   "Inner"]]
    assert len(head) == 1
    rows = lines[head[0] + 1:]
    assert [int(r.split()[0]) for r in rows] == [1, 2]
    assert int(rows[-1].split()[1]) == res.info.inner


def test_fp32_solve_runs(case9_path):
    res = exaadmm_tpu_torch.solve_acopf(
        case9_path, outer_iterlim=2, rho_pq=RHO_PQ, rho_va=RHO_VA,
        verbose=0, dtype=torch.float32, device="cpu")
    assert res.solution.u.line.dtype == torch.float32
    assert np.isfinite(res.info.mismatch)


def test_no_linelimit_is_not_ported(case9_path):
    """The polar path without line limits is ported now: one outer
    iteration runs it, with no ALM state and no constraint violation (its
    parity with the JAX package is in test_torch_polar.py)."""
    res = exaadmm_tpu_torch.solve_acopf(case9_path, outer_iterlim=1,
                                        verbose=0, use_linelimit=False,
                                        device="cpu")
    assert res.info.max_cviol == 0.0
    assert np.isfinite(res.info.mismatch)
    assert torch.equal(res.solution.branch_alm.mu,
                       torch.full_like(res.solution.branch_alm.mu, 10.0))
