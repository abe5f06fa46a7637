"""The port's MPEC model and solve against the JAX package's, on case9.

Tolerances:
- the converter round trip: exact.
- the storage placement, the primary-control data and the flat start: equal
  to the JAX model's (1e-15 relative for the computed arrays).
- hook by hook (x, xbar, z, l, lz, residual), each port hook fed the JAX
  hook's input state, taken after three JAX iterations of the storage model
  (storage_ratio 0.3): every block within 1e-10, the scalars within 1e-10
  relative (the branch batch and the bus sums round in other orders).
- the two case9 pins of the JAX package (CPU, fp64): the same outer and
  cumul, the objective within 1e-8 relative, freq_change within 1e-10.
- the complementarity checks of ``tests/test_mpec.py`` on the port's result.
"""

import numpy as np
import pytest
import torch

import exaadmm_tpu_torch as E
from exaadmm_tpu.interface.solve_mpec import solve_acopf_mpec as jax_mpec
from exaadmm_tpu.models.mpec import model as JMM
from exaadmm_tpu_torch.interface.solve_mpec import build_model
from exaadmm_tpu_torch.models.mpec import model as TMM
from exaadmm_tpu_torch.utils.convert import (mpec_solution_from_numpy,
                                             mpec_solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import Parameters
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

from .test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-4)
STORAGE = dict(storage_ratio=0.3, storage_charge_max=0.1)
PINS = {  # (outer, cumul, objective, freq_change) of the JAX package
    "plain": (23, 1401, 5329.132434858213, 0.00522887524118479),
    "storage": (12, 1073, 4936.875393666981, None),
}
BETA = 1e3


def _assert_state_close(got: dict, ref: dict, atol: float, what: str):
    for k, blk in ref.items():
        for f, r in blk.items():
            np.testing.assert_allclose(got[k][f], np.asarray(r), rtol=0,
                                       atol=atol, err_msg=f"{what} {k}.{f}")


@pytest.fixture(scope="module")
def models(case9_path):
    """The JAX model as its solve builds it (no iteration run) and the
    port's, both with storage."""
    jres = jax_mpec(case9_path, outer_iterlim=0, verbose=0, **KW, **STORAGE)
    tmodel = build_model(opf_loaddata(case9_path, verbose=0),
                         Parameters(verbose=0), **STORAGE)
    return jres.model, tmodel


def test_model_data_matches_jax(models):
    jm, tm = models
    st_j, st_t = jm.storage, tm.storage
    assert st_t.nstorage == st_j.nstorage == 3
    np.testing.assert_array_equal(st_t.bus.numpy(), np.asarray(st_j.bus))
    for k in ("chg_min", "chg_max", "energy_min", "energy_max",
              "energy_setpoint", "eta_chg", "eta_dis"):
        np.testing.assert_array_equal(getattr(st_t, k).numpy(),
                                      np.asarray(getattr(st_j, k)), err_msg=k)
    for k in ("alpha", "pg_setpoint", "vgmin", "vgmax", "vm_setpoint"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=1e-15,
                                   err_msg=k)
    assert tm.nvar == jm.nvar
    # the bus -> storage CSR the scatter walks
    ptr, idx = st_t.ptr.numpy(), st_t.idx.numpy()
    for b in range(tm.grid.nbus):
        assert list(st_t.bus.numpy()[idx[ptr[b]:ptr[b + 1]]]) == [b] * (
            ptr[b + 1] - ptr[b])


def test_converter_round_trip_and_init(models):
    jm, tm = models
    ref = mpec_solution_to_numpy(JMM.init_solution(jm, 4e2, 4e4))
    back = mpec_solution_to_numpy(mpec_solution_from_numpy(ref))
    for k, blk in ref.items():
        for f, r in blk.items():
            np.testing.assert_array_equal(back[k][f], r, err_msg=f"{k}.{f}")
    got = mpec_solution_to_numpy(TMM.init_solution(tm, 4e2, 4e4))
    _assert_state_close(got, ref, 1e-12, "init")


@pytest.fixture(scope="module")
def jax_chain(models):
    """The JAX model's hooks, three iterations in, then one more inner
    iteration hook by hook: (input state, output state) of each hook."""
    jm, _ = models
    s = JMM.init_solution(jm, 4e2, 4e4)
    for it in range(1, 4):
        s = jm.update_x(jm.inner_prestep(s), it)[0]
        s = jm.update_xbar(s)
        s = jm.update_z(s, BETA)
        s = jm.update_l(s, BETA)
        s = jm.update_residual(s, BETA)[0]
    chain = {}
    s_in = jm.inner_prestep(s)
    s_x, _ = jm.update_x(s_in, 4)
    chain["x"] = (s_in, s_x)
    chain["xbar"] = (s_x, jm.update_xbar(s_x))
    chain["z"] = (chain["xbar"][1], jm.update_z(chain["xbar"][1], BETA))
    chain["l"] = (chain["z"][1], jm.update_l(chain["z"][1], BETA))
    s_r, scalars = jm.update_residual(chain["l"][1], BETA)
    chain["residual"] = (chain["l"][1], s_r, scalars)
    chain["lz"] = (s_r, jm.update_lz(s_r, BETA))
    return chain


@pytest.mark.parametrize("hook", ["x", "xbar", "z", "l", "lz", "residual"])
def test_hooks_match_jax(models, jax_chain, hook):
    _, tm = models
    s_in, s_out = jax_chain[hook][:2]
    t_in = mpec_solution_from_numpy(mpec_solution_to_numpy(s_in))
    if hook == "x":
        got, stats = tm.update_x(t_in, 4)
        assert float(stats["max_cviol"]) >= 0.0
    elif hook == "xbar":
        got = tm.update_xbar(t_in)
    elif hook == "residual":
        got, scalars = tm.update_residual(t_in, BETA)
        for k, r in jax_chain[hook][2].items():
            np.testing.assert_allclose(float(scalars[k]), float(r),
                                       rtol=1e-10, err_msg=k)
    else:
        got = getattr(tm, f"update_{hook}")(t_in, BETA)
    _assert_state_close(mpec_solution_to_numpy(got),
                        mpec_solution_to_numpy(s_out), 1e-10, hook)


@pytest.fixture(scope="module")
def plain_result(case9_path):
    return E.solve_acopf_mpec(case9_path, outer_iterlim=25, verbose=0,
                              device="cpu", **KW)


@pytest.mark.parametrize("which", ["plain", "storage"])
def test_case9_pins(case9_path, plain_result, which):
    if which == "plain":
        res = plain_result
    else:
        res = E.solve_acopf_mpec(case9_path, outer_iterlim=40, verbose=0,
                                 device="cpu", **KW, **STORAGE)
    outer, cumul, obj, freq = PINS[which]
    info = res.info
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (outer, cumul)
    assert abs(info.objval - obj) / obj < 1e-8
    if freq is not None:
        assert abs(res.freq_change - freq) <= 1e-10
        assert res.vm_dev == 0.0
    else:
        ps = res.solution.u.sto.numpy()
        assert ps.shape == (3,) and np.all(np.abs(ps) <= 0.1 + 1e-6)
    assert info.mismatch <= np.sqrt(res.model.nvar) * 2e-4
    assert res.env.storage_ratio == (0.3 if which == "storage" else 0.0)


def test_complementarity_structure(plain_result):
    """The checks of tests/test_mpec.py, on the port's result."""
    sol, model = plain_result.solution, plain_result.model
    u = sol.u
    qg = u.gen[:, 1].numpy()
    vg = np.sqrt(np.maximum(u.vg.numpy(), 0.0))
    vsp = model.vm_setpoint.numpy()
    qgmin, qgmax = model.grid.qgmin.numpy(), model.grid.qgmax.numpy()
    tol = 1e-4
    for g in range(len(qg)):
        if qgmin[g] + tol < qg[g] < qgmax[g] - tol:
            assert abs(vg[g] - vsp[g]) <= 1e-3
        elif abs(qg[g] - qgmin[g]) <= tol:
            assert vg[g] >= vsp[g] - 1e-3
        else:
            assert vg[g] <= vsp[g] + 1e-3
    pg, fg = u.gen[:, 0].numpy(), u.fg.numpy()
    psp, alpha = model.pg_setpoint.numpy(), model.alpha.numpy()
    pgmin, pgmax = model.grid.pgmin.numpy(), model.grid.pgmax.numpy()
    for g in range(len(pg)):
        if pgmin[g] + tol < pg[g] < pgmax[g] - tol:
            assert abs(pg[g] - (psp[g] + alpha[g] * fg[g])) <= 1e-3
    vfg = sol.v.fg.numpy()
    assert np.ptp(vfg) <= 1e-12   # one system frequency
    np.testing.assert_allclose(fg, vfg, atol=5e-3)


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.solve_acopf_mpec(case9_path, verbose=0, device="cuda")
