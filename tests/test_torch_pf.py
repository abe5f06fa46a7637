"""The port's power flow, power-flow projection and diagnostics against the
JAX package's.

Both packages run the Newton power flow and the projection on the host with
numpy and scipy, so on the same inputs they agree to rounding.

Tolerances:
- ``build_ybus``: equal; ``solve_pf`` on case9 and synthetic 300 buses: the
  same iteration counts, vm/va within 1e-12; ``from_power_flow``: equal.
- ``pf_projection`` on one state fed to both: v within 1e-12.
- ``solve_acopf(use_projection=True)``: the JAX pin (Solved, 25 / 1087,
  objective within 1e-8 relative of 5300.596255734668, pf residual within
  1e-6 relative of 1.956858238190212e-08) and every line copy of a bus's w
  equal (``tests/test_pf.py:40-43``).
- ``solve_mpacopf(use_projection=True)``, 3 periods, and
  ``solve_qpsub(use_projection=True)``, 150 iterations, against the JAX
  solves at the same settings: the projected v within 1e-8 (the ADMM
  states agree to ~1e-10 and the Newton solve carries that along).
- ``compute_violations`` on one state fed to both: within 1e-12.
- ``solve_acopf_from_env`` reproduces outer, cumul and objval exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import exaadmm_tpu
import exaadmm_tpu_torch as E
from exaadmm_tpu.interface.solve_mpacopf import solve_mpacopf as jax_mpacopf
from exaadmm_tpu.interface.solve_qpsub import solve_qpsub as jax_qpsub
from exaadmm_tpu.models.acopf.diagnostics import \
    compute_violations as jax_violations
from exaadmm_tpu.models.pf import newton as JN
from exaadmm_tpu.models.pf.projection import pf_projection as jax_projection
from exaadmm_tpu.models.qpsub import sqp as JS
from exaadmm_tpu.utils import environment as JE
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
from exaadmm_tpu_torch.models.acopf.diagnostics import compute_violations
from exaadmm_tpu_torch.models.pf import newton as TN
from exaadmm_tpu_torch.models.pf.projection import pf_projection
from exaadmm_tpu_torch.models.qpsub import sqp as TS
from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
from exaadmm_tpu_torch.utils.convert import (solution_from_numpy,
                                             solution_to_numpy)
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.print_statistics import print_statistics
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from .test_torch_qpsub import _qp_inputs
from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMAND = os.path.join(ROOT, "data", "case9_demand")
PIN_OUTER, PIN_CUMUL = 25, 1087
PIN_OBJ, PIN_RES = 5300.596255734668, 1.956858238190212e-08
KW = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, outer_iterlim=25,
          verbose=0)


def _cases(case9_path):
    return {"case9": (opf_loaddata(case9_path, verbose=0),
                      jax_opf_loaddata(case9_path, verbose=0)),
            "synth300": (synthetic_case(300, seed=0),
                         jax_synthetic_case(300, seed=0))}


def _jax_solution(d: dict):
    """A JAX Solution from the numpy dicts of ``solution_to_numpy``."""
    blocks = {k: JE.Blocks(gen=jnp.asarray(v["gen"]),
                           line=jnp.asarray(v["line"]))
              for k, v in d.items() if k != "branch_alm"}
    return JE.Solution(**blocks, branch_alm=JE.BranchALMState(
        **{k: jnp.asarray(v) for k, v in d["branch_alm"].items()}))


@pytest.mark.parametrize("case", ["case9", "synth300"])
def test_power_flow_matches_jax(case9_path, case):
    tdata, jdata = _cases(case9_path)[case]
    y_t, y_j = TN.build_ybus(tdata), JN.build_ybus(jdata)
    assert (y_t != y_j).nnz == 0
    # the synthetic case's own operating point is a power-flow solution
    # already (0 iterations from the warm start); the flat start iterates
    for start in ("warm", "flat"):
        got = E.solve_pf(tdata, start_method=start, verbose=0)
        ref = JN.solve_pf(jdata, start_method=start, verbose=0)
        assert got.converged and got.iterations == ref.iterations
        np.testing.assert_allclose(got.vm, ref.vm, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.va, ref.va, rtol=0, atol=1e-12)
    assert got.iterations > 0


def test_from_power_flow_matches_jax(case9_path):
    tdata, jdata = _cases(case9_path)["case9"]
    got = TS.SqpBasePoint.from_power_flow(tdata)
    ref = JS.SqpBasePoint.from_power_flow(jdata)
    for k in ("pg", "qg", "vm", "va"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)


@pytest.fixture(scope="module")
def jax_state(case9_path):
    """A JAX solve's state after 3 outer iterations, and its model."""
    res = exaadmm_tpu.solve_acopf(case9_path, rho_pq=4e2, rho_va=4e4,
                                  outer_iterlim=3, verbose=0)
    return res, solution_to_numpy(res.solution)


def test_projection_matches_jax(case9_path, jax_state):
    jres, state = jax_state
    tdata = opf_loaddata(case9_path, verbose=0)
    got, ginfo = pf_projection(tdata, None, solution_from_numpy(state))
    ref, rinfo = jax_projection(jres.data, jres.model, _jax_solution(state))
    np.testing.assert_allclose(got.v.gen.numpy(), np.asarray(ref.v.gen),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.v.line.numpy(), np.asarray(ref.v.line),
                               rtol=0, atol=1e-12)
    assert ginfo["pf_iterations"] == rinfo["pf_iterations"]
    assert ginfo["pf_converged"]


def test_violations_match_jax(case9_path, jax_state):
    jres, state = jax_state
    from exaadmm_tpu_torch.models.acopf import model as TM
    from exaadmm_tpu_torch.utils.environment import Parameters
    tm = TM.build_model(opf_loaddata(case9_path, verbose=0),
                        Parameters(verbose=0))
    tsol = solution_from_numpy(state)
    got = compute_violations(tm.grid, tsol.u, tsol.v)
    jsol = _jax_solution(state)
    ref = jax_violations(jres.model.grid, jsol.u, jsol.v)
    assert set(got) == set(ref)
    assert got["num_rateA_viols"] == ref["num_rateA_viols"]
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-12 * max(abs(r), 1.0), k
    assert got["err_consensus"] > 0.0


@pytest.fixture(scope="module")
def projected(case9_path):
    return E.solve_acopf(case9_path, use_projection=True, device="cpu", **KW)


def test_case9_projection_pin(projected):
    info = projected.info
    assert info.status == "Solved"
    assert (info.outer, info.cumul) == (PIN_OUTER, PIN_CUMUL)
    assert abs(info.objval - PIN_OBJ) / PIN_OBJ < 1e-8
    assert abs(info.pf_residual - PIN_RES) <= 1e-6 * PIN_RES
    assert info.time_projection > 0.0
    assert projected.env.use_projection
    v = projected.solution.v.line.numpy()
    data = projected.data
    for b in range(data.nbus):
        ws = np.concatenate([v[data.line_from == b, 4],
                             v[data.line_to == b, 5]])
        assert np.ptp(ws) < 1e-12


def test_print_statistics(projected, capsys):
    print_statistics(projected.info, {"Note": "x"})
    out = capsys.readouterr().out
    assert "Status  . . . . . . . . . . . . . Solved" in out
    assert "Cumulative iterations . . . . . . 1087" in out
    assert "Power-flow residual" in out and "Projection time" in out
    assert out.splitlines()[-1].split() == ["Note", "x"]


def test_solve_from_env_reproduces(case9_path):
    first = E.solve_acopf(case9_path, rho_pq=4e2, rho_va=4e4, outer_iterlim=3,
                          use_linelimit=False, tight_factor=0.99, verbose=0,
                          device="cpu")
    again = E.solve_acopf_from_env(first.env, device="cpu")
    assert (again.info.outer, again.info.cumul) == (first.info.outer,
                                                    first.info.cumul)
    assert again.info.objval == first.info.objval
    assert again.env.use_linelimit is False
    assert again.env.tight_factor == 0.99


def test_mpacopf_projection_matches_jax(case9_path):
    kw = dict(end_period=3, outer_iterlim=2, warm_start=False,
              use_projection=True, verbose=0)
    got = E.solve_mpacopf(case9_path, DEMAND, device="cpu", **kw)
    ref = jax_mpacopf(case9_path, DEMAND, **kw)
    gv, rv = got.solution.acopf.v, ref.solution.acopf.v
    for t in range(3):
        np.testing.assert_allclose(gv.line[t].numpy(),
                                   np.asarray(rv.line[t]), rtol=0, atol=1e-8)
        np.testing.assert_allclose(gv.gen[t].numpy(), np.asarray(rv.gen[t]),
                                   rtol=0, atol=1e-8)
    # each period projected with its own loads: the slack outputs differ
    assert not np.allclose(gv.gen[0].numpy(), gv.gen[1].numpy())
    assert got.info.pf_residual <= 1e-6
    assert got.info.time_projection > 0.0


def test_qpsub_projection_matches_jax(case9_path):
    (_, tq), (_, jq) = _qp_inputs("case9")
    kw = dict(outer_iterlim=150, rho_pq=4e3, rho_va=4e3, scale=1e-4,
              use_projection=True, verbose=0)
    got = E.solve_qpsub(case9_path, *[tq[k] for k in QP_KEYS], 1e5,
                        device="cpu", **kw)
    ref = jax_qpsub(case9_path, *[jq[k] for k in QP_KEYS], 1e5, **kw)
    assert got.info.cumul == ref.info.cumul == 150
    gv, rv = got.solution.base.v, ref.solution.base.v
    np.testing.assert_allclose(gv.line.numpy(), np.asarray(rv.line), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(gv.gen.numpy(), np.asarray(rv.gen), rtol=0,
                               atol=1e-8)
    assert abs(got.info.pf_residual - ref.info.pf_residual) <= 1e-8
