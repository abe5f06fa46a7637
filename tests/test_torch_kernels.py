"""The port's closed-form ACOPF updates and bus scatter against the JAX ones.

Inputs come from numpy seeds (or the reference's golden case9 vectors) and
go to both packages as numpy arrays.

Tolerances:
- closed-form updates, fp64: relative 1e-12 of each array's largest
  magnitude. The updates are the same expressions; only the order of the
  bus sums (one pass over the stacked arcs here, a from-side and a to-side
  segment_sum there) and of the norms differs, which moves results by a few
  ulps, and the 2x2 bus solve amplifies that by its conditioning.
- golden V from golden U: 2e-6 absolute, as the JAX package's own test.
- plain bus scatter against the Pallas kernel in interpret mode (fp32, its
  3-term bf16 split): 5e-7 relative, the JAX package's own bound; against
  segment_sum in fp64: 1e-13 relative (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import kernels as JK
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.ops.bus_pallas import kr_scatter_pallas
from exaadmm_tpu.utils.environment import Blocks as JBlocks
from exaadmm_tpu.utils.environment import BranchALMState as JALM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.environment import Solution as JSolution
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu_torch.models.acopf import kernels as TK
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.ops import bus_cuda
from exaadmm_tpu_torch.utils.convert import (solution_from_numpy,
                                             solution_to_numpy)
from exaadmm_tpu_torch.utils.environment import Blocks, Parameters
from exaadmm_tpu_torch.utils.grid_data import build_csr
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

from .test_acopf_golden import U_BR, U_GEN, V_BR, V_GEN

BETA = 1e3
KEYS = ("u", "v", "l", "rho", "z", "z_prev", "lz", "rp", "rd")


def _close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def _jax_solution(d):
    blocks = {k: JBlocks(gen=jnp.asarray(d[k]["gen"]),
                         line=jnp.asarray(d[k]["line"])) for k in KEYS}
    alm = d["branch_alm"]
    return JSolution(**blocks, branch_alm=JALM(
        lam1=jnp.asarray(alm["lam1"]), lam2=jnp.asarray(alm["lam2"]),
        mu=jnp.asarray(alm["mu"])))


@pytest.fixture(scope="module")
def random_state():
    """case118 padded to a multiple of 4, with a random ADMM state (seed 0)."""
    from os.path import dirname, join
    path = join(dirname(dirname(__file__)), "data", "case118.m")
    jmodel = JM.build_model(jax_opf_loaddata(path, verbose=0),
                            JParameters(verbose=0), pad_lines_to=4)
    tmodel = TM.build_model(opf_loaddata(path, verbose=0),
                            Parameters(verbose=0), pad_lines_to=4)
    rng = np.random.default_rng(0)
    ngen, nl = tmodel.grid.ngen, tmodel.grid.nline_padded
    d = {}
    for k in KEYS:
        if k == "rho":
            d[k] = {"gen": rng.uniform(1e2, 1e5, (ngen, 2)),
                    "line": rng.uniform(1e2, 1e5, (nl, 8))}
        else:
            d[k] = {"gen": rng.normal(0, 1, (ngen, 2)),
                    "line": rng.normal(0, 1, (nl, 8))}
    d["branch_alm"] = {"lam1": rng.normal(0, 1, nl),
                       "lam2": rng.normal(0, 1, nl),
                       "mu": rng.uniform(10, 1e3, nl)}
    return dict(jmodel=jmodel, tmodel=tmodel, jsol=_jax_solution(d),
                tsol=solution_from_numpy(d))


def test_generator_update_matches_jax(random_state):
    jm, tm = random_state["jmodel"], random_state["tmodel"]
    js, ts = random_state["jsol"], random_state["tsol"]
    jg, tg = jm.grid, tm.grid
    ref = JK.generator_update(js.u.gen, js.v.gen, js.z.gen, js.l.gen,
                              js.rho.gen, jg.pgmin, jg.pgmax, jg.qgmin,
                              jg.qgmax, jm.c2_eff, jm.c1_eff, jg.baseMVA)
    got = TK.generator_update(ts.u.gen, ts.v.gen, ts.z.gen, ts.l.gen,
                              ts.rho.gen, tg.pgmin, tg.pgmax, tg.qgmin,
                              tg.qgmax, tm.c2_eff, tm.c1_eff, tg.baseMVA)
    _close(got.numpy(), ref)


def test_bus_update_matches_jax(random_state):
    js, ts = random_state["jsol"], random_state["tsol"]
    ref = JK.bus_update(js.u, js.z, js.l, js.rho, random_state["jmodel"].grid,
                        bus_backend="segsum")
    got = TK.bus_update(ts.u, ts.z, ts.l, ts.rho, random_state["tmodel"].grid)
    _close(got.gen.numpy(), ref.gen)
    _close(got.line.numpy(), ref.line)


def test_z_l_lz_updates_match_jax(random_state):
    js, ts = random_state["jsol"], random_state["tsol"]
    zj = JK.z_update(js.u, js.v, js.l, js.rho, js.lz, BETA)
    zt = TK.z_update(ts.u, ts.v, ts.l, ts.rho, ts.lz, BETA)
    lj, lt = JK.l_update(zj, js.lz, BETA), TK.l_update(zt, ts.lz, BETA)
    lzj = JK.lz_update(zj, js.lz, BETA, 1e12)
    lzt = TK.lz_update(zt, ts.lz, BETA, 1e12)
    for a, b in ((zt, zj), (lt, lj), (lzt, lzj)):
        _close(a.gen.numpy(), b.gen)
        _close(a.line.numpy(), b.line)


def test_residual_update_matches_jax(random_state):
    js, ts = random_state["jsol"], random_state["tsol"]
    jg, tg = random_state["jmodel"].grid, random_state["tmodel"].grid
    rpj, rdj, sj = JK.residual_update(js, jg, BETA)
    rpt, rdt, st = TK.residual_update(ts, tg, BETA)
    for a, b in ((rpt, rpj), (rdt, rdj)):
        _close(a.gen.numpy(), b.gen)
        _close(a.line.numpy(), b.line)
    for k in sj:
        _close(float(st[k]), float(sj[k]))
    _close(float(TK.compute_objval(ts.u.gen, tg.c2, tg.c1, tg.c0,
                                   tg.baseMVA)),
           float(JK.compute_objval(js.u.gen, jg.c2, jg.c1, jg.c0,
                                   jg.baseMVA)))


def test_hooks_match_jax_on_random_state(random_state):
    """The model hooks compose the kernels the same way in both packages."""
    jm, tm = random_state["jmodel"], random_state["tmodel"]
    js, ts = random_state["jsol"], random_state["tsol"]
    pairs = [
        (JM.update_xbar(jm, js), tm.update_xbar(ts)),
        (JM.update_z(jm, js, BETA), tm.update_z(ts, BETA)),
        (JM.update_l(jm, js, BETA), tm.update_l(ts, BETA)),
        (JM.update_lz(jm, js, BETA), tm.update_lz(ts, BETA)),
        (jm.inner_prestep(js), tm.inner_prestep(ts)),
    ]
    for jsol, tsol in pairs:
        a, b = solution_to_numpy(tsol), solution_to_numpy(jsol)
        for k in KEYS:
            _close(a[k]["gen"], b[k]["gen"])
            _close(a[k]["line"], b[k]["line"])


def test_closed_form_kernels_exact_from_golden_u(case9_path):
    """The reference's golden U through the bus update gives its golden V
    (isolates the bus update from the branch solver's termination)."""
    model = TM.build_model(opf_loaddata(case9_path, verbose=0),
                           Parameters(verbose=0, scale=1e-4))
    sol0 = TM.init_solution(model, 4e2, 4e4)
    u_gold = Blocks(gen=torch.as_tensor(U_GEN), line=torch.as_tensor(U_BR))
    v = TK.bus_update(u_gold, sol0.z, sol0.l, sol0.rho, model.grid)
    np.testing.assert_allclose(v.gen.numpy(), V_GEN, atol=2e-6)
    np.testing.assert_allclose(v.line.numpy(), V_BR, atol=2e-6)


def _scatter_inputs(dtype):
    rng = np.random.default_rng(3)
    N, NBUS, C = 3000, 2100, 8
    fr = rng.integers(0, NBUS, N).astype(np.int32)
    to = rng.integers(0, NBUS, N).astype(np.int32)
    vf = (rng.standard_normal((N, C)) * 1e3).astype(dtype)
    vt = (rng.standard_normal((N, C)) * 1e3).astype(dtype)
    ids = np.concatenate([fr, to]).astype(np.int64)
    ptr, idx = build_csr(ids, NBUS)
    got = bus_cuda.bus_scatter(torch.as_tensor(np.concatenate([vf, vt])),
                               torch.as_tensor(ids), torch.as_tensor(ptr),
                               torch.as_tensor(idx))
    return got.numpy(), fr, to, vf, vt, NBUS


def test_bus_scatter_plain_matches_pallas_interpret_fp32():
    got, fr, to, vf, vt, nbus = _scatter_inputs(np.float32)
    ref = np.asarray(kr_scatter_pallas(jnp.asarray(vf), jnp.asarray(vt),
                                       jnp.asarray(fr), jnp.asarray(to),
                                       nbus=nbus, interpret=True))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 5e-7, rel


def test_bus_scatter_plain_matches_segment_sum_fp64():
    got, fr, to, vf, vt, nbus = _scatter_inputs(np.float64)
    ref = np.asarray(
        jax.ops.segment_sum(jnp.asarray(vf), jnp.asarray(fr), nbus)
        + jax.ops.segment_sum(jnp.asarray(vt), jnp.asarray(to), nbus))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-13, rel
