"""The branch update's pack and unpack (``exaadmm_tpu_torch/ops/
branch_cuda.py``) on the CPU, where the wrappers run their plain versions:
against the plain functions, against the branch update's code before it was
split in two, against the JAX branch update; their refusals; and every
caller of ``branch_update`` going through them.

Inputs: case9, and a synthetic case of 300 buses (seed 3) in both
packages, lines padded to a multiple of 8 (inactive lanes), with u, the
prox targets and the ALM state drawn from a numpy seed; the batch's result
for the unpack drawn from a numpy seed too (the unpack does not care how it
was solved), so no TRON solve runs in the unpack tests.

Tolerances:
- a wrapper on CPU tensors against its plain version, and the plain
  versions against the code they replace: bit for bit (the same torch ops
  on the same values);
- the pack against the JAX warm start, parameters and ALM start, fp64: bit
  for bit (clamps, square roots and differences, exact in both);
- ``branch_update`` against the JAX ``branch_update``, case9 fp64: both run
  the same TRON/ALM lockstep, whose sin/cos/pow round differently by ulps
  in the two packages (``tests/test_torch_tron.py``): equal iteration
  counts on every lane, so equal stats sums, and the line rows and ALM
  state within 1e-8 of their magnitude;
- the stats' sums of integer values: exactly the int64 sums.
"""

import numpy as np
import pytest
import torch

from exaadmm_tpu.models.acopf import branch as JB
from exaadmm_tpu.models.acopf import model as JM
from exaadmm_tpu.utils.environment import BranchALMState as JALM
from exaadmm_tpu.utils.environment import Parameters as JParameters
from exaadmm_tpu.utils.opfdata import opf_loaddata as jax_opf_loaddata
from exaadmm_tpu.utils.synthetic import synthetic_case as jax_synthetic_case
import jax.numpy as jnp

from exaadmm_tpu_torch.algorithms import admm_two_level as two
from exaadmm_tpu_torch.models.acopf import branch as TB
from exaadmm_tpu_torch.models.acopf import model as TM
from exaadmm_tpu_torch.models.mpacopf import model as MP
from exaadmm_tpu_torch.ops import bounds, branch_cuda, tron_cuda
from exaadmm_tpu_torch.ops.tron import TronALMResult
from exaadmm_tpu_torch.utils.environment import BranchALMState, Parameters
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
from exaadmm_tpu_torch.utils.synthetic import synthetic_case

from .test_torch_threads import one_torch_thread  # noqa: F401

TYPES = {"f64": (torch.float64, False), "f32": (torch.float32, False),
         "mixed": (torch.float64, True)}


def _data(case, case9_path):
    if case == "case9":
        return (opf_loaddata(case9_path, verbose=0),
                jax_opf_loaddata(case9_path, verbose=0))
    return synthetic_case(300, seed=3), jax_synthetic_case(300, seed=3)


def _draws(B, seed=0):
    """Numpy draws of the perturbed line state: u, the prox targets' v and
    z, l, and the ALM state."""
    rng = np.random.default_rng(seed)
    return dict(u=rng.normal(0, 0.5, (B, 8)), v=rng.normal(0, 0.05, (B, 8)),
                z=rng.normal(0, 0.1, (B, 8)), l=rng.normal(0, 3.0, (B, 8)),
                lam1=rng.normal(0, 1, B), lam2=rng.normal(0, 1, B),
                mu=rng.uniform(10, 1e3, B))


def _tstate(model, d):
    """The port's flat start with the draws added (u shifted so some of
    its squared magnitudes are negative, so the warm start's clamps bind)."""
    sol = TM.init_solution(model, 4e2, 4e4)
    dt = sol.u.line.dtype

    def t(a):
        return torch.as_tensor(a, dtype=dt)

    u = sol.u.line + t(d["u"])
    u[:, 4:6] -= 0.6
    return sol.replace(
        u=sol.u.replace(line=u), v=sol.v.replace(line=sol.v.line + t(d["v"])),
        z=sol.z.replace(line=t(d["z"])), l=sol.l.replace(line=t(d["l"])),
        branch_alm=BranchALMState(lam1=t(d["lam1"]), lam2=t(d["lam2"]),
                                  mu=t(d["mu"])))


@pytest.fixture(scope="module", params=["case9", "synth300"])
def models(request, case9_path):
    """(case, the port's data, JAX's data) of one case."""
    tdata, jdata = _data(request.param, case9_path)
    return request.param, tdata, jdata


def _model(tdata, types, use_linelimit=True):
    dtype, mixed = TYPES[types]
    par = Parameters(verbose=0, mixed_precision=mixed, scale=3e-4)
    model = TM.build_model(tdata, par, use_linelimit=use_linelimit,
                           pad_lines_to=8, dtype=dtype)
    solve = torch.float32 if mixed else dtype
    return model, par, solve


def _old_inputs(sol, gd, par, it, use_linelimit, solve):
    """The branch update's inputs as it built them before the pack: the
    batch of ``branch_inputs`` / ``polar_inputs``, cast down under mixed
    precision, the parameter block of ``tron_cuda.pack_params``."""
    if use_linelimit:
        *batch, act = TB.branch_inputs(sol, gd, par, it)
    else:
        *batch, act = TB.polar_inputs(sol, gd, par)
    if solve != sol.u.line.dtype:
        batch = TB.cast_down(*batch)
    x0, xl, xu, params, lam0, mu0 = batch
    return (x0, xl, xu, tron_cuda.pack_params(params), lam0, mu0,
            act.to(torch.uint8))


def _random_result(B, n, ncon, dtype, seed=1):
    """A batch result drawn from a numpy seed: x near a flat start,
    multipliers, penalties, violations and iteration counts."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(a).to(dt)

    x = np.concatenate([rng.uniform(0.9, 1.1, (2, B)),
                        rng.uniform(-0.5, 0.5, (2, B)),
                        rng.uniform(-5, 0, (n - 4, B))])
    return TronALMResult(
        x=t(x), lam=t(rng.normal(0, 10, (ncon, B))),
        mu=t(rng.uniform(10, 1e6, B)),
        minor_iters=t(rng.integers(0, 200, B), torch.int32),
        alm_iters=t(rng.integers(1, 50, B), torch.int32),
        cviol=t(rng.uniform(0, 1e-3, B)))


def _old_epilogue(res, sol, gd, active0, use_linelimit, out_dtype):
    """The branch update after the solve as it was before the unpack: cast
    up, flows, the masked writeback, the stats (averages over nline) and
    the lane steps."""
    if res.x.dtype != out_dtype:
        res = TB.cast_up(res, out_dtype)
    new_alm = (BranchALMState(lam1=res.lam[0], lam2=res.lam[1], mu=res.mu)
               if use_linelimit else sol.branch_alm)
    p = {k: getattr(gd, k) for k in TB.Y_KEYS}
    pij, qij, pji, qji = TB._flows(res.x, p)
    vi, vj = res.x[0], res.x[1]
    u_new = torch.stack([pij, qij, pji, qji, vi * vi, vj * vj,
                         res.x[2], res.x[3]], dim=-1)
    u_new = torch.where(active0[:, None], u_new, sol.u.line)
    m = gd.line_mask
    sums = [torch.sum(res.alm_iters * m), torch.sum(res.minor_iters * m)]
    max_cv = torch.amax(torch.where(active0, res.cviol,
                                    torch.zeros_like(res.cviol)))
    steps = (res.minor_iters + res.alm_iters) * m.to(res.minor_iters.dtype)
    return u_new, new_alm, steps, torch.stack(
        [sums[0], sums[1], max_cv, sums[0] / gd.nline, sums[1] / gd.nline])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _flat(out):
    u_new, alm, steps, stats = out
    return [u_new, alm.lam1, alm.lam2, alm.mu, steps, stats]


@pytest.mark.parametrize("it", [1, 2, "tensor"])
@pytest.mark.parametrize("types", ["f64", "f32", "mixed"])
@pytest.mark.parametrize("use_linelimit", [True, False],
                         ids=["linelimit", "polar"])
def test_wrappers_on_cpu_are_the_plain_versions(models, use_linelimit, types,
                                                it):
    """The pack and unpack wrappers on CPU tensors are their plain
    versions, bit for bit, and those are the branch update's code before
    the split; the stats' sums are the exact integer sums."""
    _, tdata, _ = models
    model, par, solve = _model(tdata, types, use_linelimit)
    gd = model.grid
    sol = _tstate(model, _draws(gd.nline_padded))
    if it == "tensor":
        it = torch.tensor(3)
    args = (sol, gd, par, it, use_linelimit, solve)
    got = branch_cuda.branch_pack(*args)
    ref = TB.branch_pack_plain(*args)
    old = _old_inputs(*args)
    assert len(got) == len(ref) == len(old) == 7
    for a, b, c in zip(got, ref, old):
        assert _same(a, b) and _same(a, c)
    assert got[-1].dtype == torch.uint8
    assert int(got[-1].sum()) == gd.nline   # the padded lanes are inactive

    n, ncon = (6, 2) if use_linelimit else (4, 0)
    B = gd.nline_padded
    res = _random_result(B, n, ncon, solve)
    act = got[-1]
    out_dtype = sol.u.line.dtype
    uargs = (res, sol, gd, act, use_linelimit, out_dtype)
    got = _flat(branch_cuda.branch_unpack(*uargs))
    ref = _flat(TB.branch_unpack_plain(*uargs))
    old = _flat(_old_epilogue(res, sol, gd, act != 0, use_linelimit,
                              out_dtype))
    for a, b, c in zip(got, ref, old):
        assert _same(a, b) and _same(a, c)
    assert got[0].dtype == got[3].dtype == got[5].dtype == out_dtype
    mask = gd.line_mask.numpy() > 0.5
    sums = [int(res.alm_iters.numpy().astype(np.int64)[mask].sum()),
            int(res.minor_iters.numpy().astype(np.int64)[mask].sum())]
    assert [float(x) for x in got[5][:2]] == sums
    assert [k for k in branch_cuda.STATS][:2] == ["sum_auglag_it",
                                                  "sum_minor_it"]


def _jax_state(jmodel, d):
    """JAX's flat start with the same draws as ``_tstate``."""
    jsol = JM.init_solution(jmodel, 4e2, 4e4)
    u = jsol.u.line + jnp.asarray(d["u"])
    u = u.at[:, 4:6].add(-0.6)
    return jsol.replace(
        u=jsol.u.replace(line=u),
        v=jsol.v.replace(line=jsol.v.line + jnp.asarray(d["v"])),
        z=jsol.z.replace(line=jnp.asarray(d["z"])),
        l=jsol.l.replace(line=jnp.asarray(d["l"])),
        branch_alm=JALM(lam1=jnp.asarray(d["lam1"]),
                        lam2=jnp.asarray(d["lam2"]),
                        mu=jnp.asarray(d["mu"])))


def _both(models, use_linelimit):
    _, tdata, jdata = models
    model, par, _ = _model(tdata, "f64", use_linelimit)
    jpar = JParameters(verbose=0, scale=3e-4)
    jmodel = JM.build_model(jdata, jpar, use_linelimit=use_linelimit,
                            pad_lines_to=8)
    d = _draws(model.grid.nline_padded)
    return model, par, _tstate(model, d), jmodel, jpar, _jax_state(jmodel,
                                                                   d)


@pytest.mark.parametrize("it", [1, 3])
@pytest.mark.parametrize("use_linelimit", [True, False],
                         ids=["linelimit", "polar"])
def test_pack_matches_jax(models, use_linelimit, it):
    """The pack's x0, xl, xu, parameters, lam0 and mu0 against the JAX
    warm start (``_warm_start_x0``), ``_branch_params`` and ALM start, bit
    for bit."""
    model, par, tsol, jmodel, jpar, jsol = _both(models, use_linelimit)
    x0, xl, xu, P, lam0, mu0, act = branch_cuda.branch_pack(
        tsol, model.grid, par, it, use_linelimit, torch.float64)
    jx0, jxl, jxu = JB._warm_start_x0(jsol.u.line, jmodel.grid,
                                      use_linelimit)
    jp = JB._branch_params(jsol, jmodel.grid, jpar)
    for a, b in ((x0, jx0), (xl, jxl), (xu, jxu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    params = tron_cuda.params_view(P)
    for k in jp:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jp[k]))
    alm = jsol.branch_alm
    if use_linelimit:
        jmu0 = jnp.where(it == 1, jnp.full_like(alm.mu, 10.0), alm.mu)
        np.testing.assert_array_equal(lam0.numpy(), np.stack(
            [np.asarray(alm.lam1), np.asarray(alm.lam2)]))
    else:
        jmu0 = jnp.full_like(alm.mu, 10.0)
        assert lam0.shape == (0, model.grid.nline_padded)
    np.testing.assert_array_equal(mu0.numpy(), np.asarray(jmu0))
    np.testing.assert_array_equal(act.numpy(), np.asarray(
        jmodel.grid.line_mask > 0.5))


@pytest.mark.parametrize("use_linelimit", [True, False],
                         ids=["linelimit", "polar"])
def test_branch_update_matches_jax(case9_path, use_linelimit):
    """The whole x update of the lines, case9 fp64, at inner iteration 2
    (the multipliers and penalties from the state)."""
    tdata, jdata = _data("case9", case9_path)
    model, par, _ = _model(tdata, "f64", use_linelimit)
    jpar = JParameters(verbose=0, scale=3e-4)
    jmodel = JM.build_model(jdata, jpar, use_linelimit=use_linelimit,
                            pad_lines_to=8)
    d = _draws(model.grid.nline_padded)
    d["u"] *= 0.05   # a state the solver starts near
    tsol, jsol = _tstate(model, d), _jax_state(jmodel, d)
    u_t, alm_t, st_t = TB.branch_update(tsol, model.grid, par, 2,
                                        use_linelimit)
    u_j, alm_j, st_j = JB.branch_update(jsol, jmodel.grid, jpar, 2,
                                        use_linelimit)

    def close(a, b, rel=1e-8):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rel * max(float(np.abs(b).max()), 1))

    close(u_t, u_j)
    for k in ("lam1", "lam2", "mu"):
        close(getattr(alm_t, k), getattr(alm_j, k), 1e-7)
    for k in ("avg_auglag_it", "avg_minor_it"):
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]),
                                   rtol=1e-15)
    np.testing.assert_array_equal(st_t["lane_steps"].numpy(),
                                  np.asarray(st_j["lane_steps"]))
    assert abs(float(st_t["max_cviol"]) - float(st_j["max_cviol"])) <= 1e-9


@pytest.mark.parametrize("bad", ["meta", "float16"])
def test_wrappers_refuse_and_run_no_plain_version(bad, monkeypatch):
    """A state on another device than the CPU or the card, or of another
    dtype than float32/float64, raises before any plain version runs."""
    def never(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(TB, "branch_pack_plain", never)
    monkeypatch.setattr(TB, "branch_unpack_plain", never)
    if bad == "meta":
        kw, err = dict(device="meta", dtype=torch.float64), ValueError
    else:
        kw, err = dict(dtype=torch.float16), TypeError
    from types import SimpleNamespace
    B = 4
    blk = SimpleNamespace(line=torch.ones((B, 8), **kw))
    col = torch.ones(B, **kw)
    sol = SimpleNamespace(u=blk, v=blk, z=blk, l=blk, rho=blk,
                          branch_alm=BranchALMState(lam1=col, lam2=col,
                                                    mu=col))
    pair = torch.ones((B, 2), **kw)
    gd = SimpleNamespace(**{k: col for k in TB.Y_KEYS}, rate_a=col,
                         line_mask=col, fr_vm_bound=pair, to_vm_bound=pair,
                         fr_va_bound=pair, to_va_bound=pair, nline=B)
    with pytest.raises(err):
        branch_cuda.branch_pack(sol, gd, Parameters(verbose=0), 1, True,
                                kw["dtype"])
    res = _random_result(B, 6, 2, torch.float64)
    if bad == "meta":
        res = TronALMResult(*[t.to("meta") for t in res])
    with pytest.raises(err):
        branch_cuda.branch_unpack(res, sol, gd,
                                  torch.ones(B, dtype=torch.uint8), True,
                                  kw["dtype"])


def test_kernel_input_checks():
    """What the kernels take, checked as on the card: a strided input, a
    wrong dtype or shape, a mixed device; an inner iteration that is not
    an int or a 0-d int64 tensor; the type pairs of the entry points."""
    ok = torch.ones((4, 8), dtype=torch.float64)
    col = torch.ones(4, dtype=torch.float64)
    branch_cuda.validate("ok", [("u", ok, (4, 8), torch.float64),
                                ("m", col, (4,), torch.float64)])
    with pytest.raises(ValueError, match="strided"):
        branch_cuda.validate("t", [("u", torch.ones((8, 4)).double().t(),
                                    (4, 8), torch.float64)])
    with pytest.raises(ValueError, match="contiguous"):
        branch_cuda.validate("t", [("u", ok, (4, 8), torch.float64),
                                   ("m", col.float(), (4,), torch.float64)])
    with pytest.raises(ValueError, match="shape"):
        branch_cuda.validate("t", [("u", ok, (5, 8), torch.float64)])
    with pytest.raises(ValueError, match="0-d int64"):
        branch_cuda._iteration(torch.tensor(2, dtype=torch.int32),
                               ok.device)
    with pytest.raises(ValueError, match="0-d int64"):
        branch_cuda._iteration(torch.tensor([2]), ok.device)
    assert branch_cuda._iteration(3, ok.device) == (None, 3)
    assert branch_cuda._types("t", torch.float64, torch.float32) == "mixed"
    with pytest.raises(TypeError):
        branch_cuda._types("t", torch.float32, torch.float64)


def _counting(monkeypatch):
    """Patch the wrappers' route so every call counts and holds its inputs
    to the kernels' rules, as on the card."""
    calls = {}
    route = branch_cuda._route

    def counted(what, inputs):
        calls[what] = calls.get(what, 0) + 1
        branch_cuda.validate(what, inputs)
        return route(what, inputs)

    monkeypatch.setattr(branch_cuda, "_route", counted)
    return calls


@pytest.mark.parametrize("path", ["fused", "host", "sorted", "mixed",
                                  "polar", "mpacopf", "mpec"])
def test_branch_update_goes_through_the_wrappers(case9_path, monkeypatch,
                                                 path):
    """Every caller of ``branch_update`` (``ModelAcopf`` on the fused and
    host loops, sorted lines, mixed precision and without line limits;
    ``ModelMpacopf``'s T-period batch; MPEC's line block) calls the pack
    and the unpack once an inner iteration, each with inputs the kernels
    take; the stats' sums stay integers."""
    import exaadmm_tpu_torch as E

    calls = _counting(monkeypatch)
    sums = []
    update = TB.branch_update

    def recorded(*a, **k):
        out = update(*a, **k)
        sums.append([float(out[2][k]) * a[1].nline
                     for k in ("avg_auglag_it", "avg_minor_it")])
        return out

    for mod in (TM, MP):
        monkeypatch.setattr(mod, "branch_update", recorded)
    from exaadmm_tpu_torch.models.mpec import model as MM
    monkeypatch.setattr(MM, "branch_update", recorded)
    kw = dict(rho_pq=4e2, rho_va=4e4, outer_iterlim=2, inner_iterlim=15,
              outer_eps=2e-5, verbose=0, device="cpu")
    if path == "mpacopf":
        info = E.solve_mpacopf(case9_path, case9_path[:-2] + "_demand",
                               end_period=3, warm_start=False, **kw).info
    elif path == "mpec":
        info = E.solve_acopf_mpec(case9_path, **kw).info
    elif path in ("fused", "polar", "mixed"):
        info = E.solve_acopf(case9_path, use_linelimit=path != "polar",
                             mixed_precision=path == "mixed", **kw).info
    else:
        par = Parameters(verbose=0, outer_iterlim=2, inner_iterlim=15,
                         outer_eps=2e-5, sort_lines=path == "sorted")
        model = TM.build_model(opf_loaddata(case9_path, verbose=0), par)
        sol = TM.init_solution(model, 4e2, 4e4)
        driver = (two.admm_two_level if path == "host"
                  else two.two_level_driver(model))
        _, info = driver(model, sol)
    n = info.cumul
    assert n > 0
    assert calls == {"branch_pack": n, "branch_unpack": n}
    assert len(sums) == n
    assert all(abs(s - round(s)) <= 1e-9 * max(s, 1) for pair in sums
               for s in pair)


def test_branch_io_bounds_at_synth_9241():
    """The pack moves 921 B a lane at fp64 with line limits (61 values
    read: five state rows of 8, the ALM state, 8 admittances, 4 bound
    pairs, rate_a, the mask; 54 values and a flag written), 14.5 MB at
    15,710 lines, a 4.3 us bound; the polar pack 793 B; the unpack reads
    x's four angle and voltage rows, not the slacks; the mixed entries
    write the solve's values in fp32."""
    B = 15710
    assert bounds.branch_io_bytes("branch_pack", 1, 6, 8)["total"] == 921
    assert bounds.branch_io_bytes("branch_pack", 1, 4, 8)["total"] == 793
    pack = bounds.branch_io_bytes("branch_pack", B, 6, 8)
    assert pack["total"] == 921 * B == 14_468_910
    ms, by = bounds.bound(pack["total"],
                          bounds.branch_io_ops("branch_pack", B, 6))
    assert by == "bytes" and ms == pytest.approx(14_468_910 / 3.35e9)
    mixed = bounds.branch_io_bytes("branch_pack", 1, 6, 8, mixed=True)
    assert mixed["total"] == 61 * 8 + 54 * 4 + 1
    unpack = bounds.branch_io_bytes("branch_unpack", B, 6, 8)
    assert unpack["read"] == B * (9 * 8 + 5 * 8 + 9)
    more = bounds.branch_io_bytes("branch_unpack", B, 6, 8, inactive=2)
    assert more["total"] - unpack["total"] == 2 * 64
    stats = bounds.branch_io_bytes("branch_stats", B, 6, 8)
    assert stats == {"read": 3 * 62 * 8, "write": 40, "total": 1528}
