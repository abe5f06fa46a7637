"""One-level ADMM drivers (used by the qpsub model): the host loop and the
fused (device-resident) one.

Counterpart of ``exaadmm_tpu/algorithms/admm_one_level.py`` (reference
admm_one_level.jl): the two-level machinery is off (z = lz = 0, one inner
iteration per outer), each iteration runs x -> xbar -> l += rho (u - v) ->
residual, and the solve stops when

    ||u - v|| <= sqrt(d) outer_eps   and   dualres <= outer_eps ||rho||

(admm_one_level.jl:65, with dualres = ||rho (v - v_prev)||, Boyd's
single-level dual residual).

``admm_one_level`` is the host loop: the condition is tested before each
iteration on scalars that start at inf, and each iteration reads back one
stacked tensor of (mismatch, dualres); it is the verbose path and the one a
gloo mesh on the card takes (``one_level_driver``). ``admm_one_level_fused``
is the JAX package's ``_one_level_while``: the whole solve as one loop on the
device, a CUDA graph with one conditional WHILE node around the captured
iteration (``ops/graph_loop.py``) on the card, the same iteration under a
host ``while`` on its flag tensor on the CPU; ``solve_prep`` stays outside
the loop, as JAX hoists it. The two give the same bits. ``make_one_level_solver``
builds the loop once for a model and reuses it for every solve of the same
shapes (each solve's constants go into the loop's static buffers). Under a
mesh (``parallel/sharding.py::run_sharded``) the fused solver runs on the
rank's local model and its iteration's two all-reduces go into the loop's
graph as NCCL work, JAX ``make_sharded_one_level``.
"""

from __future__ import annotations

import functools
import time

import torch

from ..ops import graph_loop
from ..parallel import sharding
from ..utils import tracing
from ..utils.environment import IterationInformation
from .carry import Carry


def admm_one_level(model, sol, info: IterationInformation | None = None):
    """Run one-level ADMM; returns (sol, info)."""
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dual_tol = outer_tol * model.rho_norm(sol) / sqrt_d

    sol = model.one_level_reset(sol)
    # the solve's loop-invariant QP constants, computed once
    model = model.solve_prep(sol)

    if par.verbose > 0:
        print(f"{'Iter':>8} {'Objval':>12} {'AugLag':>12} {'PrimRes':>10} "
              f"{'PrimTol':>10} {'DualRes':>10} {'DualTol':>10}")
    it = 0
    mismatch = dualres = float("inf")
    scalars = None
    t0 = time.perf_counter()
    while it < par.outer_iterlim and not (mismatch <= outer_tol
                                          and dualres <= dual_tol):
        it += 1
        sol, _ = model.update_x(sol, it)
        sol = model.update_xbar(sol)        # keeps v_prev
        sol = model.update_l_single(sol)
        sol, scalars = model.update_residual(sol, 0.0)
        mismatch, dualres = torch.stack(
            [scalars["mismatch"], scalars["dualres"]]).tolist()
        if par.verbose > 0 and (it % 50 == 1 or par.verbose > 1):
            objval, auglag, primres = torch.stack(
                [scalars[k] for k in ("objval", "auglag", "primres")]).tolist()
            print(f"{it:>8d} {objval:>12.5e} {auglag:>12.5e} "
                  f"{primres:>10.3e} {outer_tol:>10.3e} {dualres:>10.3e} "
                  f"{dual_tol:>10.3e}")
    info.time_overall = time.perf_counter() - t0

    info.outer = info.cumul = it
    info.inner = 1
    info.mismatch, info.dualres = mismatch, dualres
    if scalars is None:
        info.primres, info.objval, info.auglag = float("inf"), 0.0, 0.0
    else:
        info.primres, info.objval, info.auglag = torch.stack(
            [scalars[k] for k in ("primres", "objval", "auglag")]).tolist()
    converged = mismatch <= outer_tol and dualres <= dual_tol
    info.status = "Solved" if converged else "IterationLimit"
    return sol, info


# the carry's fp64 scalars, which start at inf (the rest at 0)
_FLOATS = ("primres", "dualres", "mismatch", "objval", "auglag")
_START_INF = ("primres", "dualres", "mismatch")


def one_level_carry(sol) -> Carry:
    """The fused loop's buffers for the (reset) state ``sol``: the state,
    the iteration count, the scalars, the dual tolerance and the loop's
    flag."""
    dev = sol.u.gen.device
    f64 = dict(dtype=torch.float64, device=dev)
    return Carry(sol, dict(
        {k: torch.zeros((), **f64) for k in _FLOATS + ("dual_tol",)},
        it=torch.zeros((), dtype=torch.int64, device=dev),
        flag=torch.zeros((), dtype=torch.int32, device=dev)))


def reset_one_level(c: Carry, sol, dual_tol: float) -> None:
    """The carry at the start of a solve from the (reset) state ``sol``
    (kernels only: nothing comes from the host's memory)."""
    c.load(sol)
    v = c.v
    v["it"].zero_()
    for k in _FLOATS:
        v[k].fill_(float("inf") if k in _START_INF else 0.0)
    v["dual_tol"].fill_(dual_tol)


def set_one_level_flag(c: Carry, outer_iterlim: int,
                       outer_tol: float) -> None:
    """flag = (it < outer_iterlim) & ~(mismatch <= outer_tol & dualres <=
    dual_tol): the host loop's condition, on the device."""
    v = c.v
    converged = (v["mismatch"] <= outer_tol) & (v["dualres"] <= v["dual_tol"])
    v["flag"].copy_((v["it"] < outer_iterlim) & ~converged)


def one_level_body(model, c: Carry, outer_tol: float) -> None:
    """One iteration of the fused loop on ``c`` (``model`` is the solve's,
    from ``solve_prep``), then its flag."""
    v = c.v
    it = v["it"] + 1
    s, _ = model.update_x(c.sol, it)
    s = model.update_xbar(s)        # keeps v_prev
    s = model.update_l_single(s)
    s, scalars = model.update_residual(s, 0.0)
    c.store(s)
    v["it"].copy_(it)
    for k in _FLOATS:
        v[k].copy_(scalars[k])
    set_one_level_flag(c, model.par.outer_iterlim, outer_tol)


class OneLevelSolver:
    """The one-level ADMM of one model as one device-resident loop
    (``make_one_level_solver``); call it as ``solver(sol, info, model) ->
    (sol, info)``.

    The solver runs the model its first call gives (by default the one it
    was made with; under a mesh, the rank's local model) and refuses a mesh
    whose collectives a graph cannot hold (``sharding.graph_capturable``).
    The first call builds the carry (``algorithms/carry.py``) for ``sol``'s
    shapes and, on the card, the loop graph (``ops/graph_loop.py``); later
    calls must match them and reuse both: the solve's constants of
    ``solve_prep`` (rho's) and the dual tolerance go into static buffers on
    every call, and the model's own tensors are read where they are. The
    call that builds puts its build time into ``info.time_build``; every
    call on the card puts the device memory the graph's body holds into
    ``info.graph_pool_bytes``.
    """

    def __init__(self, model):
        self.carry = self.loop = self.model = None
        self._bind(model)

    def _bind(self, model) -> None:
        sharding.require_capturable(model.grid.mesh, model.grid.pgmin.device,
                                    "admm_one_level")
        self.source = model

    def __call__(self, sol, info: IterationInformation, model=None):
        with tracing.span("loop.solve") as span:
            return self._solve(sol, info, model, span)

    def _solve(self, sol, info: IterationInformation, model, span):
        if model is not None and model is not self.source:
            if self.carry is not None:
                raise ValueError("a fused solver runs the model of its first "
                                 "call; this call gave another")
            self._bind(model)
        src, par = self.source, self.source.par
        sqrt_d = float(src.nvar) ** 0.5
        outer_tol = sqrt_d * par.outer_eps
        dual_tol = outer_tol * src.rho_norm(sol) / sqrt_d
        sol = src.one_level_reset(sol)
        # the solve's loop-invariant QP constants, computed once
        self.model = src.solve_prep(sol, self.model)
        built = self.carry is None
        if span is not None:
            span.attrs["built"] = built
        if built:
            t0 = time.perf_counter()
            with tracing.span("loop.build"):
                self._build(sol, dual_tol, outer_tol)
            info.time_build = time.perf_counter() - t0
        c, loop, model = self.carry, self.loop, self.model
        with graph_loop.no_syncs(c.state[0].device):
            with tracing.span("loop.reset"):
                reset_one_level(c, sol, dual_tol)
                set_one_level_flag(c, par.outer_iterlim, outer_tol)
            t0 = time.perf_counter()
            if loop is not None:
                loop.launch()
            else:
                graph_loop.run_on_host(
                    (lambda: one_level_body(model, c, outer_tol),),
                    (c.v["flag"],))
            # tensors of its own: the next solve overwrites the buffers
            with tracing.span("loop.clone"):
                sol = c.clone().sol
        out = c.read_back(("it",) + _FLOATS, loop)
        info.time_overall = time.perf_counter() - t0
        if loop is not None:
            info.graph_pool_bytes = loop.pool_bytes
        info.outer = info.cumul = int(out["it"])
        info.inner = 1
        for k in _FLOATS:
            setattr(info, k, out[k])
        converged = info.mismatch <= outer_tol and info.dualres <= dual_tol
        info.status = "Solved" if converged else "IterationLimit"
        if span is not None:
            span.attrs.update(tracing.solve_attrs(
                model.grid, sol.u.gen.dtype, info, loop))
        return sol, info

    def _build(self, sol, dual_tol: float, outer_tol: float):
        self.carry = c = one_level_carry(sol)
        if sol.u.gen.device.type != "cuda":
            return
        model = self.model
        reset_one_level(c, sol, dual_tol)
        w = c.clone()
        self.loop = graph_loop.GraphLoop(
            (lambda: one_level_body(model, c, outer_tol),), (c.v["flag"],),
            warmup=lambda: one_level_body(model, w, outer_tol))


def make_one_level_solver(model) -> OneLevelSolver:
    """The fused one-level solver of ``model`` (JAX ``_one_level_while``;
    under a mesh, called with the rank's local model, JAX
    ``make_sharded_one_level``); built at its first call, then reusable for
    any solve of the same shapes."""
    return OneLevelSolver(model)


def admm_one_level_fused(model, sol, info: IterationInformation | None = None,
                         run=None):
    """Run one-level ADMM as one device-resident loop; returns (sol, info)
    as ``admm_one_level`` does, bit-identical to it. ``run`` is a solver of
    ``make_one_level_solver`` to reuse (built here if None), which runs
    ``model``. ``info.time_overall`` is the time from the launch to the
    read-back; the build time before it is ``info.time_build``."""
    info = info or IterationInformation()
    if run is None:
        run = make_one_level_solver(model)
    return run(sol, info, model=model)


def one_level_driver(model, mesh=None):
    """The one-level driver a solve of ``model`` runs, as the JAX package's
    ``admm_one_level`` chooses: the fused loop at ``verbose == 0`` (with one
    solver for every call of the model), also under a ``mesh`` whose
    collectives the loop can hold (NCCL on the card, any backend on the
    CPU; JAX ``make_sharded_one_level``); the host loop at ``verbose > 0``,
    and for a gloo mesh on the card, whose host-staged collectives a CUDA
    graph cannot hold (``sharding.graph_capturable``)."""
    if model.par.verbose > 0 or not sharding.graph_capturable(
            mesh, model.grid.pgmin.device):
        return admm_one_level
    return functools.partial(admm_one_level_fused,
                             run=make_one_level_solver(model))
