"""Two-level ADMM drivers: the host loop and the fused (device-resident) one.

Counterparts of ``admm_two_level`` and of ``make_fused_solver`` /
``admm_two_level_fused`` in ``exaadmm_tpu/algorithms/admm_two_level.py``.
Reference: admm_two_level.jl.

Inner iteration order (admm_two_level.jl:34-63):
    z_prev <- z;  x;  xbar;  z;  l;  residual
with the adaptive inner tolerance eps_pri = sqrt(nvar)/(2500*outer) and a
break when primres <= eps_pri. Outer: converged when ||u - v|| <=
sqrt(nvar)*outer_eps; otherwise lz <- clamp(lz + beta z) and beta <-
min(inc_c*beta, cap) when ||z|| > theta*||z_prev||.

``admm_two_level`` is the host loop: it launches every hook and reads
primres back once per inner iteration (and the outer scalars once per outer
iteration). It is the verbose path, and the one the ``time_hooks`` runs and
a gloo mesh on the card take (``two_level_driver``).

``admm_two_level_fused`` runs the whole solve as one device program, as the
JAX package's fused driver does with an outer ``lax.while_loop`` around the
inner one: on the card ``make_fused_solver``'s ``FusedSolver`` captures the
outer prestep, the inner iteration and the outer tail (solved; lz taken by
``where(solved, sol, update_lz(sol, beta))``; beta escalated) as CUDA graphs
and runs them in one graph with nested conditional WHILE nodes
(``ops/graph_loop.py``): one launch, no synchronization inside it, one
stacked read-back of the scalars at the end. The bodies run the same hooks in
the same order with the same break conditions on the same values, so the
result is bit-identical to the host loop's. On the CPU the same bodies run
under host ``while`` loops on the flag tensors. The solver is built at its
first call and reused: a rolling horizon or a multi-period warm start copies
its loads and pg bounds into its static buffers, as JAX passes them to one
compiled program.

With ``Parameters.time_hooks`` the host loop fills the ``time_*_update``
fields of ``IterationInformation`` (the JAX package's ``verbose >= 2``
stepping): it synchronizes the device after every hook, so the times are the
hooks' and the loop is slower. With it off (the default) the loop makes no
extra call.

With tracing on (``utils/tracing.py``) a fused solve is a ``loop.solve``
span over its phases, which carries the solve's record; a solver built
while tracing is on also counts the line batch's TRON steps in its carry
(``tron_steps``: the branch stats kernel adds to it in every inner
iteration), read back with the other scalars. A graph captured with
tracing off or on has the same nodes.

With ``Parameters.sort_lines`` and a model that ``supports_line_sort``,
each outer round starts by sorting the line batch by the lanes' effort in
the last inner iteration (``lane_steps``, stable ascending, as the JAX
package's ``_sorted_inner_while``): the hooks then run on the caller's
model with its lines in the composed order (the model knows which of its
arrays are indexed by line), and the state is permuted with it. The sort
reads nothing back, and the solution is put back into canonical order
before it is returned. The host loop skips the first round, whose steps
are all 0, and runs each round on ``model.with_line_order(ids)``; the fused
loop sorts every round (a stable sort of zeros is the identity, as in JAX)
into static buffers: the composed order ``line_ids``, the last iteration's
``lane_steps`` and a grid whose line arrays and arc CSR are those of
``model.with_line_order(line_ids)``, which its bodies' model reads.

With the lines split across ranks (``parallel/sharding.py``) every rank runs
the driver over its own model (``run_sharded`` hands it the rank's local
model); the scalars that decide a break derive from all-reduced tensors and
replicated data, so every rank breaks on the same iteration. On the card
the fused loop's bodies capture the collectives as NCCL work into the
loop's graph; gloo's host-staged collectives cannot be captured, so a gloo
mesh on the card runs the host loop. A rank sorts its own line window, with
no communication.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time

import torch

from ..ops import graph_loop
from ..parallel import sharding
from ..utils import tracing
from ..utils.environment import (IterationInformation, Solution,
                                 permute_solution_lines)
from ..utils.grid_data import LINE_FIELDS
from .carry import Carry


def _beta_cap(dtype) -> float:
    """Ceiling of the outer penalty beta.

    The reference caps beta at 1e24 (admm_two_level.jl:75), which no fp64
    schedule reaches. In a narrower dtype an uncapped beta ratchets up
    whenever ||z|| stalls and then wrecks the z/l/lz updates, so it is capped
    at 0.1/eps, the rule the branch ALM's mu_max follows too."""
    eps = torch.finfo(dtype).eps
    if eps <= torch.finfo(torch.float64).eps:
        return 1e24
    return 0.1 / float(eps)


def _call(name, fn, *args, **kwargs):
    return fn(*args, **kwargs)


def _timed_call(info: IterationInformation, dev):
    """``_call`` that adds the hook's seconds, device work included, to
    ``info.time_<name>_update``."""
    def call(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        field = f"time_{name}_update"
        setattr(info, field, getattr(info, field) + time.perf_counter() - t0)
        return out
    return call


def admm_two_level(model, sol: Solution,
                   info: IterationInformation | None = None, Pd=None, Qd=None):
    """Run the two-level ADMM; returns (sol, info).

    ``Pd``/``Qd`` replace the grid's loads for this call (a rolling horizon
    re-solves one model period by period with them, setting the model's
    ``pgmin_curr``/``pgmax_curr`` between calls). beta starts at
    ``initial_beta`` on every call."""
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dtype = sol.u.gen.dtype
    call = _timed_call(info, sol.u.gen.device) if par.time_hooks else _call
    sorting = getattr(model, "supports_line_sort", False) and par.sort_lines
    model0 = model
    # position -> canonical line id of the current order (None: canonical)
    line_ids = None

    beta = min(par.initial_beta, _beta_cap(dtype))
    info.status = "IterationLimit"
    info.norm_z_curr = info.norm_z_prev = float("inf")

    if par.verbose > 0:
        print(f"{'Outer':>6} {'Inner':>6} {'Objval':>12} {'AugLag':>12} "
              f"{'PrimRes':>10} {'EpsPrim':>10} {'DualRes':>10} {'||z||':>10} "
              f"{'Mismatch':>10} {'OuterTol':>10} {'Beta':>10}")

    t0 = time.perf_counter()
    stats = None
    while info.outer < par.outer_iterlim:
        info.outer += 1
        info.norm_z_prev = info.norm_z_curr  # outer prestep: save ||z||
        eps_pri = sqrt_d / (2500.0 * info.outer)

        if sorting and stats is not None:
            # the first round's lane_steps would be all 0: the identity
            reorder = torch.argsort(stats["lane_steps"], stable=True)
            line_ids = reorder if line_ids is None else line_ids[reorder]
            model = model0.with_line_order(line_ids)
            sol = permute_solution_lines(sol, reorder)

        inner = 0
        scalars = stats = None
        while inner < par.inner_iterlim:
            sol = model.inner_prestep(sol)
            inner += 1
            sol, stats = call("x", model.update_x, sol, inner)
            sol = call("xbar", model.update_xbar, sol, Pd=Pd, Qd=Qd)
            sol = call("z", model.update_z, sol, beta)
            sol = call("l", model.update_l, sol, beta)
            sol, scalars = model.update_residual(sol, beta)
            if not float(scalars["primres"]) > eps_pri:
                break

        info.inner = inner
        info.cumul += inner
        vals = torch.stack([scalars[k] for k in (
            "primres", "dualres", "norm_z_curr", "mismatch", "objval",
            "auglag")] + [stats["max_cviol"].to(dtype)]).tolist()
        (info.primres, info.dualres, info.norm_z_curr, info.mismatch,
         info.objval, info.auglag, info.max_cviol) = vals
        info.eps_pri = eps_pri

        if par.verbose > 0:
            print(f"{info.outer:>6d} {info.inner:>6d} {info.objval:>12.5e} "
                  f"{info.auglag:>12.5e} {info.primres:>10.3e} "
                  f"{info.eps_pri:>10.3e} {info.dualres:>10.3e} "
                  f"{info.norm_z_curr:>10.3e} {info.mismatch:>10.3e} "
                  f"{outer_tol:>10.3e} {beta:>10.3e}")

        if info.mismatch <= outer_tol:
            info.status = "Solved"
            break

        sol = call("lz", model.update_lz, sol, beta)
        if info.norm_z_curr > par.theta * info.norm_z_prev:
            beta = min(par.inc_c * beta, _beta_cap(dtype))

    if line_ids is not None:
        sol = permute_solution_lines(sol, torch.argsort(line_ids))
    info.time_overall = time.perf_counter() - t0
    par.beta = beta
    return sol, info


# the carry's 0-d scalars in fp64 (the host loop's Python floats hold the
# same values exactly) and what the solve reads back at its end
_FLOATS = ("beta", "norm_z", "norm_z_prev", "mismatch", "primres",
           "dualres", "objval", "auglag", "max_cviol")
_COUNTERS = ("outer", "inner", "cumul")
_START_INF = ("norm_z", "norm_z_prev", "mismatch", "primres", "dualres")
# the residual's scalar names, by carry name
_RESIDUAL = {"primres": "primres", "dualres": "dualres",
             "norm_z": "norm_z_curr", "mismatch": "mismatch",
             "objval": "objval", "auglag": "auglag"}


class FusedSolver:
    """The two-level ADMM of one model as one device-resident loop
    (``make_fused_solver``); call it as ``solver(sol, info, Pd, Qd,
    pgmin_curr, pgmax_curr, model) -> (sol, info)``.

    The solver runs the model its first call gives (``model``; by default
    the one it was made with): under a mesh ``run_sharded`` calls it with
    the rank's ``local_model``, whose grid's collectives then go into the
    loop. ``sqrt(nvar)``, which scales the tolerances, is the model's it
    was made with, the whole grid's (a local grid keeps the global line
    count, so the two agree). The first call builds the carry
    (``algorithms/carry.py``) for ``sol``'s shapes and, on the card, the
    loop graph (``ops/graph_loop.py``); later calls must match them and run
    the same model. ``Pd``/``Qd`` given at the first call get static
    buffers, refilled on every call (None keeps the model's own loads); so
    do the pg bounds of a model that has ``pgmin_curr``. The call that
    builds puts its build time (the carry, and on the card the graph's
    warm-up, capture and instantiation) into ``info.time_build``; every
    call on the card puts the device memory the graph's bodies hold into
    ``info.graph_pool_bytes``.

    It refuses a model whose lines are split over a mesh that a graph
    cannot hold (``sharding.graph_capturable``: gloo on CUDA tensors).
    """

    def __init__(self, model, par=None):
        self.own_par = par is None
        self.par = par or model.par
        self.sqrt_d = float(model.nvar) ** 0.5
        self.outer_tol = self.sqrt_d * self.par.outer_eps
        self.carry = self.loop = None
        self._bind(model)

    def _bind(self, model) -> None:
        """Run ``model`` (its grid's mesh checked)."""
        sharding.require_capturable(model.grid.mesh, model.grid.pgmin.device,
                                    "admm_two_level")
        self.source = model
        if self.own_par:
            self.par = model.par
        self.sorting = bool(getattr(model, "supports_line_sort", False)
                            and self.par.sort_lines)

    # ---- the loop bodies: static buffers in, static buffers out ----
    def _outer_flag(self, c: Carry):
        v = c.v
        v["outer_flag"].copy_((v["outer"] < self.par.outer_iterlim)
                              & (v["mismatch"] > self.outer_tol))

    def _pre(self, c: Carry):
        """The outer prestep: outer += 1, save ||z||, inner = 0; with line
        sorting, the lines ordered by the last iteration's steps (stable
        ascending; round 1's are all 0: the identity), the state permuted
        with them and the sorted grid refilled for the composed order."""
        v = c.v
        v["outer"].add_(1)
        v["norm_z_prev"].copy_(v["norm_z"])
        v["inner"].zero_()
        v["inner_flag"].fill_(int(self.par.inner_iterlim > 0))
        if self.sorting:
            reorder = torch.argsort(v["lane_steps"], stable=True)
            ids = v["line_ids"].index_select(0, reorder)
            v["line_ids"].copy_(ids)
            c.store(permute_solution_lines(c.sol, reorder))
            grid = self.source.with_line_order(ids).grid
            for k, buf in self.line_order.items():
                buf.copy_(getattr(grid, k))

    def _inner(self, c: Carry):
        """One inner iteration, then the inner flag: (inner <
        inner_iterlim) & (primres > eps_pri)."""
        m, v = self.model, c.v
        inner = v["inner"] + 1
        beta = v["beta"].to(self.dtype)
        sol = m.inner_prestep(c.sol)
        sol, stats = m.update_x(sol, inner)
        sol = m.update_xbar(sol, Pd=self.Pd, Qd=self.Qd)
        sol = m.update_z(sol, beta)
        sol = m.update_l(sol, beta)
        sol, scalars = m.update_residual(sol, beta)
        c.store(sol)
        v["inner"].copy_(inner)
        for k, name in _RESIDUAL.items():
            v[k].copy_(scalars[name])
        v["max_cviol"].copy_(stats["max_cviol"])
        if self.sorting:
            v["lane_steps"].copy_(stats["lane_steps"])
        # sqrt_d / (2500 outer) as the host computes it (a Python float
        # over a tensor would be a reciprocal times sqrt_d)
        eps_pri = torch.div(self.sqrt_d_t,
                            2500.0 * v["outer"].to(torch.float64))
        v["inner_flag"].copy_((inner < self.par.inner_iterlim)
                              & (v["primres"] > eps_pri))

    def _tail(self, c: Carry):
        """The outer tail (JAX ``_fused_outer_while``'s body after the
        inner loop): lz <- update_lz unless solved, beta escalated unless
        solved, cumul += inner, then the outer flag."""
        par, v = self.par, c.v
        solved = v["mismatch"] <= self.outer_tol
        sol = c.sol
        c.store_where(solved, sol,
                      self.model.update_lz(sol, v["beta"].to(self.dtype)))
        grow = ~solved & (v["norm_z"] > par.theta * v["norm_z_prev"])
        v["beta"].copy_(torch.where(
            grow, torch.clamp(par.inc_c * v["beta"], max=self.beta_cap),
            v["beta"]))
        v["cumul"].add_(v["inner"])
        self._outer_flag(c)

    def _reset(self, c: Carry, sol, info: IterationInformation):
        """The carry at the start of a solve, as the host loop starts from
        ``info``'s counters (kernels only: nothing comes from the host's
        memory)."""
        c.load(sol)
        v = c.v
        v["outer"].fill_(info.outer)
        v["cumul"].fill_(info.cumul)
        v["inner"].zero_()
        for k in _FLOATS:
            v[k].fill_(float("inf") if k in _START_INF else 0.0)
        v["beta"].fill_(min(self.par.initial_beta, self.beta_cap))
        v["inner_flag"].zero_()
        if "tron_steps" in v:
            v["tron_steps"].zero_()
        if self.sorting:
            v["line_ids"].copy_(self.ids0)
            v["lane_steps"].zero_()
        self._outer_flag(c)

    def _build(self, sol, info, Pd, Qd, pgmin, pgmax):
        dev = sol.u.gen.device
        self.dtype = sol.u.gen.dtype
        self.beta_cap = _beta_cap(self.dtype)
        self.sqrt_d_t = torch.tensor(self.sqrt_d, dtype=torch.float64,
                                     device=dev)

        given = dict(Pd=Pd, Qd=Qd, pgmin_curr=pgmin, pgmax_curr=pgmax)
        self.inputs = {k: t.clone() for k, t in given.items()
                       if t is not None}
        self.Pd, self.Qd = self.inputs.get("Pd"), self.inputs.get("Qd")
        self.model = copy.copy(self.source)
        for k in ("pgmin_curr", "pgmax_curr"):
            if k in self.inputs:
                setattr(self.model, k, self.inputs[k])
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        flag = torch.zeros((), dtype=torch.int32, device=dev)
        order = {}
        if self.sorting:
            # the line order and the grid the bodies read, in static
            # buffers that each outer prestep refills: the line arrays and
            # the arc CSR, what ``permute_lines`` moves
            grid = self.source.grid
            self.line_order = {k: getattr(grid, k).clone() for k in
                               LINE_FIELDS + ("arc_bus", "arc_idx")}
            self.model.grid = dataclasses.replace(grid, **self.line_order)
            self.ids0 = torch.arange(grid.nline_padded, device=dev)
            order = dict(line_ids=self.ids0,
                         lane_steps=torch.zeros(grid.nline_padded,
                                                dtype=torch.int32, device=dev))
        if tracing.enabled():
            # the line batch's TRON steps (``tracing.counting_steps``)
            order["tron_steps"] = count
        self.carry = c = Carry(sol, dict(
            {k: zero for k in _FLOATS}, **{k: count for k in _COUNTERS},
            inner_flag=flag, outer_flag=flag, **order))
        if dev.type != "cuda":
            return
        self._reset(c, sol, info)
        w = c.clone()
        # the capture bakes the counter's address into the stats kernel's
        # node (the warm-up's adds are zeroed by every solve's reset)
        with tracing.counting_steps(c.v.get("tron_steps")):
            self.loop = graph_loop.GraphLoop(
                self._bodies(c), (c.v["inner_flag"], c.v["outer_flag"]),
                warmup=lambda: (self._pre(w), self._inner(w),
                                self._tail(w)))

    def _bodies(self, c: Carry) -> tuple:
        return (lambda: self._pre(c), lambda: self._inner(c),
                lambda: self._tail(c))

    def __call__(self, sol, info: IterationInformation, Pd=None, Qd=None,
                 pgmin_curr=None, pgmax_curr=None, model=None):
        with tracing.span("loop.solve") as span:
            return self._solve(sol, info, Pd, Qd, pgmin_curr, pgmax_curr,
                               model, span)

    def _solve(self, sol, info, Pd, Qd, pgmin_curr, pgmax_curr, model,
               span):
        if model is not None and model is not self.source:
            if self.carry is not None:
                raise ValueError("a fused solver runs the model of its first "
                                 "call; this call gave another")
            self._bind(model)
        built = self.carry is None
        if span is not None:
            span.attrs["built"] = built
        if built:
            t0 = time.perf_counter()
            with tracing.span("loop.build"):
                self._build(sol, info, Pd, Qd, pgmin_curr, pgmax_curr)
            info.time_build = time.perf_counter() - t0
        given = {k: t for k, t in dict(
            Pd=Pd, Qd=Qd, pgmin_curr=pgmin_curr,
            pgmax_curr=pgmax_curr).items() if t is not None}
        if set(given) != set(self.inputs):
            raise ValueError(f"a fused solver built with "
                             f"{sorted(self.inputs)} was called with "
                             f"{sorted(given)}")
        with tracing.span("loop.inputs"):
            for k, buf in self.inputs.items():
                buf.copy_(given[k])
        c, loop = self.carry, self.loop
        with graph_loop.no_syncs(c.state[0].device):
            with tracing.span("loop.reset"):
                self._reset(c, sol, info)
            t0 = time.perf_counter()
            if loop is not None:
                loop.launch()
            else:
                with tracing.counting_steps(c.v.get("tron_steps")):
                    graph_loop.run_on_host(
                        self._bodies(c),
                        (c.v["inner_flag"], c.v["outer_flag"]))
            # tensors of its own (the next solve overwrites the buffers),
            # with the lines back in canonical order
            with tracing.span("loop.clone"):
                sol = c.clone().sol
                if self.sorting:
                    sol = permute_solution_lines(
                        sol, torch.argsort(c.v["line_ids"]))
        keys = _COUNTERS + _FLOATS + (
            ("tron_steps",) if "tron_steps" in c.v else ())
        out = c.read_back(keys, loop)
        info.time_overall = time.perf_counter() - t0
        if loop is not None:
            info.graph_pool_bytes = loop.pool_bytes
        info.outer, info.inner, info.cumul = (int(out[k]) for k in _COUNTERS)
        info.norm_z_curr = out["norm_z"]
        for k in ("norm_z_prev", "mismatch", "primres", "dualres", "objval",
                  "auglag", "max_cviol"):
            setattr(info, k, out[k])
        if info.outer > 0:
            info.eps_pri = self.sqrt_d / (2500.0 * info.outer)
        info.status = ("Solved" if info.mismatch <= self.outer_tol
                       else "IterationLimit")
        self.par.beta = out["beta"]
        if span is not None:
            span.attrs.update(tracing.solve_attrs(
                self.model.grid, self.dtype, info, loop))
            if "tron_steps" in out:
                span.attrs["tron_steps"] = int(out["tron_steps"])
        return sol, info


def make_fused_solver(model, par=None) -> FusedSolver:
    """The fused two-level solver of ``model`` (JAX ``make_fused_solver``;
    under a mesh, called with the rank's local model, JAX
    ``make_sharded_fused_solver``); built at its first call, then reusable
    for any solve of the same shapes."""
    return FusedSolver(model, par)


def admm_two_level_fused(model, sol: Solution,
                         info: IterationInformation | None = None, run=None,
                         Pd=None, Qd=None):
    """The two-level ADMM as one device-resident loop; returns (sol, info)
    as ``admm_two_level`` does, bit-identical to it.

    ``run`` is a solver of ``make_fused_solver`` to reuse (built here if
    None), which runs ``model``; the model's current
    ``pgmin_curr``/``pgmax_curr`` go into it with ``Pd``/``Qd``.
    ``info.time_overall`` is the time from the launch to the read-back; the
    build time before it is ``info.time_build``."""
    info = info or IterationInformation()
    if run is None:
        run = make_fused_solver(model)
    return run(sol, info, Pd=Pd, Qd=Qd,
               pgmin_curr=getattr(model, "pgmin_curr", None),
               pgmax_curr=getattr(model, "pgmax_curr", None), model=model)


def two_level_driver(model, mesh=None):
    """The two-level driver a solve of ``model`` runs, as the JAX package's
    entry points choose it (``exaadmm_tpu/interface/solve_acopf.py:117-131``):
    a function ``(model, sol, info=None, Pd=None, Qd=None) -> (sol, info)``.

    - ``verbose == 0``: the fused driver, with one solver for every call
      (a caller that solves the model period after period reuses its
      graph), with or without ``Parameters.sort_lines``, and under a
      ``mesh`` (called through ``run_sharded`` with the rank's local model,
      JAX ``make_sharded_fused_solver``) whose collectives the loop can
      hold: NCCL on the card, any backend on the CPU;
    - ``verbose > 0`` or ``Parameters.time_hooks``: the host loop (JAX's
      ``verbose >= 1`` and ``>= 2``);
    - a gloo ``mesh`` on the card: the host loop, by rule. Gloo stages every
      collective of a CUDA tensor through pinned host memory and reduces it
      on the host (two ranks may share one card so), which a CUDA graph
      cannot hold (``sharding.graph_capturable``)."""
    par = model.par
    if par.verbose > 0 or par.time_hooks or not sharding.graph_capturable(
            mesh, model.grid.pgmin.device):
        return admm_two_level
    return functools.partial(admm_two_level_fused,
                             run=make_fused_solver(model))
