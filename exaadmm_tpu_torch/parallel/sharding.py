"""Lines split across ranks: one process per GPU over ``torch.distributed``.

Counterpart of ``exaadmm_tpu/parallel/sharding.py``. The split is the same:

- the line arrays are cut into contiguous windows of the padded line batch
  (``build_grid_data(pad_lines_to=world size)``), one window per rank,
- generators, buses, storage and the ramp coupling are replicated: every
  rank computes them from the same bits,
- the branch TRON/ALM batch of a rank runs over its own lanes with no
  communication,
- the bus update needs one all-reduce of the stacked (nbus, 8) arc sums, the
  residual one all-reduce of its line partial sums, the branch statistics
  one (2,) sum and one scalar maximum per inner iteration. A model reaches
  them through ``grid.mesh``; with no mesh they return their argument.

The JAX package has three builders (``make_sharded_inner_loop``,
``make_sharded_one_level``, ``make_sharded_fused_solver``) because its loops
live inside ``shard_map``. Here each rank runs the driver it would run
alone over a model built on its own line window, so the three collapse into
``run_sharded``: cut the model and the state (``local_model``,
``local_solution``), run the driver on them, gather the state back
(``gather_solution``). Both drivers run so:

- the host loop (``admm_two_level``, ``admm_one_level``) reads its scalars
  back each iteration;
- the fused driver (``admm_two_level_fused``, ``admm_one_level_fused``,
  the counterparts of ``make_sharded_fused_solver`` and
  ``make_sharded_one_level``) is handed the rank's local model by
  ``run_sharded`` and builds its loop on it: on the card the collectives
  of the loop bodies are captured into the loop's graph as NCCL work, on
  the CPU the same bodies run under host loops.

Every rank takes the same trips in either because every scalar that
decides a break derives from all-reduced tensors and replicated data only;
``sqrt(nvar)`` is the whole grid's, as the local grid keeps the global line
count. With ``Parameters.sort_lines`` each rank sorts its own line window
and derives its local CSR again, with no communication, and restores the
window's order before the gather (JAX ``make_sharded_fused_solver``'s
per-shard sort).

Under the gloo backend a CUDA tensor is staged through pinned host memory:
gloo moves host buffers, and two ranks may share one card there. Under NCCL
the tensors are reduced where they lie. A graph can hold NCCL's work but not
gloo's staged copies and host-side reduction, so a gloo mesh over CUDA
tensors runs the host loop (``graph_capturable``).

``counts`` counts the collectives as the kernel wrappers count their
launches (``graph_loop.count_launch``): one per call on the host, and one
per replay, counted on the device, for a collective captured into a fused
driver's graph; the driver hands those back after its read-back. ``log``
gets one entry per call of a collective's Python function: a captured one
is logged once, at its capture.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch
import torch.distributed as dist

from ..ops import graph_loop
from ..utils.grid_data import LINE_FIELDS, GridData, build_csr, tile_lines

#: runs of each collective since the counts were last set to 0
counts = {"all_reduce_sum": 0, "all_reduce_max": 0, "all_gather": 0}
#: when a list, every collective appends (kind, payload shape, bytes) to it
log: list | None = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a line split: a process group, this process's
    rank in it and its size. ``group`` is None on a process that joined
    nothing; the collectives are then the identity."""

    group: object | None
    rank: int
    size: int
    backend: str | None = None


def make_mesh(group=None) -> Mesh:
    """The mesh of ``group``, by default of every process that joined
    (``parallel/distributed.py::initialize``); a mesh of this one process
    when nothing was joined."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return Mesh(group=None, rank=0, size=1)
    if group is None:
        group = dist.group.WORLD
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group),
                backend=str(dist.get_backend(group)))


def graph_capturable(mesh: Mesh | None, device) -> bool:
    """Whether a fused driver's graph can hold the collectives of ``mesh``
    on ``device``: always without a group or off the card; on the card only
    under NCCL, since gloo stages every CUDA tensor through pinned host
    memory and reduces it on the host."""
    return (mesh is None or mesh.group is None
            or torch.device(device).type != "cuda" or mesh.backend == "nccl")


def require_capturable(mesh: Mesh | None, device, host_loop: str) -> None:
    """Raise unless ``graph_capturable(mesh, device)``, naming the reason
    and ``host_loop``, the driver to run instead."""
    if not graph_capturable(mesh, device):
        raise ValueError(
            f"the fused driver cannot run a {mesh.backend} mesh on CUDA "
            "tensors: gloo stages every collective through pinned host "
            "memory and reduces it on the host, which a CUDA graph cannot "
            f"hold; run {host_loop} (the driver choice picks it for such a "
            "mesh)")


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _count(kind: str, n: int) -> None:
    counts[kind] += n


#: each collective's count, as ``graph_loop.count_launch`` takes it
_ADD = {k: functools.partial(_count, k) for k in counts}


def _note(kind: str, x: torch.Tensor) -> None:
    graph_loop.count_launch(_ADD[kind], kind)
    if log is not None:
        log.append((kind, tuple(x.shape), x.numel() * x.element_size()))


_pinned: dict = {}


def _staging(x: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``x``'s shape and dtype, kept for reuse."""
    key = (tuple(x.shape), x.dtype)
    if key not in _pinned:
        _pinned[key] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return _pinned[key]


def _all_reduce(x: torch.Tensor, mesh: Mesh | None, op, kind: str):
    if mesh is None or mesh.group is None:
        return x
    _note(kind, x)
    if mesh.backend == "gloo" and x.is_cuda:
        buf = _staging(x)
        buf.copy_(x)
        dist.all_reduce(buf, op=op, group=mesh.group)
        return buf.to(x.device)
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, the same bits on every rank;
    ``x`` itself when there is no mesh. The reduction may overwrite ``x``:
    pass a tensor nothing else reads."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM, "all_reduce_sum")


def all_reduce_max(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The maximum of ``x`` over the mesh's ranks, as ``all_reduce_sum``."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX, "all_reduce_max")


def all_gather(x: torch.Tensor, mesh: Mesh | None, dim: int = 0):
    """The ranks' ``x`` joined along ``dim`` in rank order, on every rank."""
    if mesh is None or mesh.group is None:
        return x
    _note("all_gather", x)
    staged = mesh.backend == "gloo" and x.is_cuda
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device)


def line_window(nline_padded: int, mesh: Mesh | None) -> slice:
    """This rank's contiguous window of the padded line batch."""
    size = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    if nline_padded % size != 0:
        raise ValueError(
            f"nline_padded={nline_padded} is not divisible by the mesh size "
            f"{size}; build the model with pad_lines_to={size}")
    per = nline_padded // size
    return slice(rank * per, (rank + 1) * per)


def local_grid(gd: GridData, mesh: Mesh) -> GridData:
    """The grid of this rank: the line arrays cut to its window, the arc CSR
    rebuilt over the local lines against all ``nbus`` buses (padded lanes
    have no arcs, so they stay out of every bus sum), everything else as it
    was. ``nline`` stays the whole grid's real line count, which the
    tolerances and averages scale with."""
    win = line_window(gd.nline_padded, mesh)
    lines = {k: getattr(gd, k)[win] for k in LINE_FIELDS}
    dev = gd.line_from.device
    arc_bus = torch.cat([lines["line_from"], lines["line_to"]])
    valid = torch.cat([lines["line_mask"], lines["line_mask"]]) > 0.5
    arc_ptr, arc_idx = build_csr(arc_bus.cpu().numpy(), gd.nbus,
                                 valid=valid.cpu().numpy())
    return dataclasses.replace(
        gd, nline_padded=win.stop - win.start, **lines, arc_bus=arc_bus,
        arc_ptr=torch.as_tensor(arc_ptr, device=dev),
        arc_idx=torch.as_tensor(arc_idx, device=dev), mesh=mesh)


def local_model(model, mesh: Mesh):
    """A copy of ``model`` over this rank's lines: its grid is
    ``local_grid``, every array it lists in ``LINE_FIELDS`` is cut to the
    window, and a multi-period model's tiled grid is rebuilt."""
    win = line_window(model.grid.nline_padded, mesh)
    m = copy.copy(model)
    m.grid = local_grid(model.grid, mesh)
    for k in getattr(model, "LINE_FIELDS", ()):
        setattr(m, k, getattr(model, k)[win])
    if hasattr(model, "grid_T"):
        m.grid_T = tile_lines(m.grid, model.T)
    return m


def _map_lines(rec, fn):
    """``rec`` with ``fn`` applied to every line-indexed tensor in it."""
    changes = {}
    for f in dataclasses.fields(rec):
        v = getattr(rec, f.name)
        if f.name in rec.LINE_LEAVES:
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map_lines(v, fn)
    return dataclasses.replace(rec, **changes)


def local_solution(sol, mesh: Mesh):
    """The state of this rank: every line-indexed tensor of ``sol``
    (``Solution``, ``SolutionMpacopf`` with its (T, ...) line blocks,
    ``SolutionQpsub``, the MPEC state) cut to the rank's window along its
    line axis, the rest shared."""
    axis = sol.LINE_AXIS

    def cut(v):
        win = line_window(v.shape[axis], mesh)
        return v.narrow(axis, win.start, win.stop - win.start).clone()

    return _map_lines(sol, cut)


def gather_solution(sol, mesh: Mesh):
    """The whole state from the ranks' local ones, on every rank."""
    axis = sol.LINE_AXIS
    return _map_lines(sol, lambda v: all_gather(v, mesh, dim=axis))


def default_pad(pad_lines_to: int, mesh: Mesh | None) -> int:
    """What an entry point pads its line batch to: the mesh size when a
    mesh is given and the caller asked for no padding of their own."""
    if mesh is not None and pad_lines_to == 1:
        return mesh.size
    return pad_lines_to


def run_sharded(admm, model, sol, mesh: Mesh | None, **kwargs):
    """Run ``admm(model, sol, **kwargs)`` (a driver: ``admm_two_level``,
    ``admm_one_level``, or the fused one that ``two_level_driver`` /
    ``one_level_driver`` give, which builds its loop on the model it is
    first called with) with the lines split over ``mesh``: ``model`` and
    ``sol`` are the whole (padded) problem; ``admm`` gets this rank's
    ``local_model`` and ``local_solution``, and the whole solution and the
    same ``info`` come back on every rank. Only rank 0 prints;
    ``model.par.beta`` is set as by a one-process run. With no mesh it is
    ``admm(model, sol, **kwargs)``."""
    if mesh is None:
        return admm(model, sol, **kwargs)
    par = model.par
    local = local_model(model, mesh)
    local.par = dataclasses.replace(
        par, verbose=par.verbose if mesh.rank == 0 else 0)
    sol, info = admm(local, local_solution(sol, mesh), **kwargs)
    par.beta = local.par.beta
    return gather_solution(sol, mesh), info
