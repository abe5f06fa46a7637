"""The single-period ACOPF inner iteration's closed-form hooks as CUDA kernels.

``csrc/acopf_hooks.cu`` holds one kernel per hook, where the plain versions
(``models/acopf/kernels.py``) launch one kernel per slice, op, ``stack`` and
``cat``. No TPU kernel is replaced: these are the counterparts of the
fusions XLA compiles from the JAX hooks (``exaadmm_tpu/models/acopf/
kernels.py``):

- ``generator_update``: one thread per generator (``acopf_generator``);
- ``bus_update``: the arc and generator values (``acopf_bus_values``), the
  two ``bus_cuda.bus_scatter`` sums (and a mesh's all-reduce) as before,
  the per-bus 2x2 solve (``acopf_bus_solve``) and the writeback
  (``acopf_bus_writeback``);
- ``z_update``, ``l_update``, ``lz_update``: one elementwise launch over
  both blocks each (``acopf_z``, ``acopf_l``, ``acopf_lz``);
- ``residual_update``: rp, rd and each block's 15 sums
  (``acopf_residual_partials``), a mesh's all-reduce of the 7 line rows,
  then the six scalars (``acopf_residual_final``).

On a CUDA tensor a wrapper launches its kernel(s); on a CPU tensor it runs
the plain version; any other device, a dtype other than float32 or float64
or, on the card, a non-contiguous input, a mixed dtype or a wrong shape
raises. The elementwise kernels are bit-identical to the plain versions on
the card; the residual's sums follow a fixed tree (``residual_partials_
plain`` and ``residual_final_plain`` reproduce it with torch ops), so they
are bit-identical from run to run and within rounding of ``torch.sum``.

A scalar that the fused driver's graph changes between replays (``beta``,
a 0-d tensor there) goes to the kernel by pointer; a Python float (the host
loop's) by value. Nothing here reads device data back.

``out``: every wrapper that the inner iteration runs (``generator_update``,
``bus_update``/``bus_writeback``, ``z_update``, ``l_update``, the
residual's three) takes an optional destination shaped as what it returns,
and returns that destination: on the card the kernel writes it in place of
a new tensor, on the CPU the plain version's result is copied into it. A
destination may be an input's memory wherever the kernel reads only the
elements it writes (the fused driver's carry: u, v, z, l, rp, rd); the
residual's scalars go into a (6,) tensor of any float type (copied when it
is not the kernel's).

Which models run these kernels is a rule by model: ``ModelAcopf``'s hooks
(every path of a single-period solve: with and without line limits, the
projection, rolling horizon, mixed precision, ``sort_lines``, a mesh, the
host loop and the fused graph). The multi-period model runs its own
(``ops/mpacopf_cuda.py``: a period axis, the ramp blend); the
QP-subproblem and MPEC models call the plain functions of
``models/acopf/kernels.py`` (other blocks); their kernels are the next
slices.

``launches`` counts the kernels' launches by name (``KERNELS``), a launch
that a fused driver's graph replays once per replay
(``graph_loop.count_launch``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.acopf import kernels
from ..parallel.sharding import all_reduce_sum
from ..utils.environment import Blocks
from . import _build, bus_cuda, graph_loop

KERNELS = ("acopf_generator", "acopf_bus_values", "acopf_bus_solve",
           "acopf_bus_writeback", "acopf_z", "acopf_l", "acopf_lz",
           "acopf_residual_partials", "acopf_residual_final")
launches: dict = {}

#: threads of a block of the residual's first pass (``kThreads``)
THREADS = 256
#: rows of the residual's block sums: the 7 masked line dot products, then
#: the 7 generator ones and the objective (``kLineSums``, ``kGenSums``)
LINE_SUMS, GEN_SUMS = 7, 8
#: the residual's scalars, in the order of ``acopf_residual_final``'s output
SCALARS = ("primres", "dualres", "norm_z_curr", "mismatch", "objval",
           "auglag")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGS = {
    # (u, v, l, rho, lz, z as gen/line pairs, ngen2, nline8, beta_ptr,
    #  beta, stream)
    "acopf_z": [_P] * 12 + [_I, _I, _P, _D, _P],
    # (z, lz, out pairs, ngen2, nline8, beta_ptr, beta, stream)
    "acopf_l": [_P] * 6 + [_I, _I, _P, _D, _P],
    # ... and the clamp's (lo, hi)
    "acopf_lz": [_P] * 6 + [_I, _I, _P, _D, _D, _D, _P],
    # (v, z, l, rho, pgmin, pgmax, qgmin, qgmax, c2, c1, u, ngen,
    #  obj_scale, baseMVA, baseMVA^2, stream)
    "acopf_generator": [_P] * 11 + [_I, _D, _D, _D, _P],
    # (u, z, l, rho pairs, mask, arcs, gens, nline, ngen, stream)
    "acopf_bus_values": [_P] * 11 + [_I, _I, _P],
    # (agg, gsum, Pd, Qd, YshR, YshI, wtm, nbus, 1/baseMVA, stream)
    "acopf_bus_solve": [_P] * 7 + [_I, _D, _P],
    # (u, z, l, rho pairs, wtm, line_from, line_to, gen_bus, v pair,
    #  nline, ngen, stream)
    "acopf_bus_writeback": [_P] * 14 + [_I, _I, _P],
    # (u, v, z, z_prev, lz, l, rho pairs, mask, c2, c1, c0, rp pair, rd
    #  pair, part, ngen2, nline8, nblocks, baseMVA, stream)
    "acopf_residual_partials": [_P] * 23 + [_I, _I, _I, _D, _P],
    # (line_part, gen_part, nblocks, beta_ptr, beta, out, stream)
    "acopf_residual_final": [_P, _P, _I, _P, _D, _P, _P],
}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _add_launches(name: str, n: int) -> None:
    launches[name] = launches.get(name, 0) + n


def library():
    """The kernel library, built from ``csrc/acopf_hooks.cu`` at first
    call."""
    sigs = {f"{k}_{s}": sig for k, sig in _SIGS.items()
            for s in _SUFFIX.values()}
    sigs["acopf_launch_floor"] = [_P]
    return _build.load("acopf_hooks", sigs)


def _launch(name: str, dev, dtype, *args) -> None:
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_{_SUFFIX[dtype]}")(*args, stream)
    _build.check(lib, err, name)
    graph_loop.count_launch(functools.partial(_add_launches, name), name)


def launch_floor(dev) -> None:
    """Launch the library's empty kernel once (its device time is the floor
    under every launch); not counted."""
    lib = library()
    with torch.cuda.device(dev):
        err = lib.acopf_launch_floor(torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "acopf_launch_floor")


def _blocks(*blocks: Blocks) -> list:
    return [t for b in blocks for t in (b.gen, b.line)]


def _ptrs(tensors) -> list:
    return [t.data_ptr() for t in tensors]


def _route(what: str, floats, ints=(), ngen=None, nline=None) -> bool:
    """True to launch the kernel (CUDA tensors), False to run the plain
    version (CPU tensors); raises on anything a kernel cannot take.

    ``floats`` are the kernel's float inputs (the first sets the dtype),
    ``ints`` its int64 index inputs; with ``ngen``/``nline`` given, the
    (ngen, 2) and (nline, 8) blocks among ``floats`` are held to them."""
    dtype, dev = floats[0].dtype, floats[0].device
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32 or "
                        f"float64)")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    validate(what, floats, ints, ngen, nline)
    return True


def validate(what: str, floats, ints=(), ngen=None, nline=None) -> None:
    """What a kernel requires of its inputs, on any device: one device, the
    float inputs of one dtype, the index inputs int64, all contiguous, and
    the blocks of (ngen, 2) and (nline, 8)."""
    dtype, dev = floats[0].dtype, floats[0].device
    for t in floats:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: every input must be a contiguous "
                             f"{dtype} tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dim() == 2 and t.shape[1] == 2 and ngen is not None and (
                t.shape[0] != ngen):
            raise ValueError(f"{what}: a generator block of {t.shape[0]} "
                             f"rows, not {ngen}")
        if t.dim() == 2 and t.shape[1] == 8 and nline is not None and (
                t.shape[0] != nline):
            raise ValueError(f"{what}: a line block of {t.shape[0]} rows, "
                             f"not {nline}")
    for t in ints:
        if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{what}: an index input must be a contiguous "
                             f"int64 tensor on {dev}")


def _scalar(x, what: str, dtype, dev):
    """(pointer, value) of a scalar the kernel reads: a 0-d tensor by
    pointer (a replayed graph reads its value at the time), a number by
    value. A float is never staged into a new tensor here."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0 or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{what}: a tensor scalar must be a 0-d {dtype} "
                             f"tensor on {dev}")
        return x.data_ptr(), 0.0
    return None, float(x)


def _like(b: Blocks) -> Blocks:
    return Blocks(gen=torch.empty_like(b.gen), line=torch.empty_like(b.line))


def check_out(what: str, out, like) -> None:
    """A destination (a tensor or ``Blocks``) of ``like``'s shapes,
    dtype and device, contiguous; None passes."""
    if out is None:
        return
    if isinstance(like, Blocks):
        check_out(what, out.gen, like.gen)
        check_out(what, out.line, like.line)
        return
    if (out.shape != like.shape or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {like.dtype} "
                         f"tensor of shape {tuple(like.shape)} on "
                         f"{like.device}; got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def land(out, result):
    """``result`` in ``out`` (a tensor or ``Blocks``; None gives ``result``
    as it is), copied unless it is already there; returns ``out``."""
    if out is None:
        return result
    if isinstance(out, Blocks):
        land(out.gen, result.gen)
        land(out.line, result.line)
        return out
    if out is not result:
        out.copy_(result)
    return out


def _sizes(b: Blocks):
    return b.gen.shape[0], b.line.shape[0]


# ---- z, l, lz

def z_update(u: Blocks, v: Blocks, l: Blocks, rho: Blocks, lz: Blocks,
             beta, out: Blocks | None = None) -> Blocks:
    """``kernels.z_update`` in one launch (``acopf_z``), into ``out`` if
    given (z is not read)."""
    ngen, nline = _sizes(u)
    check_out("z_update", out, u)
    if not _route("z_update", _blocks(u, v, l, rho, lz), ngen=ngen,
                  nline=nline):
        return land(out, kernels.z_update(u, v, l, rho, lz, beta))
    dtype, dev = u.gen.dtype, u.gen.device
    z = _like(u) if out is None else out
    _launch("acopf_z", dev, dtype, *_ptrs(_blocks(u, v, l, rho, lz, z)),
            2 * ngen, 8 * nline, *_scalar(beta, "z_update", dtype, dev))
    return z


def l_update(z: Blocks, lz: Blocks, beta,
             out: Blocks | None = None) -> Blocks:
    """``kernels.l_update`` in one launch (``acopf_l``), into ``out`` if
    given (l is not read)."""
    ngen, nline = _sizes(z)
    check_out("l_update", out, z)
    if not _route("l_update", _blocks(z, lz), ngen=ngen, nline=nline):
        return land(out, kernels.l_update(z, lz, beta))
    dtype, dev = z.gen.dtype, z.gen.device
    if out is None:
        out = _like(z)
    _launch("acopf_l", dev, dtype, *_ptrs(_blocks(z, lz, out)), 2 * ngen,
            8 * nline, *_scalar(beta, "l_update", dtype, dev))
    return out


def lz_update(z: Blocks, lz: Blocks, beta, max_multiplier) -> Blocks:
    """``kernels.lz_update`` in one launch (``acopf_lz``)."""
    ngen, nline = _sizes(z)
    if not _route("lz_update", _blocks(z, lz), ngen=ngen, nline=nline):
        return kernels.lz_update(z, lz, beta, max_multiplier)
    dtype, dev = z.gen.dtype, z.gen.device
    out = _like(z)
    _launch("acopf_lz", dev, dtype, *_ptrs(_blocks(z, lz, out)), 2 * ngen,
            8 * nline, *_scalar(beta, "lz_update", dtype, dev),
            -float(max_multiplier), float(max_multiplier))
    return out


# ---- the generator update

def generator_update(u_gen, v_gen, z_gen, l_gen, rho_gen, pgmin, pgmax,
                     qgmin, qgmax, c2, c1, baseMVA: float,
                     obj_scale: float = 1.0, out=None):
    """``kernels.generator_update`` with the effective cost coefficients
    ``c2 * obj_scale`` and ``c1 * obj_scale`` (the model's ``c2_eff`` and
    ``c1_eff``), formed inside the kernel (``acopf_generator``), into
    ``out`` if given; ``u_gen`` is not read, as in the plain version."""
    ngen = v_gen.shape[0]
    floats = [v_gen, z_gen, l_gen, rho_gen, pgmin, pgmax, qgmin, qgmax, c2,
              c1]
    check_out("generator_update", out, v_gen)
    if not _route("generator_update", floats, ngen=ngen):
        return land(out, kernels.generator_update(
            u_gen, v_gen, z_gen, l_gen, rho_gen, pgmin, pgmax, qgmin, qgmax,
            c2 * obj_scale, c1 * obj_scale, baseMVA))
    u = torch.empty_like(v_gen) if out is None else out
    _launch("acopf_generator", v_gen.device, v_gen.dtype,
            *_ptrs(floats + [u]), ngen, float(obj_scale), float(baseMVA),
            float(baseMVA) ** 2)
    return u


# ---- the bus update

def host_reciprocal(x: float, dtype) -> float:
    """1 / x as PyTorch's CUDA division of a tensor by a Python number
    forms it: the reciprocal in the tensor's type, computed on the host."""
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(x))
    return 1.0 / float(x)


def bus_values(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, gd):
    """(arcs (2 nline, 8), gens (ngen, 4)): ``kernels.bus_arc_values`` and
    ``kernels.bus_gen_values`` in one launch (``acopf_bus_values``)."""
    ngen, nline = _sizes(u)
    floats = _blocks(u, z, l, rho) + [gd.line_mask]
    if not _route("bus_values", floats, ngen=ngen, nline=nline):
        return (kernels.bus_arc_values(u, z, l, rho, gd),
                kernels.bus_gen_values(u, z, l, rho))
    dtype, dev = u.gen.dtype, u.gen.device
    arcs = torch.empty((2 * nline, 8), dtype=dtype, device=dev)
    gens = torch.empty((ngen, 4), dtype=dtype, device=dev)
    _launch("acopf_bus_values", dev, dtype, *_ptrs(floats + [arcs, gens]),
            nline, ngen)
    return arcs, gens


def bus_solve(agg, gsum, gd, Pd, Qd):
    """The (nbus, 4) rows [wi, ti, mu1, mu2]: ``kernels.bus_solve`` in one
    launch (``acopf_bus_solve``)."""
    floats = [agg, gsum, Pd, Qd, gd.YshR, gd.YshI]
    if not _route("bus_solve", floats):
        return kernels.bus_solve(agg, gsum, gd, Pd, Qd)
    nbus = gd.nbus
    if agg.shape != (nbus, 8) or gsum.shape != (nbus, 4) or any(
            t.shape != (nbus,) for t in floats[2:]):
        raise ValueError(f"bus_solve: sums of {tuple(agg.shape)} and "
                         f"{tuple(gsum.shape)} for {nbus} buses")
    wtm = torch.empty((nbus, 4), dtype=agg.dtype, device=agg.device)
    _launch("acopf_bus_solve", agg.device, agg.dtype, *_ptrs(floats + [wtm]),
            nbus, host_reciprocal(gd.baseMVA, agg.dtype))
    return wtm


def bus_writeback(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, wtm, gd,
                  out: Blocks | None = None) -> Blocks:
    """The new v: ``kernels.bus_writeback`` in one launch
    (``acopf_bus_writeback``), into ``out`` if given (v is not read)."""
    ngen, nline = _sizes(u)
    floats = _blocks(u, z, l, rho) + [wtm]
    ints = [gd.line_from, gd.line_to, gd.gen_bus]
    check_out("bus_writeback", out, u)
    if not _route("bus_writeback", floats, ints, ngen=ngen, nline=nline):
        return land(out, kernels.bus_writeback(u, z, l, rho, wtm, gd))
    if wtm.shape != (gd.nbus, 4) or any(
            t.shape != (n,) for t, n in zip(ints, (nline, nline, ngen))):
        raise ValueError("bus_writeback: wtm or the index arrays do not "
                         "match the blocks")
    v = _like(u) if out is None else out
    _launch("acopf_bus_writeback", u.gen.device, u.gen.dtype,
            *_ptrs(floats + ints + _blocks(v)), nline, ngen)
    return v


def bus_update(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, gd,
               Pd=None, Qd=None, out: Blocks | None = None) -> Blocks:
    """``kernels.bus_update`` (single period): three launches around the
    two bus scatters and, with the lines split over a mesh, the
    all-reduce of the arc sums, in the plain version's order; the
    writeback into ``out`` if given."""
    check_out("bus_update", out, u)
    if not _route("bus_update", _blocks(u, z, l, rho)):
        return land(out, kernels.bus_update(u, z, l, rho, gd, Pd=Pd, Qd=Qd))
    arcs, gens = bus_values(u, z, l, rho, gd)
    agg = all_reduce_sum(bus_cuda.bus_scatter(
        arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx), gd.mesh)
    gsum = bus_cuda.bus_scatter(gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)
    wtm = bus_solve(agg, gsum, gd, gd.Pd if Pd is None else Pd,
                    gd.Qd if Qd is None else Qd)
    return bus_writeback(u, z, l, rho, wtm, gd, out=out)


# ---- the residual

def residual_blocks(ngen: int, nline: int) -> int:
    """Blocks of the residual's first pass over 2 ngen + 8 nline
    elements."""
    return -(-(2 * ngen + 8 * nline) // THREADS)


def residual_partials(sol, gd, out=None):
    """(rp, rd, part): rp and rd (into ``out``'s pair if given; they are
    not read), and the (15, nblocks) block sums of the residual's first
    pass (``acopf_residual_partials``); on the CPU
    ``residual_partials_plain``."""
    ngen, nline = _sizes(sol.u)
    floats = (_blocks(sol.u, sol.v, sol.z, sol.z_prev, sol.lz, sol.l,
                      sol.rho) + [gd.line_mask, gd.c2, gd.c1, gd.c0])
    rp, rd = (None, None) if out is None else out
    check_out("residual_partials", rp, sol.u)
    check_out("residual_partials", rd, sol.u)
    if not _route("residual_partials", floats, ngen=ngen, nline=nline):
        rp_, rd_, part = residual_partials_plain(sol, gd)
        return land(rp, rp_), land(rd, rd_), part
    dtype, dev = sol.u.gen.dtype, sol.u.gen.device
    nb = residual_blocks(ngen, nline)
    rp = _like(sol.u) if rp is None else rp
    rd = _like(sol.u) if rd is None else rd
    part = torch.empty((LINE_SUMS + GEN_SUMS, nb), dtype=dtype, device=dev)
    _launch("acopf_residual_partials", dev, dtype,
            *_ptrs(floats + _blocks(rp, rd) + [part]), 2 * ngen, 8 * nline,
            nb, float(gd.baseMVA))
    return rp, rd, part


def check_scalars_out(what: str, out, n: int, like) -> None:
    """A destination of ``n`` scalars: a contiguous (n,) float tensor on
    ``like``'s device, of any float type."""
    if out is not None and (out.shape != (n,) or not out.is_contiguous()
                            or not out.dtype.is_floating_point
                            or out.device != like.device):
        raise ValueError(f"{what}: out must be a contiguous ({n},) float "
                         f"tensor on {like.device}; got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def residual_final(line_part, gen_part, beta, out=None):
    """The (6,) scalars ``SCALARS`` from the block sums: the (7, nblocks)
    line rows (all-reduced over a mesh) and the (8, nblocks) generator and
    objective rows (``acopf_residual_final``); on the CPU
    ``residual_final_plain``. Into ``out`` if given: written by the kernel
    where it has the block sums' type, else copied there."""
    check_scalars_out("residual_final", out, len(SCALARS), line_part)
    if not _route("residual_final", [line_part, gen_part]):
        return land(out, residual_final_plain(line_part, gen_part, beta))
    nb = line_part.shape[1]
    if line_part.shape != (LINE_SUMS, nb) or gen_part.shape != (GEN_SUMS,
                                                                nb):
        raise ValueError(f"residual_final: block sums of "
                         f"{tuple(line_part.shape)} and "
                         f"{tuple(gen_part.shape)}")
    dtype, dev = line_part.dtype, line_part.device
    dst = out if out is not None and out.dtype == dtype else torch.empty(
        len(SCALARS), dtype=dtype, device=dev)
    _launch("acopf_residual_final", dev, dtype, line_part.data_ptr(),
            gen_part.data_ptr(), nb, *_scalar(beta, "residual_final", dtype,
                                              dev), dst.data_ptr())
    return land(out, dst)


def residual_update(sol, gd, beta, out=None):
    """``kernels.residual_update``: (rp, rd, scalars) in two launches, with
    the line rows of the block sums all-reduced between them under a mesh;
    the scalars are 0-d views of one (6,) tensor. ``out`` is (rp, rd, the
    (6,) scalars), each a destination or None."""
    rp, rd, scalars = (None, None, None) if out is None else out
    if not _route("residual_update", _blocks(sol.u)):
        for t in (rp, rd):
            check_out("residual_update", t, sol.u)
        check_scalars_out("residual_update", scalars, len(SCALARS), sol.u.gen)
        rp_, rd_, vals = kernels.residual_update(sol, gd, beta)
        if scalars is None:
            return land(rp, rp_), land(rd, rd_), vals
        scalars.copy_(torch.stack([vals[k] for k in SCALARS]))
        return (land(rp, rp_), land(rd, rd_),
                dict(zip(SCALARS, scalars.unbind())))
    rp, rd, part = residual_partials(sol, gd, out=(rp, rd))
    line = all_reduce_sum(part[:LINE_SUMS], gd.mesh)
    vals = residual_final(line, part[LINE_SUMS:], beta, out=scalars)
    return rp, rd, dict(zip(SCALARS, vals.unbind()))


# ---- the residual's fixed tree, as torch ops (the kernels' plain versions)

def _products(sol, gd):
    """rp, rd and the (15, n) per-element terms of the residual's sums over
    the stacked [gen; line] elements, in the kernel's row order."""
    rp = Blocks(gen=sol.u.gen - sol.v.gen + sol.z.gen,
                line=sol.u.line - sol.v.line + sol.z.line)
    rd = Blocks(gen=sol.z.gen - sol.z_prev.gen,
                line=sol.z.line - sol.z_prev.line)

    def terms(r, d, z, lz, l, rho):
        ax = r - z
        return [r * r, d * d, z * z, ax * ax, lz * z, l * r, rho * (r * r)]

    m = gd.line_mask[:, None]
    line = [t * m for t in terms(rp.line, rd.line, sol.z.line, sol.lz.line,
                                 sol.l.line, sol.rho.line)]
    gen = terms(rp.gen, rd.gen, sol.z.gen, sol.lz.gen, sol.l.gen,
                sol.rho.gen)
    pg = sol.u.gen[:, 0] * gd.baseMVA
    obj = torch.zeros_like(sol.u.gen)
    obj[:, 0] = gd.c2 * (pg * pg) + gd.c1 * pg + gd.c0
    gen.append(obj)
    ng, nl = sol.u.gen.numel(), sol.u.line.numel()
    rows = []
    for r in range(LINE_SUMS + GEN_SUMS):
        row = torch.zeros(ng + nl, dtype=sol.u.gen.dtype,
                          device=sol.u.gen.device)
        if r < LINE_SUMS:
            row[ng:] = line[r].reshape(-1)
        else:
            row[:ng] = gen[r - LINE_SUMS].reshape(-1)
        rows.append(row)
    return rp, rd, torch.stack(rows)


def _shuffle_tree(x):
    """Lane 0's sum of the last axis (32 lanes) by a warp's shuffle-down
    tree: offsets 16, 8, 4, 2, 1."""
    off = 16
    while off:
        x = x[..., :off] + x[..., off:2 * off]
        off //= 2
    return x[..., 0]


def residual_partials_plain(sol, gd):
    """``acopf_residual_partials`` as torch ops: (rp, rd, part), the
    (15, nblocks) block sums by the kernel's tree (a shuffle-down tree per
    warp of 32 elements, then the block's warps added in order)."""
    rp, rd, terms = _products(sol, gd)
    nb = residual_blocks(*_sizes(sol.u))
    pad = nb * THREADS - terms.shape[1]
    terms = torch.cat([terms, terms.new_zeros((terms.shape[0], pad))], 1)
    warps = _shuffle_tree(terms.reshape(terms.shape[0], nb,
                                        THREADS // 32, 32))
    part = warps[..., 0]
    for w in range(1, THREADS // 32):
        part = part + warps[..., w]
    return rp, rd, part


def residual_final_plain(line_part, gen_part, beta):
    """``acopf_residual_final`` as torch ops: each row's block sums added
    as the kernel's warp adds them (lane l the blocks l, l + 32, ... in
    order, then a shuffle-down tree), then the six scalars."""
    part = torch.cat([line_part, gen_part])
    nb = part.shape[1]
    laps = -(-nb // 32)
    part = torch.cat([part, part.new_zeros((part.shape[0],
                                            laps * 32 - nb))], 1)
    part = part.reshape(part.shape[0], laps, 32)
    acc = torch.zeros_like(part[:, 0])
    for k in range(laps):
        acc = acc + part[:, k]
    tot = _shuffle_tree(acc)
    L, G = tot[:LINE_SUMS], tot[LINE_SUMS:]
    z_sq = G[2] + L[2]
    objval = G[7]
    auglag = (((objval + (G[4] + L[4])) + (0.5 * beta) * z_sq)
              + (G[5] + L[5])) + 0.5 * (G[6] + L[6])
    return torch.stack([torch.sqrt(G[0] + L[0]), torch.sqrt(G[1] + L[1]),
                        torch.sqrt(z_sq), torch.sqrt(G[3] + L[3]), objval,
                        auglag])
