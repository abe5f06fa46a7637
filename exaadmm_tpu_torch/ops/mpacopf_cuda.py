"""The multi-period ACOPF inner iteration's hooks as CUDA kernels.

``csrc/mpacopf_hooks.cu`` holds one kernel per hook, where the plain versions
(``models/mpacopf/model.py``, ``ramp.py``) launch one kernel per slice, op,
``stack``, ``cat``, ``repeat`` and permute copy. No TPU kernel is replaced:
these are the counterparts of the fusions XLA compiles from the JAX
multi-period hooks (``exaadmm_tpu/models/mpacopf/model.py``):

- ``ramp_pack``: the ramp batch's x0, xl, xu, (9, B) parameter block, lam0,
  mu0 and flags, one thread per lane (``mp_ramp_pack``); the ramp TRON/ALM
  kernel runs on them through ``tron_cuda.tron_alm_packed``;
- ``generator_unpack``: qg of every period, pg of period 1 in closed form,
  pg of the later periods and the new ramp state from the batch's result,
  one thread per (period, generator) (``mp_generator_unpack``);
- ``bus_update``: the arc and generator values of all periods, written
  folded into the channels (``mp_bus_values``), the two
  ``bus_cuda.bus_scatter`` sums (and a mesh's all-reduce of the arc sums)
  as before, the per-bus 2x2 solve of every period (``mp_bus_solve``) and
  the writeback (``mp_bus_writeback``), the ramp blend in the pg rows;
- ``z_update``, ``l_update``, ``lz_update``: one elementwise launch each
  over the ADMM blocks and the ramp block (``mp_z``, ``mp_l``, ``mp_lz``);
- ``residual_update``: rp, rd and each period's 13 block sums
  (``mp_residual_partials``), a mesh's all-reduce of the 4 line rows, then
  the six scalars (``mp_residual_final``).

On a CUDA tensor a wrapper launches its kernel(s); on a CPU tensor it runs
the plain version; any other device, a dtype other than float32 or float64
or, on the card, a non-contiguous input, a mixed dtype or a wrong shape
raises. The elementwise kernels are bit-identical to the plain versions on
the card; the residual's sums follow a fixed tree (``residual_partials_
plain`` and ``residual_final_plain`` reproduce it with torch ops), so they
are bit-identical from run to run and within rounding of ``torch.sum``.

A scalar that the fused driver's graph changes between replays (``beta``, a
0-d tensor there, and ``inner_iter``, a 0-d int64 tensor) goes to the kernel
by pointer; a Python number (the host loop's) by value. Nothing here reads
device data back, and no pointer is kept between calls.

Which models run these kernels: ``ModelMpacopf`` on every path of
``solve_mpacopf`` (with and without a warm start and line limits, the host
loop and the fused graph, a mesh over each period's line window). The
branch batch keeps ``branch_update`` (``ops/branch_cuda.py``).

``launches`` counts the kernels' launches by name (``KERNELS``), a launch
that a fused driver's graph replays once per replay
(``graph_loop.count_launch``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.acopf import kernels
from ..parallel.sharding import all_reduce_sum
from ..utils.environment import Blocks
from . import _build, acopf_cuda, bus_cuda, graph_loop

KERNELS = ("mp_ramp_pack", "mp_generator_unpack", "mp_bus_values",
           "mp_bus_solve", "mp_bus_writeback", "mp_z", "mp_l", "mp_lz",
           "mp_residual_partials", "mp_residual_final")
launches: dict = {}

#: threads of a block of the residual's first pass (``kThreads``)
THREADS = 256
#: rows of the residual's block sums: the 4 masked line squares, then the
#: 4 generator ones, the 4 ramp ones and the objective (``kSums``)
LINE_SUMS, REST_SUMS = 4, 9
#: the residual's scalars, in the order of ``mp_residual_final``'s output
SCALARS = acopf_cuda.SCALARS

_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
_SIGS = {
    # (u, v, z, l, rho gen blocks, ramp u, s, l, rho, z, alm_mu, alm_xi,
    #  c2, c1, pgmin, pgmax, ramp_rate, x0, xl, xu, P, lam0, mu0, act, B,
    #  ngen, it_p, it_v, obj_scale, baseMVA, stream)
    "mp_ramp_pack": [_P] * 24 + [_I, _I, _P, _L, _D, _D, _P],
    # (v, z, l, rho gen blocks, pgmin, pgmax, qgmin, qgmax, c2, c1, ramp
    #  alm_xi, x, lam, mu, u, ramp u, s, alm_mu, alm_xi, T, ngen,
    #  obj_scale, baseMVA, baseMVA^2, stream)
    "mp_generator_unpack": [_P] * 19 + [_I, _I, _D, _D, _D, _P],
    # (u, z, l, rho pairs, ramp u, z, l, rho, mask, arcs, gens, T, nline,
    #  ngen, stream)
    "mp_bus_values": [_P] * 15 + [_I, _I, _I, _P],
    # (agg, gsum, Pd, Qd, YshR, YshI, wtm, T, nbus, 1/baseMVA, stream)
    "mp_bus_solve": [_P] * 7 + [_I, _I, _D, _P],
    # (u, z, l, rho pairs, ramp u, z, l, rho, wtm, line_from, line_to,
    #  gen_bus, v pair, T, nline, ngen, nbus, stream)
    "mp_bus_writeback": [_P] * 18 + [_I] * 4 + [_P],
    # (u, v, l, rho, lz pairs, z pair, ramp u, l, rho, lz, z, T, nline,
    #  ngen, beta_ptr, beta, stream)
    "mp_z": [_P] * 17 + [_I] * 3 + [_P, _D, _P],
    # (z, lz pairs, out pair, ramp z, lz, out, T, nline, ngen, beta_ptr,
    #  beta, stream)
    "mp_l": [_P] * 9 + [_I] * 3 + [_P, _D, _P],
    # ... and the clamp's (lo, hi)
    "mp_lz": [_P] * 9 + [_I] * 3 + [_P, _D, _D, _D, _P],
    # (u, v, z, z_prev pairs, ramp u, z, z_prev, mask, c2, c1, c0, rp pair,
    #  rd pair, part, T, nline, ngen, nblocks, baseMVA, stream)
    "mp_residual_partials": [_P] * 20 + [_I] * 4 + [_D, _P],
    # (line_part, rest_part, T, nblocks, out, stream)
    "mp_residual_final": [_P, _P, _I, _I, _P, _P],
}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _add_launches(name: str, n: int) -> None:
    launches[name] = launches.get(name, 0) + n


def library():
    """The kernel library, built from ``csrc/mpacopf_hooks.cu`` at first
    call."""
    sigs = {f"{k}_{s}": sig for k, sig in _SIGS.items()
            for s in _SUFFIX.values()}
    return _build.load("mpacopf_hooks", sigs)


def _launch(name: str, dev, dtype, *args) -> None:
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_{_SUFFIX[dtype]}")(*args, stream)
    _build.check(lib, err, name)
    graph_loop.count_launch(functools.partial(_add_launches, name), name)


def _route(what: str, inputs) -> bool:
    """True to launch the kernel (inputs on the card), False to run the
    plain version (on the CPU); raises on anything a kernel cannot take.
    ``inputs`` are the kernel's (name, tensor, shape, dtype) inputs, the
    state's first."""
    state = inputs[0][1]
    if state.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype {state.dtype} not supported "
                        "(float32 or float64)")
    if state.device.type == "cpu":
        return False
    if state.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {state.device}")
    validate(what, inputs)
    return True


def validate(what: str, inputs) -> None:
    """What a kernel requires of its inputs, on any device: each of
    ``inputs`` ((name, tensor, shape, dtype)) contiguous, of its shape and
    dtype, on the first one's device."""
    dev = inputs[0][1].device
    for name, t, shape, dtype in inputs:
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', strided'}")


def _ptrs(inputs) -> list:
    return [t.data_ptr() for _, t, _, _ in inputs]


#: (pointer, value) of a float scalar: a 0-d tensor of the state's dtype
#: by pointer, a number by value
_scalar = acopf_cuda._scalar


def _iteration(inner_iter, dev):
    """(pointer, value) of ``inner_iter``: a 0-d int64 tensor by pointer,
    an int by value."""
    if isinstance(inner_iter, torch.Tensor):
        if (inner_iter.dim() != 0 or inner_iter.dtype != torch.int64
                or inner_iter.device != dev):
            raise ValueError(f"ramp_pack: inner_iter must be an int or a "
                             f"0-d int64 tensor on {dev}")
        return inner_iter.data_ptr(), 0
    return None, int(inner_iter)


def _dims(sol, model):
    """(T, ngen, nline (the line blocks' rows), nbus, dtype, device)."""
    u = sol.acopf.u
    return (model.T, model.grid.ngen, u.line.shape[1], model.grid.nbus,
            u.gen.dtype, u.gen.device)


def _blocks(sol, model, *keys) -> list:
    """The state's (T, ngen, 2) and (T, nline, 8) blocks of ``keys``, as
    kernel inputs."""
    T, ngen, nline, _, dtype, _ = _dims(sol, model)
    out = []
    for k in keys:
        b = getattr(sol.acopf, k)
        out += [(f"{k}.gen", b.gen, (T, ngen, 2), dtype),
                (f"{k}.line", b.line, (T, nline, 8), dtype)]
    return out


def _gens(sol, model, *keys) -> list:
    """The state's (T, ngen, 2) generator blocks of ``keys``."""
    T, ngen, _, _, dtype, _ = _dims(sol, model)
    return [(f"{k}.gen", getattr(sol.acopf, k).gen, (T, ngen, 2), dtype)
            for k in keys]


def _ramp(sol, model, *keys) -> list:
    """The ramp state's (T, ngen) rows of ``keys``."""
    T, ngen, _, _, dtype, _ = _dims(sol, model)
    return [(f"ramp.{k}", getattr(sol.ramp, k), (T, ngen), dtype)
            for k in keys]


def _grid(sol, model, *keys) -> list:
    """The grid's (ngen,) generator arrays of ``keys``, in the state's
    dtype."""
    gd = model.grid
    dtype = sol.acopf.u.gen.dtype
    return [(k, getattr(gd, k), (gd.ngen,), dtype) for k in keys]


def _empty_blocks(sol) -> Blocks:
    u = sol.acopf.u
    return Blocks(gen=torch.empty_like(u.gen), line=torch.empty_like(u.line))


# ---- the ramp batch: pack and unpack

def ramp_pack(sol, model, inner_iter):
    """``ramp.ramp_pack_plain`` in one launch (``mp_ramp_pack``): x0, xl, xu
    (3, B), the (9, B) parameter block, lam0 (1, B), mu0 (B,) and the uint8
    flags (B,) of the B = (T - 1) ngen ramp lanes. Needs T > 1."""
    inputs = (_gens(sol, model, "u", "v", "z", "l", "rho")
              + _ramp(sol, model, "u", "s", "l", "rho", "z", "alm_mu",
                      "alm_xi")
              + _grid(sol, model, "c2", "c1", "pgmin", "pgmax", "ramp_rate"))
    if not _route("ramp_pack", inputs):
        from ..models.mpacopf.ramp import ramp_pack_plain
        return ramp_pack_plain(sol, model, inner_iter)
    T, ngen, _, _, dtype, dev = _dims(sol, model)
    if T < 2:
        raise ValueError("ramp_pack: one period has no ramp batch")
    B = (T - 1) * ngen
    it_p, it_v = _iteration(inner_iter, dev)

    def out(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = [out(3, B), out(3, B), out(3, B), out(9, B), out(1, B), out(B),
            torch.empty(B, dtype=torch.uint8, device=dev)]
    _launch("mp_ramp_pack", dev, dtype, *_ptrs(inputs),
            *[t.data_ptr() for t in outs], B, ngen, it_p, it_v,
            float(model.par.obj_scale), float(model.grid.baseMVA))
    return tuple(outs)


def generator_unpack(sol, model, res):
    """``model.generator_unpack_plain`` in one launch
    (``mp_generator_unpack``): (u_gen (T, ngen, 2), the new RampState).
    ``res`` is the ramp batch's result, None with T == 1 (the ramp state
    then comes back as it was)."""
    T, ngen, _, _, dtype, dev = _dims(sol, model)
    inputs = (_gens(sol, model, "v", "z", "l", "rho")
              + _grid(sol, model, "pgmin", "pgmax", "qgmin", "qgmax", "c2",
                      "c1")
              + _ramp(sol, model, "alm_xi"))
    if T > 1:
        B = (T - 1) * ngen
        inputs += [("res.x", res.x, (3, B), dtype),
                   ("res.lam", res.lam, (1, B), dtype),
                   ("res.mu", res.mu, (B,), dtype)]
    if not _route("generator_unpack", inputs):
        from ..models.mpacopf.model import generator_unpack_plain
        return generator_unpack_plain(sol, model, res)
    if T == 1 and res is not None:
        raise ValueError("generator_unpack: one period has no ramp batch")
    rp, gd = sol.ramp, model.grid
    u = torch.empty((T, ngen, 2), dtype=dtype, device=dev)
    if T > 1:
        new = {k: torch.empty((T, ngen), dtype=dtype, device=dev)
               for k in ("u", "s", "alm_mu", "alm_xi")}
        ptrs = _ptrs(inputs) + [u.data_ptr()] + [t.data_ptr()
                                                 for t in new.values()]
        ramp_new = rp.replace(**new)
    else:
        ptrs = _ptrs(inputs) + [None] * 3 + [u.data_ptr()] + [None] * 4
        ramp_new = rp
    base = float(gd.baseMVA)
    _launch("mp_generator_unpack", dev, dtype, *ptrs, T, ngen,
            float(model.par.obj_scale), base, base ** 2)
    return u, ramp_new


# ---- the bus update

def fold_periods(vals):
    """(T, R, C) rows of T periods as the (R, T * C) rows that one
    ``bus_scatter`` sums column by column (``bus_scatter_periods``'
    layout)."""
    T, R, C = vals.shape
    return vals.permute(1, 0, 2).reshape(R, T * C)


def unfold_periods(sums, T: int):
    """(nseg, T * C) folded sums as the (T, nseg, C) view that
    ``bus_scatter_periods`` returns."""
    return sums.reshape(sums.shape[0], T, -1).permute(1, 0, 2)


def bus_values_plain(sol, model):
    """The plain version of ``bus_values``: ``kernels.bus_arc_values`` and
    ``kernels.bus_gen_values`` with the next period's ramp terms, folded."""
    ac = sol.acopf
    arcs = kernels.bus_arc_values(ac.u, ac.z, ac.l, ac.rho, model.grid)
    gens = kernels.bus_gen_values(ac.u, ac.z, ac.l, ac.rho,
                                  model.next_ramp(sol.ramp))
    return fold_periods(arcs), fold_periods(gens)


def _values_inputs(sol, model) -> list:
    """The state's inputs of the bus values and the writeback: the u, z, l,
    rho blocks and the ramp's u, z, l, rho."""
    return (_blocks(sol, model, "u", "z", "l", "rho")
            + _ramp(sol, model, "u", "z", "l", "rho"))


def _grid_inputs(sol, model, Pd, Qd) -> list:
    """The grid's and the loads' inputs of the bus kernels, in the state's
    dtype: the line mask, the (T, nbus) loads, the shunts and the int64
    index arrays."""
    T, ngen, nline, nbus, dtype, _ = _dims(sol, model)
    gd = model.grid
    return [("line_mask", gd.line_mask, (nline,), dtype),
            ("Pd", Pd, (T, nbus), dtype), ("Qd", Qd, (T, nbus), dtype),
            ("YshR", gd.YshR, (nbus,), dtype),
            ("YshI", gd.YshI, (nbus,), dtype),
            ("line_from", gd.line_from, (nline,), torch.int64),
            ("line_to", gd.line_to, (nline,), torch.int64),
            ("gen_bus", gd.gen_bus, (ngen,), torch.int64)]


def bus_values(sol, model):
    """(arcs (2 nline, T * 8), gens (ngen, T * 4)): every period's arc and
    generator values, period t + 1's ramp terms blended into period t's pg
    rows, folded into the channels, in one launch (``mp_bus_values``)."""
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    inputs = _values_inputs(sol, model) + [
        ("line_mask", model.grid.line_mask, (nline,), dtype)]
    if not _route("bus_values", inputs):
        return bus_values_plain(sol, model)
    arcs = torch.empty((2 * nline, T * 8), dtype=dtype, device=dev)
    gens = torch.empty((ngen, T * 4), dtype=dtype, device=dev)
    _launch("mp_bus_values", dev, dtype, *_ptrs(inputs), arcs.data_ptr(),
            gens.data_ptr(), T, nline, ngen)
    return arcs, gens


def bus_solve_plain(agg, gsum, gd, Pd, Qd):
    """The plain version of ``bus_solve``: ``kernels.bus_solve`` on the
    (T, nbus, C) views of the folded sums."""
    T = Pd.shape[0]
    return kernels.bus_solve(unfold_periods(agg, T), unfold_periods(gsum, T),
                             gd, Pd, Qd)


def bus_solve(agg, gsum, gd, Pd, Qd):
    """The (T, nbus, 4) rows [wi, ti, mu1, mu2] of every period from the
    folded arc sums ``agg`` (nbus, T * 8) and generator sums ``gsum``
    (nbus, T * 4) and the (T, nbus) loads, in one launch
    (``mp_bus_solve``)."""
    dtype = agg.dtype
    T, nbus = Pd.shape[0], gd.nbus
    inputs = [("agg", agg, (nbus, T * 8), dtype),
              ("gsum", gsum, (nbus, T * 4), dtype),
              ("Pd", Pd, (T, nbus), dtype), ("Qd", Qd, (T, nbus), dtype),
              ("YshR", gd.YshR, (nbus,), dtype),
              ("YshI", gd.YshI, (nbus,), dtype)]
    if not _route("bus_solve", inputs):
        return bus_solve_plain(agg, gsum, gd, Pd, Qd)
    wtm = torch.empty((T, nbus, 4), dtype=dtype, device=agg.device)
    _launch("mp_bus_solve", agg.device, dtype, *_ptrs(inputs),
            wtm.data_ptr(), T, nbus,
            acopf_cuda.host_reciprocal(gd.baseMVA, dtype))
    return wtm


def bus_writeback(sol, model, wtm) -> Blocks:
    """The new v of every period from the buses' (T, nbus, 4) rows ``wtm``,
    the ramp blend in the pg rows, in one launch (``mp_bus_writeback``)."""
    T, ngen, nline, nbus, dtype, dev = _dims(sol, model)
    gd = model.grid
    ac = sol.acopf
    inputs = _values_inputs(sol, model) + [
        ("wtm", wtm, (T, nbus, 4), dtype),
        ("line_from", gd.line_from, (nline,), torch.int64),
        ("line_to", gd.line_to, (nline,), torch.int64),
        ("gen_bus", gd.gen_bus, (ngen,), torch.int64)]
    if not _route("bus_writeback", inputs):
        return kernels.bus_writeback(ac.u, ac.z, ac.l, ac.rho, wtm, gd,
                                     model.next_ramp(sol.ramp))
    v = _empty_blocks(sol)
    _launch("mp_bus_writeback", dev, dtype, *_ptrs(inputs), v.gen.data_ptr(),
            v.line.data_ptr(), T, nline, ngen, nbus)
    return v


def bus_update(sol, model, Pd, Qd) -> Blocks:
    """``model.bus_update_plain``: three launches around the two bus
    scatters of all periods and, with the lines split over a mesh, the
    all-reduce of the arc sums. The three kernels' state, grid and load
    inputs are checked before any launch."""
    inputs = _values_inputs(sol, model) + _grid_inputs(sol, model, Pd, Qd)
    if not _route("bus_update", inputs):
        from ..models.mpacopf.model import bus_update_plain
        return bus_update_plain(sol, model, Pd, Qd)
    gd = model.grid
    arcs, gens = bus_values(sol, model)
    agg = all_reduce_sum(bus_cuda.bus_scatter(
        arcs, gd.arc_bus, gd.arc_ptr, gd.arc_idx), gd.mesh)
    gsum = bus_cuda.bus_scatter(gens, gd.gen_bus, gd.gen_ptr, gd.gen_idx)
    return bus_writeback(sol, model, bus_solve(agg, gsum, gd, Pd, Qd))


# ---- z, l, lz

def z_update(sol, model, beta):
    """``model.z_update_plain`` in one launch (``mp_z``): (z, the ramp's
    z)."""
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    inputs = (_blocks(sol, model, "u", "v", "l", "rho", "lz")
              + _ramp(sol, model, "u", "l", "rho", "lz"))
    if not _route("z_update", inputs):
        from ..models.mpacopf.model import z_update_plain
        return z_update_plain(sol, model, beta)
    z = _empty_blocks(sol)
    z_r = torch.empty_like(sol.ramp.z)
    ptrs = _ptrs(inputs)
    _launch("mp_z", dev, dtype, *ptrs[:10], z.gen.data_ptr(),
            z.line.data_ptr(), *ptrs[10:], z_r.data_ptr(), T, nline, ngen,
            *_scalar(beta, "z_update", dtype, dev))
    return z, z_r


def l_update(sol, model, beta):
    """``model.l_update_plain`` in one launch (``mp_l``): (l, the ramp's
    l)."""
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    inputs = (_blocks(sol, model, "z", "lz")
              + _ramp(sol, model, "z", "lz"))
    if not _route("l_update", inputs):
        from ..models.mpacopf.model import l_update_plain
        return l_update_plain(sol, model, beta)
    out = _empty_blocks(sol)
    out_r = torch.empty_like(sol.ramp.l)
    ptrs = _ptrs(inputs)
    _launch("mp_l", dev, dtype, *ptrs[:4], out.gen.data_ptr(),
            out.line.data_ptr(), *ptrs[4:], out_r.data_ptr(), T, nline, ngen,
            *_scalar(beta, "l_update", dtype, dev))
    return out, out_r


def lz_update(sol, model, beta):
    """``model.lz_update_plain`` in one launch (``mp_lz``): (lz, the ramp's
    lz), clamped to +-``par.MAX_MULTIPLIER``."""
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    inputs = (_blocks(sol, model, "z", "lz")
              + _ramp(sol, model, "z", "lz"))
    if not _route("lz_update", inputs):
        from ..models.mpacopf.model import lz_update_plain
        return lz_update_plain(sol, model, beta)
    cap = float(model.par.MAX_MULTIPLIER)
    out = _empty_blocks(sol)
    out_r = torch.empty_like(sol.ramp.lz)
    ptrs = _ptrs(inputs)
    _launch("mp_lz", dev, dtype, *ptrs[:4], out.gen.data_ptr(),
            out.line.data_ptr(), *ptrs[4:], out_r.data_ptr(), T, nline, ngen,
            *_scalar(beta, "lz_update", dtype, dev), -cap, cap)
    return out, out_r


# ---- the residual

def residual_blocks(ngen: int, nline: int) -> int:
    """Blocks of the residual's first pass over one period's 3 ngen +
    8 nline elements."""
    return -(-(3 * ngen + 8 * nline) // THREADS)


def _partials_inputs(sol, model) -> list:
    _, _, nline, _, dtype, _ = _dims(sol, model)
    return (_blocks(sol, model, "u", "v", "z", "z_prev")
            + _ramp(sol, model, "u", "z", "z_prev")
            + [("line_mask", model.grid.line_mask, (nline,), dtype)]
            + _grid(sol, model, "c2", "c1", "c0"))


def residual_partials(sol, model):
    """(rp, rd, part): rp and rd, and the (13, T, nblocks) block sums of
    the residual's first pass (``mp_residual_partials``); on the CPU
    ``residual_partials_plain``."""
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    gd = model.grid
    inputs = _partials_inputs(sol, model)
    if not _route("residual_partials", inputs):
        return residual_partials_plain(sol, model)
    nb = residual_blocks(ngen, nline)
    rp, rd = _empty_blocks(sol), _empty_blocks(sol)
    part = torch.empty((LINE_SUMS + REST_SUMS, T, nb), dtype=dtype,
                       device=dev)
    _launch("mp_residual_partials", dev, dtype, *_ptrs(inputs),
            rp.gen.data_ptr(), rp.line.data_ptr(), rd.gen.data_ptr(),
            rd.line.data_ptr(), part.data_ptr(), T, nline, ngen, nb,
            float(gd.baseMVA))
    return rp, rd, part


def residual_final(line_part, rest_part):
    """The (6,) scalars ``SCALARS`` from the block sums: the (4, T,
    nblocks) line rows (all-reduced over a mesh) and the (9, T, nblocks)
    generator, ramp and objective rows (``mp_residual_final``); on the CPU
    ``residual_final_plain``."""
    _, T, nb = line_part.shape
    dtype = line_part.dtype
    inputs = [("line_part", line_part, (LINE_SUMS, T, nb), dtype),
              ("rest_part", rest_part, (REST_SUMS, T, nb), dtype)]
    if not _route("residual_final", inputs):
        return residual_final_plain(line_part, rest_part)
    out = torch.empty(len(SCALARS), dtype=dtype, device=line_part.device)
    _launch("mp_residual_final", line_part.device, dtype, *_ptrs(inputs), T,
            nb, out.data_ptr())
    return out


def residual_update(sol, model, beta):
    """``model.residual_update_plain``: (rp, rd, scalars) in two launches,
    with the line rows of the block sums all-reduced between them under a
    mesh; the scalars are 0-d views of one (6,) tensor. ``beta`` is not
    read: the multi-period ``auglag`` is the objective."""
    del beta
    if not _route("residual_update", _partials_inputs(sol, model)):
        from ..models.mpacopf.model import residual_update_plain
        return residual_update_plain(sol, model)
    rp, rd, part = residual_partials(sol, model)
    line = all_reduce_sum(part[:LINE_SUMS], model.grid.mesh)
    out = residual_final(line, part[LINE_SUMS:])
    return rp, rd, dict(zip(SCALARS, out.unbind()))


# ---- the residual's fixed tree, as torch ops (the kernels' plain versions)

def _terms(sol, model):
    """rp, rd and the (13, T, n) per-element terms of the residual's sums
    over each period's stacked [gen; ramp; line] elements, in the kernel's
    row order."""
    ac, rpm = sol.acopf, sol.ramp
    gd = model.grid
    T, ngen, nline, _, dtype, dev = _dims(sol, model)
    rp = Blocks(gen=ac.u.gen - ac.v.gen + ac.z.gen,
                line=ac.u.line - ac.v.line + ac.z.line)
    rd = Blocks(gen=ac.z.gen - ac.z_prev.gen,
                line=ac.z.line - ac.z_prev.line)

    def squares(r, d, z):
        ax = r - z
        return [r * r, d * d, z * z, ax * ax]

    m = gd.line_mask[:, None]
    line = [t * m for t in squares(rp.line, rd.line, ac.z.line)]
    gen = squares(rp.gen, rd.gen, ac.z.gen)
    mask = model.ramp_mask
    rp_r = (rpm.u - model._v_pg_prev(ac) + rpm.z) * mask
    rd_r = (rpm.z - rpm.z_prev) * mask
    z_r = rpm.z * mask
    d_r = rp_r - z_r
    ramp = [rp_r * rp_r, rd_r * rd_r, z_r * z_r, d_r * d_r]
    pg = ac.u.gen[..., 0] * gd.baseMVA
    obj = torch.zeros_like(ac.u.gen)
    obj[..., 0] = gd.c2 * (pg * pg) + gd.c1 * pg + gd.c0

    n2, n3 = 2 * ngen, 3 * ngen
    terms = torch.zeros((LINE_SUMS + REST_SUMS, T, n3 + 8 * nline),
                        dtype=dtype, device=dev)
    for r in range(4):
        terms[r, :, n3:] = line[r].reshape(T, -1)
        terms[4 + r, :, :n2] = gen[r].reshape(T, -1)
        terms[8 + r, :, n2:n3] = ramp[r]
    terms[12, :, :n2] = obj.reshape(T, -1)
    return rp, rd, terms


def residual_partials_plain(sol, model):
    """``mp_residual_partials`` as torch ops: (rp, rd, part), the (13, T,
    nblocks) block sums by the kernel's tree (a shuffle-down tree per warp
    of 32 elements, then the block's warps added in order)."""
    rp, rd, terms = _terms(sol, model)
    R, T, n = terms.shape
    nb = residual_blocks(model.grid.ngen, sol.acopf.u.line.shape[1])
    terms = torch.cat([terms, terms.new_zeros((R, T, nb * THREADS - n))], 2)
    warps = acopf_cuda._shuffle_tree(terms.reshape(R, T, nb, THREADS // 32,
                                                   32))
    part = warps[..., 0]
    for w in range(1, THREADS // 32):
        part = part + warps[..., w]
    return rp, rd, part


def residual_final_plain(line_part, rest_part):
    """``mp_residual_final`` as torch ops: each (row, period)'s block sums
    added as the kernel's warp adds them (lane l the blocks l, l + 32, ...
    in order, then a shuffle-down tree); per period the square roots of
    (generator + line) + ramp and their maximum over the periods; the
    objective summed over the periods in order."""
    part = torch.cat([line_part, rest_part])
    R, T, nb = part.shape
    laps = -(-nb // 32)
    part = torch.cat([part, part.new_zeros((R, T, laps * 32 - nb))], 2)
    part = part.reshape(R, T, laps, 32)
    acc = torch.zeros_like(part[:, :, 0])
    for k in range(laps):
        acc = acc + part[:, :, k]
    tot = acopf_cuda._shuffle_tree(acc)   # (13, T)
    norms = [torch.amax(torch.sqrt((tot[4 + k] + tot[k]) + tot[8 + k]))
             for k in range(4)]
    obj = tot[12, 0]
    for t in range(1, T):
        obj = obj + tot[12, t]
    return torch.stack(norms + [obj, obj])
