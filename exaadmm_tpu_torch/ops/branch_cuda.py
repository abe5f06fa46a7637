"""The branch update's work around the TRON/ALM launch as CUDA kernels.

``csrc/branch_io.cu`` holds the pack and the unpack of the line batch,
where the plain versions (``models/acopf/branch.py``: ``branch_pack_plain``,
``branch_unpack_plain``) launch one kernel per slice, op, ``stack``, ``cat``
and cast. No TPU kernel is replaced: these are the counterparts of the
fusions XLA compiles from the JAX ``branch_update`` around its solver call
(``exaadmm_tpu/models/acopf/branch.py``):

- ``branch_pack``: one thread per lane writes x0, xl, xu, the (33, B)
  parameter block, lam0, mu0 and the uint8 flag (``branch_pack``);
- ``branch_unpack``: one thread per lane writes the new line rows, the
  widened ALM state (mixed precision), the lane steps and its block's
  stats partials (``branch_unpack``), then one block the (5,) stats
  (``branch_stats``), which also adds the batch's TRON steps to a fused
  loop's step counter when it has one (``utils/tracing.py``).

Two instances, with line limits (n = 6, ncon = 2) and without (the polar
batch, n = 4, ncon = 0), in three type pairs: fp64, fp32, and mixed (an
fp64 state, an fp32 solve). On a CUDA tensor a wrapper launches its
kernel(s); on a CPU tensor it runs the plain version; any other device, a
state dtype other than float32 or float64, or, on the card, a
non-contiguous input, a mixed dtype or a wrong shape raises. Every output
is bit-identical to the plain version on the card.

``inner_iter`` is a Python int in the host loop (by value) and a 0-d int64
tensor in the fused loop (by pointer: a replayed graph reads its value at
the time); it is never staged into a new tensor here. Nothing here reads
device data back, and no pointer is kept between calls: the grid's line
arrays are read as the model holds them at the call (a sorted fused loop
refills them in place).

Which models run these kernels: every caller of ``branch_update``, so the
single-period ACOPF (``ModelAcopf``), the multi-period model's T-period
batch and MPEC's line block, on every two-level path; not the QP
subproblem, whose batch is its own.

``launches`` counts the kernels' launches by name (``KERNELS``), a launch
that a fused driver's graph replays once per replay
(``graph_loop.count_launch``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.environment import BranchALMState
from . import _build, acopf_cuda, graph_loop

KERNELS = ("branch_pack", "branch_unpack", "branch_stats")
launches: dict = {}

#: threads of a block of the unpack (``kThreads``): one stats partial each
THREADS = 256
#: the entries of the (5,) stats, in ``branch_stats``' order
STATS = ("sum_auglag_it", "sum_minor_it", "max_cviol", "avg_auglag_it",
         "avg_minor_it")

_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
_SIGS = {
    # (u, v, z, l, rho, lam1, lam2, mu, Y x 8, fr_vm, to_vm, fr_va, to_va,
    #  rate_a, mask, x0, xl, xu, P, lam0, mu0, act, B, it_p, it_v, scale,
    #  stream)
    "branch_pack": [_P] * 29 + [_I, _P, _L, _D, _P],
    # (x, lam, mu, minor, alm, cviol, u_old, Y x 8, mask, act, u_new,
    #  lam_up, mu_up, lane_steps, part, B, nblocks, stream)
    "branch_unpack": [_P] * 22 + [_I, _I, _P],
}
#: (part, nblocks, 1/nline, out, steps, stream)
_STATS_SIG = [_P, _I, _D, _P, _P, _P]
#: (state dtype, solve dtype) -> entry suffix
_TYPES = {(torch.float64, torch.float64): "f64",
          (torch.float32, torch.float32): "f32",
          (torch.float64, torch.float32): "mixed"}
_INSTANCE = {True: "linelimit", False: "polar"}


def _add_launches(name: str, n: int) -> None:
    launches[name] = launches.get(name, 0) + n


def library():
    """The kernel library, built from ``csrc/branch_io.cu`` at first
    call."""
    sigs = {f"{k}_{inst}_{sfx}": sig for k, sig in _SIGS.items()
            for inst in _INSTANCE.values() for sfx in _TYPES.values()}
    sigs.update({f"branch_stats_{sfx}": _STATS_SIG for sfx in ("f64", "f32")})
    return _build.load("branch_io", sigs)


def _launch(name: str, entry: str, dev, *args) -> None:
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check(lib, err, entry)
    graph_loop.count_launch(functools.partial(_add_launches, name), name)


def _route(what: str, inputs) -> bool:
    """True to launch the kernel (inputs on the card), False to run the
    plain version (on the CPU); raises on anything a kernel cannot take.
    ``inputs`` are the kernel's (name, tensor, shape, dtype) inputs, the
    state's line rows first."""
    state = inputs[0][1]
    if state.dtype not in (torch.float32, torch.float64):
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
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}{'' if t.is_contiguous() else ', strided'}")


def _types(what: str, state_dtype, solve_dtype) -> str:
    key = (state_dtype, solve_dtype)
    if key not in _TYPES:
        raise TypeError(f"{what}: a {solve_dtype} solve of a {state_dtype} "
                        "state is not supported")
    return _TYPES[key]


def _iteration(inner_iter, dev):
    """(pointer, value) of ``inner_iter``: a 0-d int64 tensor by pointer,
    an int by value."""
    if isinstance(inner_iter, torch.Tensor):
        if (inner_iter.dim() != 0 or inner_iter.dtype != torch.int64
                or inner_iter.device != dev):
            raise ValueError(f"branch_pack: inner_iter must be an int or a "
                             f"0-d int64 tensor on {dev}")
        return inner_iter.data_ptr(), 0
    return None, int(inner_iter)


def _ys(gd, B: int, dtype) -> list:
    """The admittances, in Y_KEYS order."""
    from ..models.acopf.branch import Y_KEYS
    return [(k, getattr(gd, k), (B,), dtype) for k in Y_KEYS]


def pack_inputs(sol, gd) -> list:
    """The pack's inputs, in its argument order: the state's line rows of
    u, v, z, l, rho, the ALM state, the admittances, the four bound pairs,
    rate_a and the mask."""
    u = sol.u.line
    B, dtype = u.shape[0], u.dtype
    alm = sol.branch_alm
    return ([(k, getattr(sol, k).line, (B, 8), dtype)
             for k in ("u", "v", "z", "l", "rho")]
            + [(k, getattr(alm, k), (B,), dtype)
               for k in ("lam1", "lam2", "mu")]
            + _ys(gd, B, dtype)
            + [(k, getattr(gd, k), (B, 2), dtype) for k in (
                "fr_vm_bound", "to_vm_bound", "fr_va_bound", "to_va_bound")]
            + [("rate_a", gd.rate_a, (B,), dtype),
               ("line_mask", gd.line_mask, (B,), dtype)])


def unpack_inputs(res, sol, gd, active0, use_linelimit: bool,
                  out_dtype) -> list:
    """The unpack's inputs, in its argument order: the batch's result, the
    old line rows, the admittances, the mask and the flags."""
    u_old = sol.u.line
    B, solve = u_old.shape[0], res.x.dtype
    n, ncon = (6, 2) if use_linelimit else (4, 0)
    return ([("x", res.x, (n, B), solve), ("lam", res.lam, (ncon, B), solve),
             ("mu", res.mu, (B,), solve),
             ("minor_iters", res.minor_iters, (B,), torch.int32),
             ("alm_iters", res.alm_iters, (B,), torch.int32),
             ("cviol", res.cviol, (B,), solve),
             ("u_old", u_old, (B, 8), out_dtype)]
            + _ys(gd, B, out_dtype)
            + [("line_mask", gd.line_mask, (B,), out_dtype),
               ("active0", active0, (B,), torch.uint8)])


def _ptrs(inputs) -> list:
    return [t.data_ptr() for _, t, _, _ in inputs]


def branch_pack(sol, gd, par, inner_iter, use_linelimit: bool, solve_dtype):
    """``branch.branch_pack_plain`` in one launch (``branch_pack``): x0, xl,
    xu (n, B), the (33, B) parameter block, lam0 (ncon, B), mu0 (B,) in
    ``solve_dtype`` and the uint8 flag active0 (B,)."""
    inputs = pack_inputs(sol, gd)
    if not _route("branch_pack", inputs):
        from ..models.acopf.branch import branch_pack_plain
        return branch_pack_plain(sol, gd, par, inner_iter, use_linelimit,
                                 solve_dtype)
    u = sol.u.line
    dev, B = u.device, u.shape[0]
    sfx = _types("branch_pack", u.dtype, solve_dtype)
    it_p, it_v = _iteration(inner_iter, dev)
    n, ncon = (6, 2) if use_linelimit else (4, 0)

    def out(*shape):
        return torch.empty(shape, dtype=solve_dtype, device=dev)

    x0, xl, xu, P, lam0, mu0 = (out(n, B), out(n, B), out(n, B), out(33, B),
                                out(ncon, B), out(B))
    act = torch.empty(B, dtype=torch.uint8, device=dev)
    outs = [x0, xl, xu, P, lam0, mu0, act]
    if B > 0:   # an empty batch launches no kernel
        _launch("branch_pack",
                f"branch_pack_{_INSTANCE[use_linelimit]}_{sfx}", dev,
                *_ptrs(inputs), *[t.data_ptr() for t in outs], B, it_p,
                it_v, float(par.scale))
    return x0, xl, xu, P, lam0, mu0, act


def unpack_blocks(B: int) -> int:
    """Blocks of the unpack over B lanes: one stats partial each."""
    return -(-B // THREADS)


def branch_unpack(res, sol, gd, active0, use_linelimit: bool, out_dtype,
                  steps=None):
    """``branch.branch_unpack_plain`` in two launches (``unpack_partials``,
    ``branch_stats``): (u_new (B, 8), the new ALM state, lane_steps (B,)
    int32, the (5,) stats ``STATS``). The stats are this batch's, before
    any all-reduce; the ALM state is views of ``res`` (fp64 copies under
    mixed precision), or ``sol``'s without line limits. ``steps``, a 0-d
    int64 tensor or None, gets the stats' two sums added to it."""
    inputs = unpack_inputs(res, sol, gd, active0, use_linelimit, out_dtype)
    if not _route("branch_unpack", inputs[6:] + inputs[:6]):
        from ..models.acopf.branch import branch_unpack_plain
        return branch_unpack_plain(res, sol, gd, active0, use_linelimit,
                                   out_dtype, steps)
    u_new, new_alm, lane_steps, part = unpack_partials(
        res, sol, gd, active0, use_linelimit, out_dtype)
    return u_new, new_alm, lane_steps, branch_stats(part, gd.nline, steps)


def unpack_partials(res, sol, gd, active0, use_linelimit: bool, out_dtype):
    """The unpack's first launch (``branch_unpack``): (u_new, the new ALM
    state, lane_steps, the (3, nblocks) stats partials: each block's sums
    of ``alm_iters`` and ``minor_iters`` times the mask and its largest
    active violation). CUDA tensors only (``branch_unpack`` routes the CPU
    to the plain version first)."""
    inputs = unpack_inputs(res, sol, gd, active0, use_linelimit, out_dtype)
    validate("branch_unpack", inputs[6:] + inputs[:6])
    u_old = sol.u.line
    dtype, dev, B = out_dtype, u_old.device, u_old.shape[0]
    solve_dtype = res.x.dtype
    sfx = _types("branch_unpack", dtype, solve_dtype)
    u_new = torch.empty_like(u_old)
    widen = use_linelimit and solve_dtype != dtype
    lam_up = torch.empty((2, B), dtype=dtype, device=dev) if widen else None
    mu_up = torch.empty(B, dtype=dtype, device=dev) if widen else None
    lane_steps = torch.empty(B, dtype=torch.int32, device=dev)
    nb = unpack_blocks(B)
    part = torch.empty((3, nb), dtype=dtype, device=dev)
    if B > 0:   # an empty batch launches no kernel
        _launch("branch_unpack",
                f"branch_unpack_{_INSTANCE[use_linelimit]}_{sfx}", dev,
                *_ptrs(inputs), u_new.data_ptr(),
                None if lam_up is None else lam_up.data_ptr(),
                None if mu_up is None else mu_up.data_ptr(),
                lane_steps.data_ptr(), part.data_ptr(), B, nb)
    if use_linelimit:
        lam, mu = (lam_up, mu_up) if widen else (res.lam, res.mu)
        new_alm = BranchALMState(lam1=lam[0], lam2=lam[1], mu=mu)
    else:
        new_alm = sol.branch_alm
    return u_new, new_alm, lane_steps, part


def branch_stats(part, nline: int, steps=None):
    """The (5,) stats ``STATS`` from the unpack's (3, nblocks) partials in
    one launch (``branch_stats``), the averages over ``nline``; CUDA
    tensors only, as ``unpack_partials``. ``steps``, a 0-d int64 tensor on
    the same device or None, gets the two sums (the batch's TRON steps)
    added to it by the same launch."""
    dtype, dev = part.dtype, part.device
    nb = part.shape[1]
    inputs = [("part", part, (3, nb), dtype)]
    if steps is not None:
        inputs.append(("steps", steps, (), torch.int64))
    validate("branch_stats", inputs)
    out = torch.empty(len(STATS), dtype=dtype, device=dev)
    if nb == 0:
        return out.zero_()
    _launch("branch_stats", f"branch_stats_{_TYPES[(dtype, dtype)]}", dev,
            part.data_ptr(), nb, acopf_cuda.host_reciprocal(nline, dtype),
            out.data_ptr(), None if steps is None else steps.data_ptr())
    return out
