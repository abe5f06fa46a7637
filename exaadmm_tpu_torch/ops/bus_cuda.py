"""Bus scatter: rows summed into their bus, deterministically.

Replaces ``exaadmm_tpu/ops/bus_pallas.py::kr_scatter_pallas`` (the line->bus
aggregation of ``bus_update``) and serves the generator->bus sums of the same
update. ``out[b, c] = sum(vals[r, c] for the rows r of segment b)``:

- on a CUDA tensor, ``csrc/bus_scatter.cu`` walks the segment's CSR rows in
  ascending order, with no atomics, so the result is bit-identical from run
  to run (``index_add_`` on CUDA adds with atomics in no fixed order);
- on a CPU tensor, the plain version ``index_add_`` over the segment ids,
  which on the CPU adds the rows in the same ascending order.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_FN = {torch.float64: "bus_scatter_f64", torch.float32: "bus_scatter_f32"}
# (vals, ptr, idx, out, nseg, nch, stream)
_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def library():
    """The kernel library, built from ``csrc/bus_scatter.cu`` at first call."""
    return _build.load("bus_scatter", {fn: _SIG for fn in _FN.values()})


def bus_scatter_plain(vals: torch.Tensor, seg_ids: torch.Tensor,
                      nseg: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` of the rows into nseg."""
    out = torch.zeros((nseg, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg_ids, vals)


def bus_scatter(vals: torch.Tensor, seg_ids: torch.Tensor,
                ptr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) rows -> (nseg, C) segment sums, nseg = len(ptr) - 1.

    ``seg_ids`` (R,) gives each row's segment (the plain version adds over
    it); ``ptr``/``idx`` are the same map as int32 CSR (the kernel walks
    it). Rows absent from the CSR must be zero rows.
    """
    nseg = ptr.shape[0] - 1
    if vals.device.type == "cpu":
        return bus_scatter_plain(vals, seg_ids, nseg)
    if vals.device.type != "cuda":
        raise ValueError(f"bus_scatter: unsupported device {vals.device}")
    if vals.dtype not in _FN:
        raise TypeError(f"bus_scatter: dtype {vals.dtype} not supported")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("bus_scatter: vals must be a contiguous (R, C) tensor")
    for name, t in (("ptr", ptr), ("idx", idx)):
        if (t.device != vals.device or t.dtype != torch.int32
                or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(
                f"bus_scatter: {name} must be a contiguous int32 vector on "
                f"{vals.device}")
    global launches
    lib = library()
    out = torch.empty((nseg, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FN[vals.dtype])(
            vals.data_ptr(), ptr.data_ptr(), idx.data_ptr(), out.data_ptr(),
            nseg, vals.shape[1], stream)
    _build.check(lib, err, "bus_scatter")
    launches += 1
    return out
