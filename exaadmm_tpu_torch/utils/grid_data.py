"""Grid data as tensors on one device.

Counterpart of ``exaadmm_tpu/utils/grid_data.py``: the same fields, the same
per-line bound layout and the same ``line_mask`` padding (padded lines point
at bus 0 and are masked out of every aggregate). It adds the bus adjacency as
CSR arrays, built on the host with numpy, which the bus-scatter kernel walks
(the reference's FrStart/FrIdx, ToStart/ToIdx and GenStart/GenIdx):

- ``arc_ptr`` (nbus+1,), ``arc_idx`` (2*nline,): the arcs of bus b are the
  rows ``arc_idx[arc_ptr[b]:arc_ptr[b+1]]`` of the stacked
  ``[from-side rows; to-side rows]`` line arrays (2*nline_padded rows), in
  ascending row order. Padded lines have no arcs.
- ``gen_ptr`` (nbus+1,), ``gen_idx`` (ngen,): the generators of each bus,
  ascending.
- ``arc_bus`` (2*nline_padded,): the bus of every stacked row, the segment
  ids that the plain version of the scatter adds over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .opfdata import OPFData


@dataclasses.dataclass
class GridData:
    nbus: int
    ngen: int
    nline: int          # real line count
    nline_padded: int   # padded line count (line arrays below use this)

    baseMVA: float

    # generators (ngen,)
    pgmin: torch.Tensor
    pgmax: torch.Tensor
    qgmin: torch.Tensor
    qgmax: torch.Tensor
    c2: torch.Tensor  # raw $/MW^2h (obj_scale applied by the model, not here)
    c1: torch.Tensor
    c0: torch.Tensor
    ramp_rate: torch.Tensor
    gen_bus: torch.Tensor  # int64

    # lines (nline_padded,)
    YffR: torch.Tensor
    YffI: torch.Tensor
    YttR: torch.Tensor
    YttI: torch.Tensor
    YftR: torch.Tensor
    YftI: torch.Tensor
    YtfR: torch.Tensor
    YtfI: torch.Tensor
    rate_a: torch.Tensor     # tight_factor * (rateA/baseMVA)^2, 1e3 if unlimited
    line_from: torch.Tensor  # int64 bus index (padded lines point at bus 0)
    line_to: torch.Tensor    # int64
    fr_vm_bound: torch.Tensor  # (nline_padded, 2) lo/hi
    to_vm_bound: torch.Tensor
    fr_va_bound: torch.Tensor
    to_va_bound: torch.Tensor
    line_mask: torch.Tensor  # 1.0 for real lines, 0.0 for padding

    # buses (nbus,)
    Pd: torch.Tensor   # MW (divided by baseMVA inside the bus update)
    Qd: torch.Tensor
    Vmin: torch.Tensor
    Vmax: torch.Tensor
    YshR: torch.Tensor
    YshI: torch.Tensor

    # bus adjacency (int32 CSR for the kernel, int64 ids for the plain sums)
    arc_ptr: torch.Tensor
    arc_idx: torch.Tensor
    arc_bus: torch.Tensor
    gen_ptr: torch.Tensor
    gen_idx: torch.Tensor

    def to(self, device) -> "GridData":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def build_csr(seg_ids: np.ndarray, nseg: int, valid=None):
    """(ptr, idx) of a segment-id array: the rows of segment s are
    ``idx[ptr[s]:ptr[s+1]]``, ascending. Rows where ``valid`` is False are
    left out."""
    seg_ids = np.asarray(seg_ids, dtype=np.int64)
    rows = np.arange(seg_ids.shape[0], dtype=np.int64)
    if valid is not None:
        rows = rows[np.asarray(valid, dtype=bool)]
    order = rows[np.argsort(seg_ids[rows], kind="stable")]
    counts = np.bincount(seg_ids[rows], minlength=nseg)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return ptr.astype(np.int32), order.astype(np.int32)


def build_grid_data(
    data: OPFData,
    *,
    tight_factor: float = 1.0,
    ramp_ratio: float = 0.02,
    pad_lines_to: int = 1,
    dtype=torch.float64,
    device="cpu",
) -> GridData:
    """Flatten an :class:`OPFData` into a :class:`GridData` on ``device``.

    - ``rate_a`` follows reference opfdata.jl:714: 1e3 when rateA==0, else
      ``tight_factor*(rateA/baseMVA)^2`` (limits are imposed on squared flows).
    - Va bounds are [-2pi, 2pi] except pinned to 0 at the reference bus
      (opfdata.jl:702-713).
    - ``ramp_rate = ramp_ratio * pgmax`` (acopf_model.jl:66-67).
    - ``pad_lines_to``: pad nline up to a multiple.
    """
    nline = data.nline
    npad = -(-nline // pad_lines_to) * pad_lines_to

    def padf(x, fill=0.0):
        x = np.asarray(x, dtype=np.float64)
        return np.concatenate([x, np.full(npad - nline, fill)])

    def padi(x):
        x = np.asarray(x, dtype=np.int64)
        return np.concatenate([x, np.zeros(npad - nline, dtype=np.int64)])

    rate_a = np.where(
        data.rateA == 0.0, 1.0e3, tight_factor * (data.rateA / data.baseMVA) ** 2
    )

    two_pi = 2.0 * np.pi
    fr_va_lo = np.where(data.line_from == data.bus_ref, 0.0, -two_pi)
    fr_va_hi = np.where(data.line_from == data.bus_ref, 0.0, two_pi)
    to_va_lo = np.where(data.line_to == data.bus_ref, 0.0, -two_pi)
    to_va_hi = np.where(data.line_to == data.bus_ref, 0.0, two_pi)

    def bound2(lo, hi, fill_lo=0.9, fill_hi=1.1):
        return np.stack([padf(lo, fill_lo), padf(hi, fill_hi)], axis=-1)

    mask = np.concatenate([np.ones(nline), np.zeros(npad - nline)])
    line_from = padi(data.line_from)
    line_to = padi(data.line_to)
    arc_bus = np.concatenate([line_from, line_to])
    arc_ptr, arc_idx = build_csr(arc_bus, data.nbus,
                                 valid=np.concatenate([mask, mask]) > 0.5)
    gen_ptr, gen_idx = build_csr(data.gen_bus, data.nbus)

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=device, dtype=dtype)

    def fi(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    return GridData(
        nbus=data.nbus,
        ngen=data.ngen,
        nline=nline,
        nline_padded=npad,
        baseMVA=float(data.baseMVA),
        pgmin=f(data.pgmin),
        pgmax=f(data.pgmax),
        qgmin=f(data.qgmin),
        qgmax=f(data.qgmax),
        c2=f(data.c2),
        c1=f(data.c1),
        c0=f(data.c0),
        ramp_rate=f(ramp_ratio * data.pgmax),
        gen_bus=fi(data.gen_bus),
        YffR=f(padf(data.YffR)),
        YffI=f(padf(data.YffI)),
        YttR=f(padf(data.YttR)),
        YttI=f(padf(data.YttI)),
        YftR=f(padf(data.YftR)),
        YftI=f(padf(data.YftI)),
        YtfR=f(padf(data.YtfR)),
        YtfI=f(padf(data.YtfI)),
        rate_a=f(padf(rate_a, 1.0e3)),
        line_from=fi(line_from),
        line_to=fi(line_to),
        fr_vm_bound=f(bound2(data.Vmin[data.line_from],
                             data.Vmax[data.line_from])),
        to_vm_bound=f(bound2(data.Vmin[data.line_to], data.Vmax[data.line_to])),
        fr_va_bound=f(bound2(fr_va_lo, fr_va_hi, -two_pi, two_pi)),
        to_va_bound=f(bound2(to_va_lo, to_va_hi, -two_pi, two_pi)),
        line_mask=f(mask),
        Pd=f(data.Pd),
        Qd=f(data.Qd),
        Vmin=f(data.Vmin),
        Vmax=f(data.Vmax),
        YshR=f(data.YshR),
        YshI=f(data.YshI),
        arc_ptr=fi(arc_ptr, torch.int32),
        arc_idx=fi(arc_idx, torch.int32),
        arc_bus=fi(arc_bus),
        gen_ptr=fi(gen_ptr, torch.int32),
        gen_idx=fi(gen_idx, torch.int32),
    )
