"""The static buffers of a fused driver's loop.

A loop body that the device replays reads and writes the same addresses on
every trip, so the fused drivers keep their state in a ``Carry``: one
buffer for each tensor of the solution record (``Solution``,
``SolutionMpacopf``, ``SolutionMpec``, ``SolutionQpsub``: dataclasses of
tensors and records, walked in field order) and named buffers for the
loop's counters, scalars and flags (0-d) and for what else a loop carries
from trip to trip (a sorted loop's line order). A body computes the new state from
``carry.sol`` as the host loop does, then stores it back (``store``); after
the loop the driver reads the scalars back in one copy (``read_back``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import tracing


def leaves(rec) -> list:
    """The tensors of a record, depth first in field order."""
    if isinstance(rec, torch.Tensor):
        return [rec]
    out = []
    for f in dataclasses.fields(rec):
        out += leaves(getattr(rec, f.name))
    return out


def rebuild(rec, tensors):
    """``rec`` with its tensors taken in ``leaves`` order from the iterator
    ``tensors``."""
    if isinstance(rec, torch.Tensor):
        return next(tensors)
    return dataclasses.replace(rec, **{
        f.name: rebuild(getattr(rec, f.name), tensors)
        for f in dataclasses.fields(rec)})


class Carry:
    """Buffers for the tensors of ``template`` (cloned from it) and for the
    tensors ``scalars`` (name -> initial tensor, cloned)."""

    def __init__(self, template, scalars: dict):
        self.template = template
        self.state = [t.clone() for t in leaves(template)]
        self.v = {k: t.clone() for k, t in scalars.items()}

    def clone(self) -> "Carry":
        return Carry(self.sol, self.v)

    @property
    def sol(self):
        """The state as a record whose tensors are the buffers."""
        return rebuild(self.template, iter(self.state))

    def load(self, sol) -> None:
        """Copy the tensors of ``sol`` (a record shaped as the template)
        into the buffers."""
        src = leaves(sol)
        if [t.shape for t in src] != [t.shape for t in self.state] or [
                t.dtype for t in src] != [t.dtype for t in self.state]:
            raise ValueError("the solution does not match the shapes and "
                             "dtypes the fused loop was built for")
        for d, s in zip(self.state, src):
            d.copy_(s)

    def store(self, sol) -> None:
        """Store ``sol``, computed from ``self.sol``, into the buffers. A
        tensor that is already its own buffer is left alone; one that is
        another buffer or a view of one (``z_prev = z``) is copied out
        before any buffer is overwritten."""
        held = {t.untyped_storage().data_ptr() for t in self.state}
        src = [s if s is d or s.untyped_storage().data_ptr() not in held
               else s.clone() for d, s in zip(self.state, leaves(sol))]
        for d, s in zip(self.state, src):
            if s is not d:
                d.copy_(s)

    def store_where(self, cond, a, b) -> None:
        """Store ``where(cond, a, b)`` tensor by tensor (``a`` and ``b``
        records shaped as the template; where a tensor of ``b`` is that of
        ``a``, it is taken as it is)."""
        self.store(rebuild(self.template, iter([
            x if x is y else torch.where(cond, x, y)
            for x, y in zip(leaves(a), leaves(b))])))

    @tracing.spanned("loop.read_back")
    def read_back(self, keys, loop=None) -> dict:
        """The scalars ``keys`` as Python numbers, in one stacked copy from
        the device that also holds the launch counters of ``loop``'s last
        run (a ``graph_loop.GraphLoop``, or None), which go to the host's
        counts. It is the ``loop.read_back`` span when tracing is on."""
        vals = torch.stack([self.v[k].to(torch.float64) for k in keys])
        if loop is not None:
            vals = torch.cat([vals, loop.counts.values.to(torch.float64)])
        vals = vals.tolist()
        if loop is not None:
            loop.count(vals[len(keys):])
        return dict(zip(keys, vals))
