"""Checkpoint / resume for solver state.

Counterpart of ``exaadmm_tpu/utils/checkpoint.py``, in the same file format:
any state record (``Solution``, ``SolutionMpacopf``, ``SolutionQpsub``, the
MPEC state) goes into one ``.npz`` whose keys are ``leaf{i}__{path}``, the
tensors in depth-first field order (the JAX pytree's flatten order, since
the port's records keep the JAX field order), plus a JSON ``__meta__`` as
``uint8``. A file written here loads with the JAX package's
``load_solution`` and the reverse. Loading restores into a structurally
identical template (from ``init_solution``), which gives dtype and device,
so a long solve can resume in another process:

    save_solution("ckpt.npz", sol, meta={"outer": info.outer, "beta": par.beta})
    sol, meta = load_solution("ckpt.npz", init_solution(model, rho_pq, rho_va))

Written with numpy only: ``torch.save`` would pickle the dataclasses, which
``torch.load`` refuses under its default ``weights_only=True``.

For a state split across ranks (``parallel/sharding.py``),
``save_solution_sharded`` / ``load_solution_sharded`` (the counterpart of
the JAX package's orbax pair) write a directory with one such ``.npz`` per
rank, each rank its own line window, and rank 0's ``meta.json``; nothing is
gathered to one rank.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _leaves(rec, prefix: str = ""):
    """(path, tensor) of every tensor in ``rec``, depth first in field
    order; the path joins the field names with '/'."""
    out = []
    for f in dataclasses.fields(rec):
        v = getattr(rec, f.name)
        if dataclasses.is_dataclass(v):
            out += _leaves(v, f"{prefix}{f.name}/")
        else:
            out.append((f"{prefix}{f.name}", v))
    return out


def _rebuild(template, leaves):
    """``template``'s structure over the tensors that ``leaves`` yields."""
    return dataclasses.replace(template, **{
        f.name: (_rebuild(getattr(template, f.name), leaves)
                 if dataclasses.is_dataclass(getattr(template, f.name))
                 else next(leaves))
        for f in dataclasses.fields(template)})


def save_solution(path: str, sol, meta: dict | None = None) -> None:
    arrays = {f"leaf{i}__{p}": v.detach().cpu().numpy()
              for i, (p, v) in enumerate(_leaves(sol))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_solution(path: str, template):
    """Restore a state saved by ``save_solution`` (here or by the JAX
    package) into ``template``'s structure; returns (state, meta). Dtype and
    device are the template's tensors'; a leaf-count or shape mismatch
    raises ``ValueError``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        keys = sorted((k for k in data.files if k != "__meta__"),
                      key=lambda k: int(k.split("__", 1)[0][4:]))
        stored = [data[k] for k in keys]

    t_leaves = [v for _, v in _leaves(template)]
    if len(stored) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, template has "
            f"{len(t_leaves)}")
    out = []
    for s, t in zip(stored, t_leaves):
        if s.shape != tuple(t.shape):
            raise ValueError(
                f"leaf shape mismatch: {s.shape} vs {tuple(t.shape)}")
        out.append(torch.as_tensor(s).to(device=t.device, dtype=t.dtype))
    return _rebuild(template, iter(out)), meta


def _rank_file(path: str, rank: int, size: int) -> str:
    return os.path.join(path, f"rank{rank:05d}-of-{size:05d}.npz")


def save_solution_sharded(path: str, sol, mesh=None,
                          meta: dict | None = None) -> None:
    """Save a rank's local state (``parallel/sharding.py::local_solution``)
    into the directory ``path``: every rank writes its own file, rank 0
    also ``meta.json`` (``meta`` and the mesh size). Call it on every rank
    (it ends with a barrier); with no mesh it writes a one-rank
    directory."""
    rank = 0 if mesh is None else mesh.rank
    size = 1 if mesh is None else mesh.size
    os.makedirs(path, exist_ok=True)
    save_solution(_rank_file(path, rank, size), sol)
    if rank == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"meta": meta or {}, "world_size": size}, f)
    if mesh is not None and mesh.group is not None:
        # no rank returns before every file is there
        torch.distributed.barrier(group=mesh.group)


def load_solution_sharded(path: str, template, mesh=None):
    """Restore this rank's local state from a directory written by
    ``save_solution_sharded`` on a mesh of the same size, into the rank's
    local ``template``; returns (state, meta)."""
    rank = 0 if mesh is None else mesh.rank
    size = 1 if mesh is None else mesh.size
    with open(os.path.join(path, "meta.json")) as f:
        head = json.load(f)
    if head["world_size"] != size:
        raise ValueError(
            f"checkpoint was written by {head['world_size']} ranks, the "
            f"mesh has {size}")
    sol, _ = load_solution(_rank_file(path, rank, size), template)
    return sol, head["meta"]
