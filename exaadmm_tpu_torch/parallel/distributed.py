"""Joining a multi-process run, and the mesh over its ranks.

Counterpart of ``exaadmm_tpu/parallel/distributed.py``: where the JAX
package joins ``jax.distributed`` and lays one mesh over all devices, the
port joins a ``torch.distributed`` process group, one process per GPU, and
``parallel/sharding.py`` splits the lines over its ranks. The same program
runs on every rank:

    from exaadmm_tpu_torch.parallel import distributed
    mesh = distributed.initialize_and_make_mesh()   # under torchrun
    res = exaadmm_tpu_torch.solve_acopf(case, mesh=mesh, verbose=0, ...)

Nothing tells a process of a cluster but its arguments or the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them). On a single process with nothing to join,
``initialize`` creates nothing and the mesh has one rank, so the same script
runs everywhere. ``spawn_ranks`` starts the ranks of one host itself.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from .sharding import Mesh, line_window, make_mesh


def choose_backend(device, local_world_size: int = 1) -> str:
    """NCCL when the ranks are asked onto CUDA devices and each of the
    ``local_world_size`` ranks of this host has a card of its own, gloo
    otherwise (ranks on the CPU, or several ranks sharing one card, which
    NCCL refuses). Chosen from what was asked for, never by trying."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return ("nccl" if torch.cuda.device_count() >= local_world_size
            else "gloo")


def rank_device(device, rank: int) -> torch.device:
    """The device of local rank ``rank``: its own card where there are
    enough (``cuda:rank``), else the one asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        return torch.device("cuda", rank % n if n > 1 else 0)
    return dev


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda",
               timeout: float | None = None,
               local_world_size: int | None = None) -> None:
    """Join a ``torch.distributed`` process group.

    From the arguments (``init_method`` such as ``tcp://127.0.0.1:29500``,
    ``world_size``, ``rank``) or, without them, from the launcher's
    environment. A no-op when a group is already up; on a single process
    with nothing to join (no arguments and no ``RANK``/``WORLD_SIZE``) it
    creates nothing. ``device`` and ``local_world_size`` (the ranks of the
    run on this host: by default the launcher's ``LOCAL_WORLD_SIZE``, else
    1, so a run joined by address with one process per host and card gets
    NCCL) select the backend (``choose_backend``). ``timeout`` (seconds)
    bounds every collective, so a rank that left the loop early fails the
    others instead of hanging them."""
    if dist.is_initialized():
        return
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and not from_env:
        if world_size not in (None, 1):
            raise ValueError(
                f"world_size={world_size} asked for with no init_method and "
                "no RANK/WORLD_SIZE in the environment")
        return
    if init_method is None:
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    backend = choose_backend(device, local_world_size)
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(rank_device(device, local_rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def initialize_and_make_mesh(**init_kwargs) -> Mesh:
    """Join the run (if there is one) and return the mesh over all its
    ranks. The entry points pad the lines to the mesh size themselves."""
    initialize(**init_kwargs)
    return make_mesh()


def process_line_slice(nline_padded: int, mesh: Mesh | None = None) -> slice:
    """This process's contiguous window of the whole padded line batch (the
    reference's rank-local ``shift_lines`` offset, environment.jl:22-23);
    on one process it spans the batch."""
    return line_window(nline_padded, make_mesh() if mesh is None else mesh)


def free_port() -> int:
    """A TCP port of this host that is free now (found by binding port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, world_size, init_method, device, timeout,
               threads, queue):
    if threads is not None:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    initialize(init_method, world_size, rank, device=dev, timeout=timeout,
               local_world_size=world_size)
    try:
        out = fn(make_mesh(), dev, *args)
        if rank == 0:
            queue.put(out)
    finally:
        shutdown()


def spawn_ranks(fn, args=(), *, nprocs: int, device="cuda",
                timeout: float = 120.0, join_timeout: float | None = None,
                threads: int | None = None):
    """Run ``fn(mesh, device, *args)`` on ``nprocs`` new local processes that
    form one process group, and return rank 0's result.

    Rank r runs on ``cuda:r`` where every rank has a card, on the one card
    otherwise, or on the CPU with ``device="cpu"``. ``fn`` and ``args`` must
    pickle (a module-level function). ``timeout`` bounds each collective and
    ``join_timeout`` the whole run (by default ten times that); when it
    passes, or a rank fails, every rank is stopped and ``RuntimeError``
    raised, so a hang is a failure and not a stuck run. ``threads`` sets
    each rank's torch thread count."""
    import torch.multiprocessing as mp

    init_method = f"tcp://127.0.0.1:{free_port()}"
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_rank_main,
                   args=(fn, args, nprocs, init_method, str(device), timeout,
                         threads, queue),
                   nprocs=nprocs, join=False)
    deadline = time.monotonic() + (join_timeout or 10.0 * timeout)
    result = []
    try:
        # join() raises when a rank failed, after stopping the others; the
        # result is taken as soon as it is there, so that a large one does
        # not block rank 0 in its put()
        done = False
        while not done:
            done = ctx.join(timeout=0.5)
            if not queue.empty():
                result.append(queue.get())
            if not done and time.monotonic() > deadline:
                raise RuntimeError(
                    f"spawn_ranks: {nprocs} ranks did not finish in time")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    if not result:
        raise RuntimeError("spawn_ranks: rank 0 returned nothing")
    return result[0]
