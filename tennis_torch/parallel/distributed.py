r"""Multi-process entry: ``torch.distributed`` wiring (counterpart of
``tennis_tpu/parallel/distributed.py``).

The JAX package runs one process per host and spreads a global batch over
the host's devices with GSPMD. The port runs one process per GPU:

1. :func:`launch` starts a host's ranks, one per local GPU (``cuda:r``) or
   ``--num_devices`` gloo ranks on the CPU: the calling process is local
   rank 0, the others are spawned. Host ``h`` of a run gives local rank
   ``r`` the global rank ``h * local + r``;
2. every rank calls :func:`initialize_multihost` (``init_process_group``
   over ``tcp://<coordinator>``: NCCL for a GPU, gloo for the CPU) before
   its first collective;
3. the loaders stripe each epoch's seeded permutation over the whole world
   (``num_shards = world``, ``shard_id = rank``), so global batch k holds
   the samples of a single-process batch k and every rank runs the same
   number of batches, hence the same collectives.

Example 2-host run, 8 GPUs each:

    # host 0                                  # host 1
    python -m tennis_torch.train --multihost \  python -m tennis_torch.train --multihost \
        --coordinator=10.0.0.1:1234 \             --coordinator=10.0.0.1:1234 \
        --num_hosts=2 --host_id=0 ...             --num_hosts=2 --host_id=1 ...

:func:`fetch_global` all-gathers equal-shaped rows to the host in rank
order (a collective: every rank calls it at the same point);
:func:`fetch_local` returns this rank's rows and runs no collective. There
is no quiet fallback: a missing NCCL, a failed ``init_process_group`` or
too few GPUs raises, and a failed collective is not caught.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from tennis_torch.parallel.mesh import World, batch_leaves, rebuild_batch


def grouped() -> bool:
    """Whether a process group exists (collectives run only then)."""
    return dist.is_available() and dist.is_initialized()


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, device: str = "cuda",
                         local_rank: int = 0,
                         timeout_s: float = 1800.0) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through a TCP store at ``coordinator_address``
    (``host:port``, served by rank 0): NCCL on ``cuda:<local_rank>``, which
    becomes the current device, for a GPU; gloo for the CPU. Returns
    quietly when a group already exists."""
    if grouped():
        return
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator host:port, "
                         "--num_hosts and --host_id")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch build")
        if local_rank >= torch.cuda.device_count():
            raise ValueError(f"local rank {local_rank} has no GPU "
                             f"({torch.cuda.device_count()} present)")
        torch.cuda.set_device(local_rank)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def shutdown() -> None:
    """Leave the process group, if any."""
    if grouped():
        dist.destroy_process_group()


def current_world(device: str | torch.device = "cpu") -> World:
    """The world this process is in: the process group's rank and size on
    the current GPU, ``cuda:<local rank>`` (or the CPU), or a single rank
    without a group."""
    device = torch.device(device)
    if not grouped():
        return World(device=device)
    local = 0
    if device.type == "cuda":
        local = torch.cuda.current_device()
        device = torch.device("cuda", local)
    return World(dist.get_rank(), dist.get_world_size(), local, device, True)


def host_batch_slice(global_batch: int) -> int:
    """The per-rank batch of a global batch: it must divide by the world
    size."""
    world = dist.get_world_size() if grouped() else 1
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} must divide across "
                         f"{world} ranks")
    return global_batch // world


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def fetch_global(tree):
    """Host numpy rows of every rank, in rank order, for each array or
    tensor of ``tree`` (one, or a tuple or list): an all-gather of
    equal-shaped blocks, so a collective that every rank must reach at the
    same point. Without a group, this rank's rows."""
    if not grouped():
        return rebuild_batch(tree, [_host(x) for x in batch_leaves(tree)])
    nccl = dist.get_backend() == "nccl"
    out = []
    for x in batch_leaves(tree):
        t = torch.as_tensor(x).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.to(torch.device("cuda", torch.cuda.current_device())
                 if nccl else "cpu")
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        out.append(torch.cat(parts).cpu().numpy())
    return rebuild_batch(tree, out)


def fetch_local(tree):
    """This rank's rows of ``tree`` as host numpy; no collective."""
    return rebuild_batch(tree, [_host(x) for x in batch_leaves(tree)])


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the world, in place (one collective each); a
    no-op without a group."""
    if grouped():
        for t in tensors:
            dist.all_reduce(t)


def barrier(world: World) -> None:
    """Wait for every rank; a no-op without a group."""
    if world.grouped:
        if world.device.type == "cuda":
            dist.barrier(device_ids=[world.device.index])
        else:
            dist.barrier()


@contextlib.contextmanager
def main_rank_first(world: World):
    """Run the block on rank 0 first, then on the other ranks (a step that
    may change the experiment directory, as the resume's quarantine)."""
    if not world.is_main:
        barrier(world)
    yield
    if world.is_main:
        barrier(world)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _spawned(target, args, coordinator, world, rank, local_rank, device,
             threads):
    """A spawned rank: join the group, run ``target(*args)``, leave."""
    torch.set_num_threads(threads)
    initialize_multihost(coordinator, world, rank, device, local_rank)
    try:
        _resolve(target)(*args)
    finally:
        shutdown()


def launch(target: str, num_local: int, args: tuple = (), *,
           device: str = "cuda", coordinator: str | None = None,
           num_hosts: int = 1, host_id: int = 0):
    """Run ``target(*args)`` (``"module:function"``) on ``num_local`` ranks
    of this host, host ``host_id`` of ``num_hosts``: this process is local
    rank 0 and returns its result; local ranks 1.. are spawned processes
    (start method ``spawn``) on ``cuda:r`` or the CPU. Rank r of host h is
    global rank ``h * num_local + r``. A single-host run takes a free port
    on 127.0.0.1 for its coordinator. Raises if a spawned rank fails."""
    import multiprocessing as mp

    if coordinator is None:
        if num_hosts > 1:
            raise ValueError("a multi-host run needs --coordinator host:port")
        coordinator = f"127.0.0.1:{free_port()}"
    world = num_hosts * num_local
    base = host_id * num_local
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawned, daemon=False,
                         args=(target, args, coordinator, world, base + r, r,
                               device, torch.get_num_threads()))
             for r in range(1, num_local)]
    for p in procs:
        p.start()
    ok = False
    try:
        initialize_multihost(coordinator, world, base, device, 0)
        try:
            result = _resolve(target)(*args)
        finally:
            shutdown()
        ok = True
    finally:
        for p in procs:
            if not ok:
                p.terminate()
            p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"spawned ranks exited with {failed}")
    return result


def rank_environment(args, num_devices: int | None = None,
                     batch_size: int | None = None) -> tuple[int, dict]:
    """The ranks a driver's flags ask for: ``(local ranks, launch
    keywords)`` from ``--num_devices`` (``-1``: every local GPU, one rank
    on the CPU; ``num_devices`` in its place where the driver reads the
    flag otherwise), ``--device`` and ``--multihost`` with its
    ``--coordinator``, ``--num_hosts`` and ``--host_id``. A global
    ``batch_size`` that does not divide across the world raises
    ``ValueError``, as in the JAX drivers."""
    from tennis_torch.inference import resolve_device
    from tennis_torch.parallel.mesh import data_ranks

    device = resolve_device(args.device).type  # no GPU: raises
    local = data_ranks(args.num_devices if num_devices is None
                       else num_devices, device)
    kw = dict(device=device)
    if getattr(args, "multihost", False):
        if not args.coordinator or args.num_hosts is None \
                or args.host_id is None:
            raise ValueError("--multihost needs --coordinator host:port, "
                             "--num_hosts and --host_id")
        kw.update(coordinator=args.coordinator, num_hosts=args.num_hosts,
                  host_id=args.host_id)
    world = local * kw.get("num_hosts", 1)
    if batch_size is not None and batch_size % world:
        raise ValueError(f"--batch_size {batch_size} must divide across "
                         f"{world} devices")
    return local, kw


def run_ranks(target: str, args: tuple, local: int, kw: dict):
    """``target(*args)`` in this process alone when the run is one rank on
    one host, or when the caller already made the process group; else on
    every rank (:func:`launch`)."""
    if grouped() or local * kw.get("num_hosts", 1) == 1:
        return _resolve(target)(*args)
    return launch(target, local, args, **kw)
