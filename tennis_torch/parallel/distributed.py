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
3. the loaders stripe each epoch's seeded permutation over the data axis
   (``num_shards = data size``, ``shard_id = data index``; the whole world
   without a model axis), so global batch k holds the samples of a
   single-process batch k and every rank runs the same number of batches,
   hence the same collectives.

:func:`make_mesh` (the counterpart of the JAX ``make_mesh``) lays the
ranks out as a ``(data, model)`` grid and builds its subgroups, one model
group per data index and one data group per model index;
:func:`make_pod_mesh` keeps each model group inside a host. Every rank must
call them at the same point: each group is made by a collective over the
whole process group. The data-parallel collectives (the gradient mean, the
BN sums, the fetches) run over this rank's data group, the model axis's
(:func:`gather_blocks`, :func:`take_block`, :func:`to_model`,
:func:`reduce_model`, each with its own backward) over its model group.
Without a mesh the data axis is the whole group and there is no model
axis.

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

import collections
import contextlib
import datetime
import importlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from tennis_torch.parallel.mesh import World, batch_leaves, mesh_shape, \
    rebuild_batch

# the active (data, model) layout: its "shape", and every subgroup made so
# far by its ranks (a layout made again reuses the groups it shares)
_MESH: dict = {"shape": None, "groups": {}}


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
    """Leave the process group, if any, and forget its mesh."""
    _MESH.update(shape=None, groups={})
    if grouped():
        dist.destroy_process_group()


def current_world(device: str | torch.device = "cpu") -> World:
    """The world this process is in: its place in the mesh
    (:func:`make_mesh`; without one, the process group as the data axis)
    on the current GPU, ``cuda:<local rank>`` (or the CPU), or a single
    rank without a group. A rank outside a mesh smaller than the group
    raises ``ValueError``."""
    device = torch.device(device)
    if not grouped():
        return World(device=device)
    local = 0
    if device.type == "cuda":
        local = torch.cuda.current_device()
        device = torch.device("cuda", local)
    rank, size, model = dist.get_rank(), dist.get_world_size(), 1
    if _MESH["shape"] is not None:
        num_data, model = _MESH["shape"]
        size = num_data * model
        if rank >= size:
            raise ValueError(f"rank {rank} holds no place in the "
                             f"{num_data}x{model} mesh")
    return World(rank, size, local, device, True, model)


def make_mesh(num_data: int | None = None, num_model: int = 1,
              device: str | torch.device = "cpu") -> World | None:
    """Lay the process group out as a ``(num_data, num_model)`` mesh (the
    JAX ``make_mesh``: rank r at data index ``r // num_model``, model index
    ``r % num_model``; ``num_data`` None takes every rank; more ranks than
    the group has raise ``mesh wants N devices (DxM), have K``) and build
    its groups: one model group per data index, one data group per model
    index. A collective: every rank calls it, and every rank makes every
    group in the same order. Returns this rank's :class:`World`, or None
    on a rank that a smaller mesh leaves out (the JAX mesh takes the first
    devices)."""
    have = dist.get_world_size() if grouped() else 1
    num_data, num_model = mesh_shape(num_data, num_model, have)
    if not grouped():
        return World(device=torch.device(device))
    n = num_data * num_model
    layouts = ([list(range(d * num_model, (d + 1) * num_model))
                for d in range(num_data)]
               + [list(range(m, n, num_model)) for m in range(num_model)])
    groups = _MESH["groups"]
    for ranks in layouts:
        if tuple(ranks) not in groups:
            groups[tuple(ranks)] = dist.new_group(ranks)
    _MESH["shape"] = (num_data, num_model)
    if dist.get_rank() >= n:
        return None
    return current_world(device)


def make_pod_mesh(num_model: int = 1, num_local: int | None = None,
                  device: str | torch.device = "cpu") -> World | None:
    """A mesh over every rank with the model axis inside each host (the
    JAX ``make_pod_mesh``): ``num_local`` ranks a host (None: one host),
    host h holding global ranks ``h * num_local ...``, so that a model
    group never crosses hosts and only the data axis does. On several
    hosts ``num_model`` must divide ``num_local``."""
    have = dist.get_world_size() if grouped() else 1
    if num_local is not None and num_local < have and num_local % num_model:
        raise ValueError(f"num_model={num_model} must divide local device "
                         f"count {num_local}")
    return make_mesh(num_model=num_model, device=device)


def _group(ranks: list[int]):
    """The subgroup of ``ranks`` that :func:`make_mesh` built."""
    try:
        return _MESH["groups"][tuple(ranks)]
    except KeyError:
        raise RuntimeError(f"no mesh group holds ranks {ranks} "
                           f"(make_mesh first)") from None


def data_group(world: World | None = None):
    """This rank's data group for a collective: None (the default group)
    without a mesh, which keeps the data-parallel paths as they were."""
    if _MESH["shape"] is None:
        return None
    return _group((world or current_world()).data_group_ranks())


def model_group(world: World):
    """The model group of ``world``'s data index."""
    return _group(world.model_group_ranks())


# the model-axis collectives issued by the functions below, by kind
# ("all_gather", "sum", "max"); a count for tracing, reset by its reader
model_collectives: collections.Counter = collections.Counter()


def _counted_model_group(world: World, kind: str):
    model_collectives[kind] += 1
    return model_group(world)


def host_batch_slice(global_batch: int) -> int:
    """The per-rank batch of a global batch: it must divide by the data
    size (the model ranks of a data index hold the same rows)."""
    n = current_world().data_size if grouped() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide across "
                         f"{n} ranks")
    return global_batch // n


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def fetch_global(tree):
    """Host numpy rows of every data index, in data order, for each array
    or tensor of ``tree`` (one, or a tuple or list): an all-gather of
    equal-shaped blocks over this rank's data group (one replica of each
    data index; the whole group without a mesh), so a collective that
    every rank must reach at the same point. Without a group, this rank's
    rows."""
    if not grouped():
        return rebuild_batch(tree, [_host(x) for x in batch_leaves(tree)])
    nccl = dist.get_backend() == "nccl"
    world = current_world()
    group = data_group(world)
    out = []
    for x in batch_leaves(tree):
        t = torch.as_tensor(x).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.to(torch.device("cuda", torch.cuda.current_device())
                 if nccl else "cpu")
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world.data_size)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.cat(parts).cpu().numpy())
    return rebuild_batch(tree, out)


def fetch_local(tree):
    """This rank's rows of ``tree`` as host numpy; no collective."""
    return rebuild_batch(tree, [_host(x) for x in batch_leaves(tree)])


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the data axis, in place (one collective each);
    a no-op without a group."""
    if grouped():
        group = data_group()
        for t in tensors:
            dist.all_reduce(t, group=group)


def _all_gather_cat(x: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world.model_size)]
    dist.all_gather(parts, x, group=_counted_model_group(world, "all_gather"))
    return torch.cat(parts, dim)


class _GatherBlocks(torch.autograd.Function):
    """All-gather of equal blocks along ``dim`` over the model group. The
    model ranks of a data index compute the same thing downstream, so the
    gradient arriving here is already whole on each: the backward takes
    this rank's block of it. Summing it over the group (a reduce-scatter)
    would count it ``model_size`` times."""

    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.world, ctx.dim = world, dim
        return _all_gather_cat(x, world, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.world.model_size
        return (g.narrow(ctx.dim, ctx.world.model_rank * n, n).contiguous(),
                None, None)


class _TakeBlock(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor the model ranks hold
    alike; the backward all-gathers the blocks' gradients, each of which
    only its own rank computed."""

    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.world, ctx.dim = world, dim
        n = x.shape[dim] // world.model_size
        return x.narrow(dim, world.model_rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.world, ctx.dim), None, None


class _ToModel(torch.autograd.Function):
    """A tensor the model ranks hold alike, entering a computation on this
    rank's block: the identity, whose backward sums the blocks' partial
    gradients over the model group."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=_counted_model_group(ctx.world, "sum"))
        return g, None


class _ReduceModel(torch.autograd.Function):
    """The sum of the blocks' partial results over the model group, which
    every model rank then holds alike: an all-reduce whose backward is the
    identity (the gradient arriving is already whole on each rank)."""

    @staticmethod
    def forward(ctx, x, world):
        x = x.clone()
        dist.all_reduce(x, group=_counted_model_group(world, "sum"))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_blocks(x: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``x`` along ``dim``, concatenated in
    model order (a collective over the model group)."""
    return _GatherBlocks.apply(x, world, dim)


def take_block(x: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, which must divide by the
    model size."""
    return _TakeBlock.apply(x, world, dim)


def to_model(x: torch.Tensor, world: World) -> torch.Tensor:
    """``x`` (alike on every model rank) into a block-local computation."""
    return _ToModel.apply(x, world)


def reduce_model(x: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of ``x`` over the model group."""
    return _ReduceModel.apply(x, world)


def max_model_(x: torch.Tensor, world: World) -> torch.Tensor:
    """The elementwise maximum over the model group, in place; no
    gradient."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX,
                    group=_counted_model_group(world, "max"))
    return x


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


def _join(coordinator, world, rank, local_rank, device, num_local,
          num_model):
    """Join the group as ``rank`` and, with a model axis, lay out the
    pod mesh."""
    initialize_multihost(coordinator, world, rank, device, local_rank)
    if num_model != 1:
        make_pod_mesh(num_model, num_local, device)


def _spawned(target, args, coordinator, world, rank, local_rank, device,
             threads, num_local=None, num_model=1):
    """A spawned rank: join the group, run ``target(*args)``, leave."""
    torch.set_num_threads(threads)
    _join(coordinator, world, rank, local_rank, device, num_local, num_model)
    try:
        _resolve(target)(*args)
    finally:
        shutdown()


def launch(target: str, num_local: int, args: tuple = (), *,
           device: str = "cuda", coordinator: str | None = None,
           num_hosts: int = 1, host_id: int = 0, num_model: int = 1):
    """Run ``target(*args)`` (``"module:function"``) on ``num_local`` ranks
    of this host, host ``host_id`` of ``num_hosts``: this process is local
    rank 0 and returns its result; local ranks 1.. are spawned processes
    (start method ``spawn``) on ``cuda:r`` or the CPU. Rank r of host h is
    global rank ``h * num_local + r``. With ``num_model`` above 1 every
    rank lays out the pod mesh (:func:`make_pod_mesh`) before ``target``
    runs. A single-host run takes a free port on 127.0.0.1 for its
    coordinator. Raises if a spawned rank fails."""
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
                               device, torch.get_num_threads(), num_local,
                               num_model))
             for r in range(1, num_local)]
    for p in procs:
        p.start()
    ok = False
    try:
        _join(coordinator, world, base, 0, device, num_local, num_model)
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
