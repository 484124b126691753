"""The data-parallel world and batch helpers (counterpart of
``tennis_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over the devices of a process
and shards each global batch over its ``data`` axis with GSPMD. The port
runs one process per GPU (one per CPU rank for the tests) joined by
``torch.distributed``: the ``data`` axis is the process group, and rank r
holds the rows that ``P("data")`` would place on device r. :class:`World`
describes that group as one process sees it; :func:`data_ranks` is the
counterpart of ``make_mesh``'s device count and its refusal to take more
devices than there are. ``tpu_compiler_options`` and
``driver_compiler_options`` configure XLA for the TPU and have no
counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel group: its global
    ``rank`` of ``size``, its ``local_rank`` on its host and the
    ``device`` it computes on. ``grouped`` is True once a process group
    exists (even of size 1): only then does any collective run."""
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    grouped: bool = False

    @property
    def is_main(self) -> bool:
        """Global rank 0, the one rank that writes an experiment's files."""
        return self.rank == 0


def data_ranks(num_data: int | None, device_type: str) -> int:
    """The number of local ranks for ``--num_devices``: every local GPU for
    None or a value below 1 (one rank on the CPU), else ``num_data``, which
    may not exceed the GPUs present (``make_mesh`` raises likewise). On the
    CPU any count of gloo ranks may run."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if num_data is None or num_data < 1:
            num_data = have
        if num_data > have:
            raise ValueError(f"mesh wants {num_data} devices, have {have}")
        return num_data
    return 1 if num_data is None or num_data < 1 else num_data


def batch_leaves(batch) -> list:
    """The arrays of ``batch``: one, or a tuple or list of them."""
    return list(batch) if isinstance(batch, (tuple, list)) else [batch]


def rebuild_batch(batch, leaves):
    """``leaves`` in the form of ``batch`` (:func:`batch_leaves`)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(leaves)
    return leaves[0]


def pad_batch(batch, multiple: int):
    """Pad the leading axis of every array or tensor of ``batch`` (one, or
    a tuple or list of them) up to a multiple of ``multiple`` by repeating
    row 0; returns ``(padded, n_valid)``, as the JAX ``pad_batch``. Other
    leaves (an index list) pass as they are."""
    leaves = batch_leaves(batch)
    n = leaves[0].shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    reps = np.concatenate([np.arange(n), np.zeros(multiple - rem, np.int64)])

    def pad(x):
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(reps, device=x.device)]
        return x[reps] if hasattr(x, "shape") else x

    return rebuild_batch(batch, [pad(x) for x in leaves]), n


def shard_rows(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous block of rows of every leaf of ``batch``
    (the block ``P("data")`` places on device ``rank``); the leading axis
    must divide by ``world``."""
    leaves = batch_leaves(batch)
    n = leaves[0].shape[0]
    if n % world:
        raise ValueError(f"batch of {n} rows does not divide across {world} "
                         f"ranks (pad it with pad_batch)")
    per = n // world

    def rows(x):
        return x[rank * per:(rank + 1) * per] if hasattr(x, "shape") else x

    return rebuild_batch(batch, [rows(x) for x in leaves])
