"""The (data, model) world and batch helpers (counterpart of
``tennis_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over the devices of a process
and shards each global batch over its ``data`` axis with GSPMD. The port
runs one process per GPU (one per CPU rank for the tests) joined by
``torch.distributed``, and lays the ranks out as the JAX grid
``reshape(num_data, num_model)`` lays the devices: rank r sits at data
index ``r // num_model`` and model index ``r % num_model``. Rank r holds
the rows that ``P("data")`` would place on its data index; the model ranks
of one data index hold the same rows and split the tensor-parallel weights
and the sequence-sharded memory between them. :class:`World` describes
that layout as one process sees it; :func:`mesh_shape` is the counterpart
of ``make_mesh``'s count of devices and its refusal to take more devices
than there are (``parallel.distributed.make_mesh`` builds the groups), and
:func:`data_ranks` the drivers' ``--num_devices``. Without a model axis
(``model_size`` 1, every driver) the data axis is the whole process group.
``tpu_compiler_options`` and ``driver_compiler_options`` configure XLA for
the TPU and have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the ``(data, model)`` layout: its global
    ``rank`` of the ``size`` ranks of the layout, its ``local_rank`` on its
    host, the ``device`` it computes on and the ``model_size`` of the model
    axis (1 without one: then the data axis is the whole group).
    ``grouped`` is True once a process group exists (even of size 1): only
    then does any collective run."""
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    grouped: bool = False
    model_size: int = 1

    @property
    def is_main(self) -> bool:
        """Global rank 0, the one rank that writes an experiment's files."""
        return self.rank == 0

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def data_rank(self) -> int:
        """The data index: which rows of a global batch this rank holds."""
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        """The model index: which block of a sharded weight or of the
        memory's time axis this rank holds."""
        return self.rank % self.model_size

    def model_group_ranks(self) -> list[int]:
        """The ranks of this rank's data index: its model group."""
        return [self.data_rank * self.model_size + m
                for m in range(self.model_size)]

    def data_group_ranks(self) -> list[int]:
        """The ranks of this rank's model index: its data group, one
        replica of each data index."""
        return [d * self.model_size + self.model_rank
                for d in range(self.data_size)]


def mesh_shape(num_data: int | None, num_model: int, have: int) -> tuple:
    """``(num_data, num_model)`` of a mesh over ``have`` ranks, as the JAX
    ``make_mesh`` counts it: ``num_data`` None takes every rank the model
    axis divides into; a mesh of more ranks than ``have`` raises its
    ``ValueError``. A smaller mesh takes the first ranks."""
    if num_data is None:
        num_data = have // num_model
    n = num_data * num_model
    if n > have:
        raise ValueError(
            f"mesh wants {n} devices ({num_data}x{num_model}), have {have}")
    return num_data, num_model


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
