"""Tensor-parallel sharding rules for the ``(data, model)`` layout
(counterpart of ``tennis_tpu/parallel/sharding_rules.py``).

Data parallelism replicates the parameters; the model axis column-shards
the widest matmuls: every 2-D flax ``kernel`` whose output width is at
least ``min_tp_dim`` and divides by the model size is split into
``model_size`` column blocks, model rank m holding block m; everything
else (biases, convolutions, embeddings, narrow kernels) stays whole on
every rank. The rule decides by flax path and shape (``bridge.to_flax``'s
naming), leaf for leaf as the JAX rule. There is no GSPMD: a block lives
in the port's ``nn.Linear`` layout as a block of weight **rows**
(:func:`place_blocks`), and the layer runs column-parallel with explicit
collectives over the model group (``ops.rnn.column_parallel``).

The optimizer state follows its own parameter: an SGD trace or an Adam
moment is created from the placed parameter (``zeros_like``), so it is a
block where the parameter is. The JAX ``state_shardings`` looks the
sharding up by **shape**; the two differ only where a whole leaf has the
shape of a sharded kernel (``ROADMAP.md`` §3), and the numerics are the
same either way.
"""
from __future__ import annotations

import dataclasses

import torch

from tennis_torch.bridge import param_leaves
from tennis_torch.ops.rnn import Dense
from tennis_torch.parallel.mesh import World


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's place under the model axis: its flax ``path``, whole
    (``blocks`` 1) or column block ``block`` of ``blocks``."""
    path: tuple
    blocks: int = 1
    block: int = 0

    @property
    def sharded(self) -> bool:
        return self.blocks > 1


def _flax_shape(sub, leaf, t: torch.Tensor) -> tuple:
    """The whole flax shape of a ``Linear`` weight (a placed block counts
    at its whole width); any other parameter's shape, of the flax leaf's
    rank (a convolution's kernel is 4-D or 5-D in both layouts)."""
    if leaf == "weight" and isinstance(sub, torch.nn.Linear):
        return (sub.in_features, sub.out_features)
    return tuple(t.shape)


def param_shardings(world: World, model: torch.nn.Module,
                    min_tp_dim: int = 256) -> dict[str, Sharding]:
    """``{torch name: Sharding}`` for every parameter of ``model``: 2-D
    kernels whose output width is ``>= min_tp_dim`` and divisible by the
    model size are column-sharded, when the model axis is above 1;
    everything else is whole."""
    tp = world.model_size
    out = {}
    for name, sub, leaf, path in param_leaves(model):
        shape = _flax_shape(sub, leaf, getattr(sub, leaf))
        if (tp > 1 and "kernel" in path and len(shape) == 2
                and shape[-1] >= min_tp_dim and shape[-1] % tp == 0):
            out[name] = Sharding(path, tp, world.model_rank)
        else:
            out[name] = Sharding(path)
    return out


def state_shardings(world: World, state) -> dict:
    """Shardings of a whole train state (``parallel.train_step.TrainState``):
    ``params`` by :func:`param_shardings`; ``opt_state`` (``trace`` of
    SGD, ``mu`` and ``nu`` of Adam) each leaf as its parameter;
    ``batch_stats`` and the counts whole."""
    p_sh = param_shardings(world, state.model)
    whole = Sharding(())
    opt = state.opt_state
    if hasattr(opt, "trace"):
        opt_sh = {"trace": {n: p_sh[n] for n in opt.trace}}
    elif getattr(opt, "inner", None) is not None:
        opt_sh = {k: {n: p_sh[n] for n in getattr(opt.inner, k)}
                  for k in ("mu", "nu")}
    else:
        opt_sh = {}
    return {"step": whole, "params": p_sh,
            "batch_stats": {n: whole for n, _ in state.model.named_buffers()},
            "opt_state": opt_sh}


@torch.no_grad()
def place_blocks(model: torch.nn.Module, world: World,
                 names=None) -> list[str]:
    """Cut each parameter that the rule shards to this rank's block of
    weight rows, in place, and mark its layer column-parallel
    (``tp_world``); returns the names cut. Call it before the optimizer
    state is made. ``names`` replaces the rule's choice, for checks only:
    at a model axis of 1 it cuts 1-of-1 blocks, the whole column-parallel
    path on whole weights, where the rule would cut nothing."""
    if names is None:
        names = [n for n, s in param_shardings(world, model).items()
                 if s.sharded]
    modules = dict(model.named_modules())
    for name in names:
        mod, leaf = name.rsplit(".", 1)
        sub = modules[mod]
        if leaf != "weight" or not isinstance(sub, Dense):
            raise ValueError(f"{name}: no column-parallel forward for a "
                             f"{type(sub).__name__}")
        if sub.tp_world is not None:
            raise ValueError(f"{name} is already placed")
        w = sub.weight
        n = w.shape[0] // world.model_size
        block = w[world.model_rank * n:(world.model_rank + 1) * n].clone()
        sub.weight = torch.nn.Parameter(block, requires_grad=w.requires_grad)
        sub.tp_world = world
    return list(names)


def block_worlds(model: torch.nn.Module) -> dict[str, World]:
    """``{parameter name: model world}`` of the column-sharded weights of
    ``model``."""
    return {f"{prefix}.weight" if prefix else "weight": sub.tp_world
            for prefix, sub in model.named_modules()
            if getattr(sub, "tp_world", None) is not None}
