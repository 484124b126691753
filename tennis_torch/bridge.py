"""Weight bridge between flax variable trees and the port's modules.

A flax tree ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (what ``utils.checkpoint.load_raw`` returns, or ``model.init`` in the
JAX package) maps to a torch ``state_dict`` by name, with the naming of
``tennis_tpu/models/convert.py`` read in the other direction:

- ``a/b/kernel`` (4-d, HWIO)  -> ``a.b.weight`` (OIHW)
- ``a/b/kernel`` (2-d, in x out) -> ``a.b.weight`` (out x in)
- ``a/b/scale`` -> ``a.b.weight``; ``a/b/bias`` -> ``a.b.bias``
- batch_stats ``a/b/mean``/``var`` -> ``a.b.running_mean``/``running_var``

A leaf that matches no rule raises, and loading the result with
``load_state_dict`` (strict) raises on a key the module lacks or leaves
unset.
"""
from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAVES = ("kernel", "scale", "bias")
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> torch state dict (f32)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for path, value in _leaves(variables.get("params", {})):
        *mod, leaf = path
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            arr, name = arr.transpose(3, 2, 0, 1), "weight"
        elif leaf == "kernel" and arr.ndim == 2:
            arr, name = arr.T, "weight"
        elif leaf == "scale" and arr.ndim == 1:
            name = "weight"
        elif leaf == "bias" and arr.ndim == 1:
            name = "bias"
        else:
            raise KeyError(f"no torch counterpart for params/{'/'.join(path)} "
                           f"of shape {arr.shape}")
        state[".".join(mod + [name])] = torch.from_numpy(np.array(arr))
    for path, value in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"no torch counterpart for "
                           f"batch_stats/{'/'.join(path)}")
        state[".".join(mod + [_STAT_LEAVES[leaf]])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state


def to_flax(module: torch.nn.Module) -> dict:
    """Inverse of :func:`from_flax`: module -> flax tree of numpy arrays."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    stat_names = {v: k for k, v in _STAT_LEAVES.items()}
    for key, t in module.state_dict().items():
        *mod, leaf = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if leaf in stat_names:
            put(stats, mod + [stat_names[leaf]], arr)
        elif leaf == "weight" and arr.ndim == 4:
            put(params, mod + ["kernel"], arr.transpose(2, 3, 1, 0).copy())
        elif leaf == "weight" and arr.ndim == 2:
            put(params, mod + ["kernel"], arr.T.copy())
        elif leaf == "weight" and arr.ndim == 1:
            put(params, mod + ["scale"], arr)
        elif leaf == "bias":
            put(params, mod + ["bias"], arr)
        else:
            raise KeyError(f"no flax counterpart for {key} of shape {arr.shape}")
    return {"params": params, "batch_stats": stats}


def load_flax(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax tree into ``module`` (strict: every key on both sides)."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module
