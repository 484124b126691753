"""Weight bridge between flax variable trees and the port's modules.

A flax tree ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (what ``utils.checkpoint.load_raw`` returns, or ``model.init`` in the
JAX package) maps to a torch ``state_dict`` by name, with the naming of
``tennis_tpu/models/convert.py`` read in the other direction:

- ``a/b/kernel`` (4-d, HWIO)  -> ``a.b.weight`` (OIHW)
- ``a/b/kernel`` (2-d, in x out) -> ``a.b.weight`` (out x in)
- ``a/b/embedding`` (2-d, V x E) -> ``a.b.weight`` of an ``nn.Embedding``
  (V x E, the same layout)
- ``a/b/scale`` -> ``a.b.weight``; ``a/b/bias`` -> ``a.b.bias``
- batch_stats ``a/b/mean``/``var`` -> ``a.b.running_mean``/``running_var``

``to_flax`` reads the other direction by module type: a ``Conv2d`` weight is
a kernel in HWIO, a ``Linear`` weight a kernel in (in, out), an
``Embedding`` weight an embedding table as it is, any other 1-d weight a
BatchNorm scale.

``state_to_flax`` and ``state_from_flax`` carry a whole train state
(``parallel.train_step.TrainState``) in the layout of the JAX package's
files, so either package resumes the other's epochs: the classifier's
``TrainState`` (parameters, BN statistics, the SGD momentum traces, the
update count and the step) and the captioner's ``{"params",
"batch_stats", "opt_state"}`` (Adam's moments and counts, and the injected
learning rate).

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
        elif leaf == "embedding" and arr.ndim == 2:
            name = "weight"
        elif leaf == "scale" and arr.ndim == 1:
            name = "weight"
        elif leaf == "bias" and arr.ndim == 1:
            name = "bias"
        else:
            raise KeyError(f"no torch counterpart for params/{'/'.join(path)} "
                           f"of shape {arr.shape}")
        key = ".".join(mod + [name])
        if key in state:
            raise KeyError(f"params/{'/'.join(path)} maps to {key}, which "
                           f"another leaf already set")
        state[key] = torch.from_numpy(np.array(arr))
    for path, value in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"no torch counterpart for "
                           f"batch_stats/{'/'.join(path)}")
        state[".".join(mod + [_STAT_LEAVES[leaf]])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state


def _host(t: torch.Tensor) -> np.ndarray:
    """An f32 host copy that shares no memory with ``t``."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _flax_trees(module: torch.nn.Module, value=None):
    """(params, batch_stats) flax trees of ``module``'s tensors, or with
    ``value(name, parameter)`` in place of each parameter (a tensor, or None
    for an empty leaf: optax's masked node)."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, v):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = v

    stat_names = {v: k for k, v in _STAT_LEAVES.items()}
    for prefix, sub in module.named_modules():
        mod = prefix.split(".") if prefix else []
        for leaf, t in sub.named_buffers(recurse=False):
            if leaf not in stat_names:
                raise KeyError(f"no flax counterpart for "
                               f"{'.'.join(mod + [leaf])}")
            put(stats, mod + [stat_names[leaf]], _host(t))
        for leaf, t in sub.named_parameters(recurse=False):
            if value is not None:
                t = value(".".join(mod + [leaf]), t)
                if t is None:
                    put(params, mod + [_param_leaf(sub, leaf, mod)], {})
                    continue
            put(params, mod + [_param_leaf(sub, leaf, mod)],
                _param_array(sub, leaf, _host(t)))
    return params, stats


def _param_leaf(sub, leaf, mod) -> str:
    if leaf == "bias":
        return "bias"
    if leaf != "weight":
        raise KeyError(f"no flax counterpart for {'.'.join(mod + [leaf])}")
    if isinstance(sub, torch.nn.Conv2d | torch.nn.Linear):
        return "kernel"
    if isinstance(sub, torch.nn.Embedding):
        return "embedding"
    return "scale"


def _param_array(sub, leaf, arr: np.ndarray) -> np.ndarray:
    if leaf == "weight" and isinstance(sub, torch.nn.Conv2d):
        return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
    if leaf == "weight" and isinstance(sub, torch.nn.Linear):
        return np.ascontiguousarray(arr.T)
    if leaf == "weight" and not isinstance(sub, torch.nn.Embedding) \
            and arr.ndim != 1:
        raise KeyError(f"no flax counterpart for the weight of shape "
                       f"{arr.shape} of a {type(sub).__name__}")
    return arr


def to_flax(module: torch.nn.Module) -> dict:
    """Inverse of :func:`from_flax`: module -> flax tree of numpy arrays
    (host copies)."""
    params, stats = _flax_trees(module)
    return {"params": params, "batch_stats": stats}


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order, as jitted JAX
    returns its trees."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _is_seq2seq(state) -> bool:
    from tennis_torch.parallel.train_step import InjectState

    return isinstance(state.opt_state, InjectState)


def _seq2seq_to_flax(state) -> dict:
    opt = state.opt_state
    if opt.inner is None:  # optax.sgd(lr): identity, then the -lr scale
        inner = {"0": {}, "1": {}}
    else:
        mu, _ = _flax_trees(state.model, lambda n, _: opt.inner.mu[n])
        nu, _ = _flax_trees(state.model, lambda n, _: opt.inner.nu[n])
        inner = {"0": {"count": np.asarray(opt.inner.count, np.int32),
                       "mu": mu, "nu": nu}, "1": {}}
    params, stats = _flax_trees(state.model)
    opt_state = {"count": np.asarray(opt.count, np.int32),
                 "hyperparams": {"learning_rate": np.asarray(
                     opt.learning_rate, np.float32)},
                 "hyperparams_states": {},
                 "inner_state": {"0": {}, "1": inner}}
    return _sorted({"params": params, "batch_stats": stats,
                    "opt_state": opt_state})


def _seq2seq_from_flax(state, tree: dict) -> None:
    unknown = set(tree) ^ {"params", "batch_stats", "opt_state"}
    if unknown:
        raise KeyError(f"not a captioner train state: keys {sorted(unknown)} "
                       f"differ")
    opt_tree = tree["opt_state"]
    if not {"count", "hyperparams", "inner_state"} <= set(opt_tree):
        raise KeyError(f"not an inject_hyperparams optimizer state: keys "
                       f"{sorted(opt_tree)}")
    chain = opt_tree["inner_state"]
    if set(chain) != {"0", "1"} or set(chain["1"]) != {"0", "1"}:
        raise KeyError(f"not a clip + adam|sgd chain: keys {sorted(chain)}")
    opt = state.opt_state
    adam = chain["1"]["0"]
    if (opt.inner is None) != (not adam):
        raise ValueError("the optimizer state is of the other --optimizer")
    moments = {}
    if opt.inner is not None:
        for key in ("mu", "nu"):
            moments[key] = from_flax({"params": adam[key]})
            want = getattr(opt.inner, key)
            if set(moments[key]) != set(want):
                raise KeyError(f"Adam's {key} differs from the model's: "
                               f"{sorted(set(moments[key]) ^ set(want))}")
    load_flax(state.model, {"params": tree["params"],
                            "batch_stats": tree["batch_stats"]})
    with torch.no_grad():
        for key, loaded in moments.items():
            for name, t in getattr(opt.inner, key).items():
                if t.shape != loaded[name].shape:
                    raise ValueError(f"Adam's {key} of {name}: shape "
                                     f"{tuple(loaded[name].shape)}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(loaded[name])
    if opt.inner is not None:
        opt.inner.count = int(adam["count"])
    opt.count = int(opt_tree["count"])
    opt.learning_rate = float(np.float32(
        opt_tree["hyperparams"]["learning_rate"]))


def state_to_flax(state) -> dict:
    """A ``parallel.train_step.TrainState`` as the JAX package's
    ``TrainState`` goes to disk (``flax.serialization.to_state_dict``):
    ``{"step", "params", "batch_stats", "opt_state"}``, every leaf a host
    copy, every dict below the top in sorted order, so that the file's bytes
    equal the JAX package's for the same values. ``opt_state`` is the optax
    chain's: ``{"0": {} (add_decayed_weights), "1": {"0": {"trace": the
    momentum tree}, "1": {"count": updates made}}}``; under
    ``freeze_backbone`` that chain sits in ``multi_transform``'s
    ``{"inner_states": {"frozen": {"inner_state": {}}, "train":
    {"inner_state": chain}}}`` and the backbone's trace leaves are empty
    (optax's masked nodes).

    A captioner's state (its ``opt_state`` an ``InjectState``) goes as the
    JAX captioning driver saves it, a plain dict and so with every key
    sorted: ``{"batch_stats", "opt_state", "params"}``, ``opt_state`` the
    ``inject_hyperparams`` state
    ``{"count", "hyperparams": {"learning_rate": f32}, "hyperparams_states":
    {}, "inner_state": {"0": {} (the clip), "1": {"0": {"count", "mu",
    "nu"} (Adam; {} for sgd), "1": {} (the -lr scale)}}}``, counts int32."""
    if _is_seq2seq(state):
        return _seq2seq_to_flax(state)
    params, stats = _flax_trees(state.model)
    trace, _ = _flax_trees(state.model,
                           lambda name, _: state.opt_state.trace.get(name))
    chain = {"0": {}, "1": {"0": {"trace": trace}, "1": {
        "count": np.asarray(state.opt_state.count, np.int32)}}}
    if state.freeze_backbone:
        chain = {"inner_states": {"frozen": {"inner_state": {}},
                                  "train": {"inner_state": chain}}}
    return {"step": np.asarray(state.step, np.int32),
            "params": _sorted(params), "batch_stats": _sorted(stats),
            "opt_state": _sorted(chain)}


def state_from_flax(state, tree: dict) -> None:
    """Load a JAX ``TrainState`` tree (a file the JAX package or
    :func:`state_to_flax` wrote, through ``load_raw``) into ``state`` in
    place: parameters and BN statistics, the momentum traces through the
    same transposes as the parameters, the update count and the step; or a
    captioner's tree (see :func:`state_to_flax`) into a captioner's state,
    the learning rate included. A tree of another model, or of the other
    ``freeze_backbone`` or ``--optimizer`` setting, raises
    ``KeyError``/``ValueError``/``RuntimeError``."""
    if _is_seq2seq(state):
        return _seq2seq_from_flax(state, tree)
    unknown = set(tree) ^ {"step", "params", "batch_stats", "opt_state"}
    if unknown:
        raise KeyError(f"not a train state: keys {sorted(unknown)} differ")
    chain = tree["opt_state"]
    if state.freeze_backbone:
        inner = chain.get("inner_states", {})
        if set(inner) != {"frozen", "train"}:
            raise KeyError("not a --freeze_backbone optimizer state")
        chain = inner["train"]["inner_state"]
    if set(chain) != {"0", "1"} or set(chain["1"]) != {"0", "1"}:
        raise KeyError(f"not an SGD optimizer state: keys {sorted(chain)}")
    trace = from_flax({"params": chain["1"]["0"]["trace"]})
    if set(trace) != set(state.opt_state.trace):
        raise KeyError(f"the momentum traces differ from the model's: "
                       f"{sorted(set(trace) ^ set(state.opt_state.trace))}")
    load_flax(state.model, {"params": tree["params"],
                            "batch_stats": tree["batch_stats"]})
    with torch.no_grad():
        for name, t in state.opt_state.trace.items():
            if t.shape != trace[name].shape:
                raise ValueError(f"momentum of {name}: shape "
                                 f"{tuple(trace[name].shape)}, want "
                                 f"{tuple(t.shape)}")
            t.copy_(trace[name])
    state.opt_state.count = int(chain["1"]["1"]["count"])
    state.step = int(tree["step"])


def load_flax(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax tree into ``module`` (strict: every key on both sides)."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module
