"""Checkpoint reading and model-selection conventions (counterpart of
``tennis_tpu/utils/checkpoint.py``; only reading is ported yet).

- ``<exp_dir>/{epoch:04d}.params``  one flax-msgpack file per epoch;
- ``<exp_dir>/scores.txt``          ``<epoch>\\t<score>`` lines, best = argmax.

``load_raw`` decodes flax's msgpack format without flax: an ndarray leaf is
msgpack ext type 1 whose payload is ``packb((shape, dtype_name, buffer))``;
arrays above 2**30 bytes are stored as a dict of flat chunks.
"""
from __future__ import annotations

import logging
import os
import re

import numpy as np

_EPOCH_RE = re.compile(r"^(\d{4})\.params$")
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

log = logging.getLogger(__name__)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen to f32
        import torch

        t = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())) \
        .reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_raw(path: str):
    """Restore a checkpoint as plain nested dicts of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def epoch_path(exp_dir: str, epoch: int) -> str:
    return os.path.join(exp_dir, f"{epoch:04d}.params")


def list_epochs(exp_dir: str) -> list[int]:
    if not os.path.isdir(exp_dir):
        return []
    epochs = []
    for f in os.listdir(exp_dir):
        m = _EPOCH_RE.match(f)
        if m:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def latest_epoch(exp_dir: str) -> int | None:
    epochs = list_epochs(exp_dir)
    return epochs[-1] if epochs else None


def best_epoch(exp_dir: str) -> tuple[int, float] | None:
    """Argmax epoch from scores.txt; rows whose checkpoint file is missing
    are skipped, since every caller loads that file next."""
    path = os.path.join(exp_dir, "scores.txt")
    if not os.path.exists(path):
        return None
    best = None
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                epoch, score = int(parts[0]), float(parts[1])
                if not os.path.exists(epoch_path(exp_dir, epoch)):
                    log.warning("scores.txt row for epoch %d has no %s — "
                                "skipping", epoch, epoch_path(exp_dir, epoch))
                    continue
                if best is None or score > best[1]:
                    best = (epoch, score)
    return best


def best_or_latest(exp_dir: str) -> tuple[int, float]:
    """Best epoch by scores.txt, else the latest checkpoint (score nan), else
    FileNotFoundError."""
    best = best_epoch(exp_dir)
    if best is None:
        latest = latest_epoch(exp_dir)
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoints or scores.txt in {exp_dir}")
        best = (latest, float("nan"))
    return best
