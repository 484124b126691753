"""Backbone registry, keyed by the reference's gluoncv model names
(``--backbone`` flag values). Counterpart of
``tennis_tpu/models/backbones/__init__.py``; only DenseNet is ported yet."""
from __future__ import annotations

import torch

from tennis_torch.models.backbones.densenet import DenseNet, DENSENET_SPECS

__all__ = ["get_backbone", "backbone_feature_dim", "DenseNet"]


def _normalize(name: str) -> str:
    return name.lower().replace("-", "").replace("_", "")


def _densenet_spec(name: str):
    key = _normalize(name)
    if key.startswith("densenet"):
        depth = key[len("densenet"):]
        if depth.isdigit() and int(depth) in DENSENET_SPECS:
            return DENSENET_SPECS[int(depth)]
    if key.startswith("resnet") or key == "rdnet":
        raise NotImplementedError(f"backbone {name!r} is not yet ported to "
                                  f"tennis_torch")
    raise ValueError(f"unknown backbone {name!r}; supported: "
                     f"densenet121/161/169/201")


def get_backbone(name: str, in_channels: int = 3, dtype=torch.bfloat16,
                 remat: str | None = None,
                 generator: torch.Generator | None = None) -> DenseNet:
    """Build a feature-extractor backbone by gluoncv-style name; ``remat``
    is the train-mode rematerialization (None, "block", "hires", "growth")."""
    return DenseNet(_densenet_spec(name), dtype=dtype,
                    in_channels=in_channels, remat=remat, generator=generator)


def backbone_feature_dim(name: str, data_shape: int = 512) -> int:
    """Flattened feature dimension for a square input of side ``data_shape``:
    DenseNet's fixed AvgPool(7) head grows with the input (512^2 -> 4096 for
    DenseNet121)."""
    spec = _densenet_spec(name)
    side = data_shape // 32 // 7
    return spec.final_channels * max(side, 1) ** 2
