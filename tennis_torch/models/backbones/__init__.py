"""Backbone registry, keyed by the reference's gluoncv model names
(``--backbone`` flag values: 'resnet18_v2', 'DenseNet121', ...).
Counterpart of ``tennis_tpu/models/backbones/__init__.py``."""
from __future__ import annotations

import torch

from tennis_torch.models.backbones.densenet import DenseNet, DENSENET_SPECS
from tennis_torch.models.backbones.resnet import ResNetV2, RESNET_SPECS

__all__ = ["get_backbone", "backbone_feature_dim", "DenseNet", "ResNetV2"]


def _normalize(name: str) -> str:
    return name.lower().replace("-", "").replace("_", "")


def _spec(name: str):
    """(family, spec) of a DenseNet or ResNet-v2 name; else ValueError."""
    key = _normalize(name)
    for family, prefix, suffix, specs in (
            ("densenet", "densenet", "", DENSENET_SPECS),
            ("resnet", "resnet", "v2", RESNET_SPECS)):
        if key.startswith(prefix) and key.endswith(suffix):
            depth = key[len(prefix):len(key) - len(suffix)]
            if depth.isdigit() and int(depth) in specs:
                return family, specs[int(depth)]
    raise ValueError(
        f"unknown backbone {name!r}; supported: densenet121/161/169/201, "
        f"resnet18_v2/34_v2/50_v2/101_v2/152_v2")


def get_backbone(name: str, in_channels: int = 3, dtype=torch.bfloat16,
                 remat: str | None = None,
                 generator: torch.Generator | None = None):
    """Build a feature-extractor backbone by gluoncv-style name. ``remat``
    (DenseNet only: None, "block", "hires", "growth") is the train-mode
    rematerialization; for a ResNet it raises, as in the JAX package."""
    family, spec = _spec(name)
    if family == "densenet":
        return DenseNet(spec, dtype=dtype, in_channels=in_channels,
                        remat=remat, generator=generator)
    if remat is not None:
        raise ValueError(f"remat is only supported for DenseNet, got {name!r}")
    return ResNetV2(spec, dtype=dtype, in_channels=in_channels,
                    generator=generator)


def backbone_feature_dim(name: str, data_shape: int = 512) -> int:
    """Flattened feature dimension for a square input of side ``data_shape``:
    DenseNet's fixed AvgPool(7) head grows with the input (512^2 -> 4096 for
    DenseNet121); ResNet-v2 pools globally (512 or 2048 at any size), as
    R(2+1)D-34 (``rdnet``, 512) does."""
    if _normalize(name) == "rdnet":
        return 512
    family, spec = _spec(name)
    if family == "resnet":
        return spec.final_channels
    side = data_shape // 32 // 7
    return spec.final_channels * max(side, 1) ** 2
