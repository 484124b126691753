"""DenseNet-BC in NHWC, eval mode, for PyTorch.

Counterpart of ``tennis_tpu/models/backbones/densenet.py`` (the gluoncv
DenseNet121 backbone of the reference's models 0006/0042/0102) in its
concatenating formulation, with the same parameter names: ``conv0``, ``bn0``,
``block{i}_layer{j}.{bn1,conv1,bn2,conv2}``, ``transition{i}.{bn,conv}``,
``bn_final``. Parameters and BN statistics are f32; compute runs in ``dtype``.

The forward goes through :func:`tennis_torch.ops.dense_block.densenet_features`:
every dense layer through the dense-layer kernel, the stem, transitions and
head as plain torch ops. DenseNet161's layers (bottleneck 192, growth 48),
which no TPU kernel computes, take ``dense_layer_convs`` instead: the route
decides by width. Train mode, ``remat`` and ``concat_free`` are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from tennis_torch.ops.dense_block import densenet_features, layer_operands, \
    fold_bn


@dataclasses.dataclass(frozen=True)
class DenseNetSpec:
    block_config: Sequence[int]
    growth_rate: int = 32
    num_init_features: int = 64
    bn_size: int = 4  # bottleneck width multiplier

    @property
    def final_channels(self) -> int:
        c = self.num_init_features
        for i, n in enumerate(self.block_config):
            c += n * self.growth_rate
            if i != len(self.block_config) - 1:
                c //= 2
        return c


DENSENET_SPECS = {
    121: DenseNetSpec((6, 12, 24, 16)),
    161: DenseNetSpec((6, 12, 36, 24), growth_rate=48, num_init_features=96),
    169: DenseNetSpec((6, 12, 32, 32)),
    201: DenseNetSpec((6, 12, 48, 32)),
}


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal (+-2 std), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm parameters (flax ``nn.BatchNorm``, eps 1e-5):
    ``weight``/``bias`` and ``running_mean``/``running_var``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def stats(self):
        return self.weight, self.bias, self.running_mean, self.running_var

    def fold(self):
        return fold_bn(*self.stats(), eps=self.eps)


def _conv(c_in: int, c_out: int, k: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, bias=False)
    lecun_normal_(conv.weight, c_in * k * k, generator)
    return conv


class _DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth: int, bn_size: int, generator):
        super().__init__()
        self.bn1 = BatchNorm(c_in)
        self.conv1 = _conv(c_in, bn_size * growth, 1, generator)
        self.bn2 = BatchNorm(bn_size * growth)
        self.conv2 = _conv(bn_size * growth, growth, 3, generator)


class _Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int, generator):
        super().__init__()
        self.bn = BatchNorm(c_in)
        self.conv = _conv(c_in, c_out, 1, generator)


class DenseNet(nn.Module):
    """Feature extractor: (B, H, W, C) prepared input -> (B, F) features."""

    def __init__(self, spec: DenseNetSpec, dtype=torch.bfloat16,
                 in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.conv0 = _conv(in_channels, spec.num_init_features, 7, generator)
        self.bn0 = BatchNorm(spec.num_init_features)
        channels = spec.num_init_features
        for i, num_layers in enumerate(spec.block_config):
            for j in range(num_layers):
                self.add_module(f"block{i}_layer{j}", _DenseLayer(
                    channels, spec.growth_rate, spec.bn_size, generator))
                channels += spec.growth_rate
            if i != len(spec.block_config) - 1:
                self.add_module(f"transition{i}",
                                _Transition(channels, channels // 2, generator))
                channels //= 2
        self.bn_final = BatchNorm(channels)
        self._operands = None

    @torch.no_grad()
    def fold(self) -> "DenseNet":
        """Fold every BN and lay out every kernel once, for the forward to
        reuse. Call it again after the weights change or move."""
        self._operands = None
        self._operands = self.operands()
        return self

    @torch.no_grad()
    def operands(self) -> dict:
        """The operands :func:`densenet_features` takes (cached by
        :meth:`fold`, else computed for this call)."""
        if self._operands is not None:
            return self._operands
        dt = self.dtype
        layers = []
        for i, num_layers in enumerate(self.spec.block_config):
            block = []
            for j in range(num_layers):
                m = getattr(self, f"block{i}_layer{j}")
                block.append(layer_operands(m.bn1.stats(), m.conv1.weight,
                                            m.bn2.stats(), m.conv2.weight, dt))
            layers.append(block)
        transitions = []
        for i in range(len(self.spec.block_config) - 1):
            t = getattr(self, f"transition{i}")
            transitions.append((t.bn.fold(),
                                t.conv.weight[:, :, 0, 0].t().to(dt).contiguous()))
        return {"conv0": self.conv0.weight.to(dt), "bn0": self.bn0.fold(),
                "layers": layers, "transitions": transitions,
                "bn_final": self.bn_final.fold()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return densenet_features(self.spec, self.operands(), x, self.dtype)
