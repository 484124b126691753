"""Pre-activation ResNet-v2 in NHWC for PyTorch, eval and train mode.

Counterpart of ``tennis_tpu/models/backbones/resnet.py`` (gluoncv's
``resnet18_v2``, the reference's default ``--backbone``), with the flax
names: ``conv0``, ``bn0``, ``stage{i}_block{j}.{bn1,conv1,bn2,conv2}``
(bottlenecks add ``bn3``/``conv3``), the shortcut ``ds`` where a block
changes width or stride, and ``bn_final``. Parameters and BN statistics are
f32; compute runs in ``dtype``. The global average pool gives a constant
feature width (512 for 18/34, 2048 for 50/101/152) at any input size,
rounded to the compute dtype as the flax module returns it.

Every BN is a flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.99) followed by a
ReLU. Eval mode applies the running statistics in f32 and rounds once; train
mode is :meth:`BatchNorm.train_norm` (batch statistics, the biased variance,
an f32 backward), the running statistics updated once after the forward. The
JAX package runs this network through XLA convolutions, not a Pallas kernel,
so every convolution here is cuDNN's on a card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tennis_torch.models.backbones.densenet import BatchNorm, _conv, _nchw, \
    _nhwc


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    layers: Sequence[int]
    bottleneck: bool

    @property
    def final_channels(self) -> int:
        return 512 * (4 if self.bottleneck else 1)


RESNET_SPECS = {
    18: ResNetSpec((2, 2, 2, 2), bottleneck=False),
    34: ResNetSpec((3, 4, 6, 3), bottleneck=False),
    50: ResNetSpec((3, 4, 6, 3), bottleneck=True),
    101: ResNetSpec((3, 4, 23, 3), bottleneck=True),
    152: ResNetSpec((3, 8, 36, 3), bottleneck=True),
}


def conv_nhwc(x, conv: nn.Conv2d, dtype, stride: int = 1, padding: int = 0):
    """``conv`` over NHWC ``x`` in ``dtype`` (cuDNN in channels-last)."""
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(dtype), stride=stride,
                          padding=padding))


class _BasicBlockV2(nn.Module):
    def __init__(self, in_c: int, channels: int, strides: int,
                 downsample: bool, generator):
        super().__init__()
        self.strides = strides
        self.bn1 = BatchNorm(in_c)
        self.ds = _conv(in_c, channels, 1, generator) if downsample else None
        self.conv1 = _conv(in_c, channels, 3, generator)
        self.bn2 = BatchNorm(channels)
        self.conv2 = _conv(channels, channels, 3, generator)

    def forward(self, x, train: bool, stats: list, dtype):
        h = self.bn1(x, train, stats)
        # the shortcut reads the pre-activated h, as in the flax module
        residual = x if self.ds is None else conv_nhwc(h, self.ds, dtype,
                                                       self.strides)
        h = conv_nhwc(h, self.conv1, dtype, self.strides, 1)
        h = self.bn2(h, train, stats)
        return conv_nhwc(h, self.conv2, dtype, 1, 1) + residual


class _BottleneckV2(nn.Module):
    def __init__(self, in_c: int, channels: int, strides: int,
                 downsample: bool, generator):
        super().__init__()
        width = channels // 4
        self.strides = strides
        self.bn1 = BatchNorm(in_c)
        self.ds = _conv(in_c, channels, 1, generator) if downsample else None
        self.conv1 = _conv(in_c, width, 1, generator)
        self.bn2 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, generator)
        self.bn3 = BatchNorm(width)
        self.conv3 = _conv(width, channels, 1, generator)

    def forward(self, x, train: bool, stats: list, dtype):
        h = self.bn1(x, train, stats)
        residual = x if self.ds is None else conv_nhwc(h, self.ds, dtype,
                                                       self.strides)
        h = conv_nhwc(h, self.conv1, dtype)
        h = self.bn2(h, train, stats)
        h = conv_nhwc(h, self.conv2, dtype, self.strides, 1)
        h = self.bn3(h, train, stats)
        return conv_nhwc(h, self.conv3, dtype) + residual


class ResNetV2(nn.Module):
    """Feature extractor: (B, H, W, C) prepared input -> (B, final_channels)
    globally pooled features in the compute dtype. ``in_channels`` is the
    stem's (6 for ``--flow sixc``; flax infers it from the input)."""

    def __init__(self, spec: ResNetSpec, dtype=torch.bfloat16,
                 in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.conv0 = _conv(in_channels, 64, 7, generator)
        self.bn0 = BatchNorm(64)
        block = _BottleneckV2 if spec.bottleneck else _BasicBlockV2
        mult = 4 if spec.bottleneck else 1
        in_c = 64
        for i, num_blocks in enumerate(spec.layers):
            channels = 64 * 2 ** i * mult
            for j in range(num_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                # j > 0 blocks read the stage's width: in_c is the stage's
                # input width, as the flax loop keeps it
                c_in = in_c if j == 0 else channels
                self.add_module(f"stage{i}_block{j}", block(
                    c_in, channels, strides,
                    (j == 0 and in_c != channels) or strides != 1, generator))
            in_c = channels
        self.bn_final = BatchNorm(in_c)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        stats: list = []
        x = conv_nhwc(x.to(dt), self.conv0, dt, 2, 3)
        x = self.bn0(x, train, stats)
        # max-pool padding counts as -inf, as in the flax stem
        x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))
        for i, num_blocks in enumerate(self.spec.layers):
            for j in range(num_blocks):
                x = getattr(self, f"stage{i}_block{j}")(x, train, stats, dt)
        x = self.bn_final(x, train, stats)
        # jnp.mean of the compute dtype: an f32 sum, rounded once
        x = x.mean(dim=(1, 2), dtype=torch.float32).to(dt)
        for bn, mean, var in stats:
            bn.update_stats(mean, var)
        return x
