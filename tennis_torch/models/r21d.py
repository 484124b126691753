"""R(2+1)D spatiotemporal ResNet over NDHWC clips for PyTorch, eval and
train mode.

Counterpart of ``tennis_tpu/models/r21d.py`` (the reference's factorized 3D
CNN, models/vision/rdnet/r21d.py:35-253) with the flax names: the stem
``init`` (a :class:`Conv21D`, mid width 45) and ``init_bn``, then
``stage{i}_block{j}`` (both from 1) with ``conv1``/``conv2`` (each
``spatial``/``bn``/``temporal``), ``bn1``/``bn2`` (bottlenecks: plain
``conv1``/``conv3`` and ``bn3``), and ``down``/``down_bn`` where a block
changes width or stride. Parameters and BN statistics are f32 (the kernels
as ``Conv3d`` weights, OIDHW); compute runs in ``dtype``.

Every 3D convolution factors into a spatial (1, k, k) convolution, a BN with
ReLU and a temporal (k, 1, 1) one. The spatial factor has temporal stride 1,
so it runs as a 2D convolution over the B*T frames; the temporal factor, with
spatial stride 1, as a 2D convolution over (T, H*W). Every BN is flax's with
eps 1e-3 and momentum 0.9; ``bn2``, ``bn3`` and ``down_bn`` come before the
residual add and have no ReLU. The stem BN ``init_bn`` is frozen: it
normalizes with its running statistics in training too, and they never
change (its scale and bias still train). Features are the global mean over
(T, H, W), rounded to the compute dtype and returned in f32.

``remat=True`` checkpoints each residual block (only block inputs are kept
for the backward); the forward and its gradients are those without it. The
JAX package runs this network through XLA convolutions, not a Pallas kernel,
so every convolution here is cuDNN's on a card.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tennis_torch.models.backbones.densenet import BatchNorm, _nchw, _nhwc, \
    lecun_normal_


def _mid_channels(kernel, in_channels: int, out_channels: int) -> int:
    kt, kh, kw = kernel
    return int(math.floor(
        (kt * kh * kw * in_channels * out_channels)
        / (kh * kw * in_channels + kt * out_channels)
    ))


def _conv3d(c_in: int, c_out: int, kernel: Sequence[int],
            generator) -> nn.Conv3d:
    conv = nn.Conv3d(c_in, c_out, tuple(kernel), bias=False)
    lecun_normal_(conv.weight, c_in * math.prod(kernel), generator)
    return conv


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-3, momentum=0.9)


def _pointwise(x, conv: nn.Conv3d, dtype, stride: int = 1):
    """A (1, 1, 1) convolution of NDHWC ``x`` with stride ``stride`` on
    every axis (flax ``SAME``: samples 0, s, 2s, ...) as one GEMM."""
    if stride != 1:
        x = x[:, ::stride, ::stride, ::stride]
    return x @ conv.weight[:, :, 0, 0, 0].t().to(dtype)


class Conv21D(nn.Module):
    """(1, k, k) spatial conv -> BN -> ReLU -> (k, 1, 1) temporal conv."""

    def __init__(self, in_c: int, out_channels: int,
                 kernel: Sequence[int] = (3, 3, 3),
                 strides: Sequence[int] = (1, 1, 1),
                 mid_channels: int | None = None, generator=None):
        super().__init__()
        kt, kh, kw = kernel
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        mid = mid_channels or _mid_channels(kernel, in_c, out_channels)
        self.spatial = _conv3d(in_c, mid, (1, kh, kw), generator)
        self.bn = _bn(mid)
        self.temporal = _conv3d(mid, out_channels, (kt, 1, 1), generator)

    def forward(self, x, train: bool, stats: list, dtype):
        kt, kh, kw = self.kernel
        st, sh, sw = self.strides
        B, T, H, W, C = x.shape
        h = F.conv2d(_nchw(x.reshape(B * T, H, W, C)),
                     self.spatial.weight[:, :, 0].to(dtype), stride=(sh, sw),
                     padding=(kh // 2, kw // 2))
        h = self.bn(_nhwc(h), train, stats, relu=True)
        _, H2, W2, M = h.shape
        h = F.conv2d(_nchw(h.reshape(B, T, H2 * W2, M)),
                     self.temporal.weight[..., 0].to(dtype), stride=(st, 1),
                     padding=(kt // 2, 0))
        h = _nhwc(h)
        return h.reshape(B, h.shape[1], H2, W2, h.shape[-1])


class BasicBlock21D(nn.Module):
    def __init__(self, in_c: int, channels: int, stride: int,
                 downsample: bool, generator=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv21D(in_c, channels, strides=(stride,) * 3,
                             generator=generator)
        self.bn1 = _bn(channels)
        self.conv2 = Conv21D(channels, channels, generator=generator)
        self.bn2 = _bn(channels)
        self.down = _conv3d(in_c, channels, (1, 1, 1), generator) \
            if downsample else None
        self.down_bn = _bn(channels) if downsample else None

    def forward(self, x, train: bool, dtype):
        """(output, the block's ``(bn, mean, var)`` statistics)."""
        stats: list = []
        h = self.conv1(x, train, stats, dtype)
        h = self.bn1(h, train, stats, relu=True)
        h = self.conv2(h, train, stats, dtype)
        h = self.bn2(h, train, stats, relu=False)
        residual = x
        if self.down is not None:
            residual = self.down_bn(_pointwise(
                x, self.down, dtype, self.stride), train, stats, relu=False)
        return torch.relu(h + residual), stats


class Bottleneck21D(nn.Module):
    def __init__(self, in_c: int, channels: int, stride: int,
                 downsample: bool, generator=None):
        super().__init__()
        width = channels // 4
        self.stride = stride
        self.conv1 = _conv3d(in_c, width, (1, 1, 1), generator)
        self.bn1 = _bn(width)
        self.conv2 = Conv21D(width, width, generator=generator)
        self.bn2 = _bn(width)
        self.conv3 = _conv3d(width, channels, (1, 1, 1), generator)
        self.bn3 = _bn(channels)
        self.down = _conv3d(in_c, channels, (1, 1, 1), generator) \
            if downsample else None
        self.down_bn = _bn(channels) if downsample else None

    def forward(self, x, train: bool, dtype):
        stats: list = []
        h = _pointwise(x, self.conv1, dtype, self.stride)
        h = self.bn1(h, train, stats, relu=True)
        h = self.conv2(h, train, stats, dtype)
        h = self.bn2(h, train, stats, relu=True)
        h = _pointwise(h, self.conv3, dtype)
        h = self.bn3(h, train, stats, relu=False)
        residual = x
        if self.down is not None:
            residual = self.down_bn(_pointwise(
                x, self.down, dtype, self.stride), train, stats, relu=False)
        return torch.relu(h + residual), stats


R21D_SPECS = {
    34: ("basic", (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    152: ("bottleneck", (3, 8, 36, 3), (64, 256, 512, 1024, 2048)),
}


class R21D(nn.Module):
    """(B, T, H, W, C) clips -> pooled f32 features (B, C_final).
    ``in_channels`` is the stem's C (flax infers it from the input)."""

    def __init__(self, num_layers: int = 34, num_classes: int = 400,
                 dtype=torch.bfloat16, remat: bool = False,
                 in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        block_type, layers, channels = R21D_SPECS[num_layers]
        block = BasicBlock21D if block_type == "basic" else Bottleneck21D
        self.num_layers = num_layers
        self.num_classes = num_classes
        self.dtype = dtype
        self.remat = remat
        self.final_channels = channels[-1]
        self.init = Conv21D(in_channels, channels[0], (3, 7, 7), (1, 2, 2),
                            mid_channels=45, generator=generator)
        # frozen: running statistics in training too (reference r21d.py:183
        # use_global_stats=True)
        self.init_bn = _bn(channels[0])
        self.blocks = []
        in_c = channels[0]
        for i, num_blocks in enumerate(layers):
            stride = 1 if i == 0 else 2
            c = channels[i + 1]
            for j in range(num_blocks):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block(
                    in_c if j == 0 else c, c, stride if j == 0 else 1,
                    j == 0 and (c != in_c or stride != 1), generator))
                self.blocks.append(name)
            in_c = c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        stats: list = []
        x = self.init(x.to(dt), train, stats, dt)
        x = self.init_bn.train_norm(x, stats, frozen=True) if train \
            else self.init_bn.eval_norm(x)
        for name in self.blocks:
            block = getattr(self, name)
            if train and self.remat:
                x, s = checkpoint(block, x, train, dt, use_reentrant=False)
            else:
                x, s = block(x, train, dt)
            stats += s
        # jnp.mean of the compute dtype (an f32 sum, rounded once), then f32
        x = x.mean(dim=(1, 2, 3), dtype=torch.float32).to(dt).float()
        for bn, mean, var in stats:
            bn.update_stats(mean, var)
        return x


class R21DClassifier(nn.Module):
    """R21D backbone + ``dense`` head + softmax: ``(features, probs)``, the
    reference's full forward (r21d.py:195-208)."""

    def __init__(self, backbone: R21D, num_classes: int = 400,
                 dtype=torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        self.dense = nn.Linear(backbone.final_channels, num_classes)
        lecun_normal_(self.dense.weight, backbone.final_channels, generator)
        nn.init.zeros_(self.dense.bias)

    def forward(self, x: torch.Tensor, train: bool = False):
        avg = self.backbone(x, train=train)
        dt = self.dtype
        logits = F.linear(avg.to(dt), self.dense.weight.to(dt),
                          self.dense.bias.to(dt))
        return avg, torch.softmax(logits.float(), dim=-1)


def get_r21d(num_layers: int = 34, n_classes: int = 400, t: int = 8,
             dtype=torch.bfloat16, remat: bool = False, in_channels: int = 3,
             generator: torch.Generator | None = None) -> R21D:
    """Constructor mirroring reference r21d.py:212-253 (weights load
    separately, through the bridge)."""
    assert num_layers in R21D_SPECS, f"layers must be one of {list(R21D_SPECS)}"
    assert t in (8, 32), "reference supports t in {8, 32} (r21d.py:221)"
    return R21D(num_layers=num_layers, num_classes=n_classes, dtype=dtype,
                remat=remat, in_channels=in_channels, generator=generator)
