"""DenseNet-BC in NHWC for PyTorch, eval and train mode.

Counterpart of ``tennis_tpu/models/backbones/densenet.py`` (the gluoncv
DenseNet121 backbone of the reference's models 0006/0042/0102) in its
concatenating formulation, with the same parameter names: ``conv0``, ``bn0``,
``block{i}_layer{j}.{bn1,conv1,bn2,conv2}``, ``transition{i}.{bn,conv}``,
``bn_final``. Parameters and BN statistics are f32; compute runs in ``dtype``.

The eval forward (``train=False``) goes through
:func:`tennis_torch.ops.dense_block.densenet_features`: every dense layer
through the dense-layer kernel, the stem, transitions and head as plain torch
ops. DenseNet161's layers (bottleneck 192, growth 48), which no TPU kernel
computes, take ``dense_layer_convs`` instead: the route decides by width.

The train forward (``train=True``) is the flax module's, in plain torch ops
under autograd (the JAX package also trains through its module, never
through the Pallas kernel): batch statistics, and the running ones updated
once per forward as ``0.99 old + 0.01 batch``, the variance the biased
E[x^2] - E[x]^2 in f32. The rounding points follow the flax modules:
``bn1``, the transitions and ``bn_final`` (``_SlicedBNRelu``) fold
(inv, shift) in f32 and normalize and ReLU in the compute dtype; ``bn0``
and ``bn2`` (``nn.BatchNorm``) normalize in f32 and round once. Each BN
with its ReLU is one :class:`_BatchNormReLU`, whose backward works in f32
and keeps no f32 copy of an activation. ``remat`` is the JAX
option: ``"block"`` checkpoints every dense block, ``"hires"`` the first
two, ``"growth"`` keeps only each layer's growth output (every layer
checkpointed over the list of the block's parts, so its concatenated input
is rebuilt, and its conv2 skipped, in the backward). ``concat_free`` is not
ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tennis_torch.ops.dense_block import densenet_features, layer_operands, \
    fold_bn
from tennis_torch.parallel.distributed import data_group
from tennis_torch.utils.tracing import span


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


REMAT_MODES = (None, "block", "hires", "growth")


class _BatchNormReLU(torch.autograd.Function):
    """Train-mode BatchNorm + ReLU over the last axis of ``x``, as the flax
    modules compute it, with a backward of its own.

    Forward: the batch mean and E[x^2] in at least f32, ``var = E[x^2] -
    mean^2`` (clipped at 0 for ``nn.BatchNorm``, not for
    ``_SlicedBNRelu``), ``mul = rsqrt(var + eps) * weight``, ``shift = bias
    - mean * mul``; then ``relu(x * mul + shift)`` in x's dtype: with
    ``sliced`` the affine is rounded to that dtype first (``_SlicedBNRelu``),
    else it is applied in f32 and the result rounded once
    (``nn.BatchNorm``). Returns (y, mean, var); the statistics are for the
    running update and take no gradient.

    Backward: the chain rule of those same ops (through the statistics to
    x, and to weight and bias), every term in f32 and x's gradient rounded
    once, where autograd over the ops would round each path's part to bf16
    and then add the parts, which nearly cancel. Only x (as it is), y and
    per-channel vectors are kept: no f32 copy of an activation.

    ``relu=False`` leaves the ReLU out (R(2+1)D's BNs before a residual
    add). ``running=(mean, var)`` normalizes with those statistics in
    place of the batch's (a frozen BN, flax ``use_running_average=True``
    under training): they are returned as given, and x's gradient has no
    path through them, and no collective runs.

    Under a process group (data parallelism) the statistics are the
    **global** batch's, as under GSPMD in the JAX package (summed over the
    data axis: the model ranks of a data index hold the same rows): the
    forward all-reduces the per-channel sums of x and x^2 and the count,
    in at least f32, and takes ``mean = sum / count``, ``E[x^2] = sum_sq /
    count``; the backward all-reduces its two per-channel sums through the
    statistics (of the gradient, and of the gradient times x), so that x's
    gradient is that of the sum of every rank's loss, while weight and bias
    keep this rank's share, which the train step's gradient all-reduce
    adds up (``torch.nn.SyncBatchNorm`` splits it the same way). Every rank
    then holds the same statistics for the running update.

    The forward and the backward are the spans ``bn_forward`` and
    ``bn_backward`` (:mod:`tennis_torch.utils.tracing`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, sliced, relu=True, running=None):
        with span("bn_forward"):
            acc = torch.promote_types(x.dtype, torch.float32)
            dims = tuple(range(x.dim() - 1))
            sync = running is None and dist.is_available() \
                and dist.is_initialized()
            n = x.numel() // x.shape[-1]
            if sync:
                xf = x.to(acc)
                C = x.shape[-1]
                sums = torch.cat([xf.sum(dims), xf.square().sum(dims),
                                  xf.new_full((1,), n)])
                del xf
                dist.all_reduce(sums, group=data_group())
                n = sums[-1]
                mean = sums[:C] / n
                var = sums[C:2 * C] / n - mean * mean
            elif running is None:
                xf = x.to(acc)
                mean = xf.mean(dims)
                var = xf.square().mean(dims) - mean * mean
                del xf
            else:  # frozen: the running statistics, which take no gradient
                mean, var = (t.to(acc) for t in running)
            live = var > 0 if not sliced \
                else torch.ones_like(var, dtype=torch.bool)
            if not sliced:
                var = torch.clamp(var, min=0.0)
            rstd = torch.rsqrt(var + eps)
            mul = rstd * weight
            shift = bias - mean * mul
            if sliced:
                y = torch.addcmul(shift.to(x.dtype), x, mul.to(x.dtype))
            else:
                y = torch.addcmul(shift, x, mul).to(x.dtype)
            if relu:
                y = torch.relu_(y)
            ctx.save_for_backward(x, y if relu else None, weight, mean,
                                  rstd, mul, live)
            ctx.sliced = sliced
            ctx.frozen = running is not None
            ctx.sync = sync
            ctx.n = n  # the (global) count: a tensor under a group
            ctx.mark_non_differentiable(mean, var)
            return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        with span("bn_backward"):
            x, y, weight, mean, rstd, mul, live = ctx.saved_tensors
            dims = tuple(range(x.dim() - 1))
            n = ctx.n
            acc = mean.dtype
            g = (dy if y is None else torch.where(y > 0, dy, 0)).to(acc)
            xf = x.to(acc)
            d_shift = g.sum(dims)
            gx = (g * xf).sum(dims)
            d_mul = gx - mean * d_shift
            m = mul.to(x.dtype).to(acc) if ctx.sliced else mul
            if ctx.frozen:
                dx = g * m
            else:
                all_shift, all_mul = d_shift, d_mul
                if ctx.sync:  # the statistics' gradient, every rank's rows
                    C = d_shift.shape[0]
                    sums = torch.cat([d_shift, gx])
                    dist.all_reduce(sums, group=data_group())
                    all_shift = sums[:C]
                    all_mul = sums[C:] - mean * all_shift
                d_mean = -mul * all_shift
                d_var = torch.where(live, -0.5 * rstd ** 3 * weight * all_mul,
                                    0.0)
                d_mean = d_mean - 2 * mean * d_var
                dx = g * m + (d_mean / n + xf * (2 * d_var / n))
            return (dx.to(x.dtype), d_mul * rstd, d_shift, None, None, None,
                    None)


class BatchNorm(nn.Module):
    """BatchNorm parameters (flax ``nn.BatchNorm``, eps 1e-5, momentum
    0.99): ``weight``/``bias`` and ``running_mean``/``running_var``."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def stats(self):
        return self.weight, self.bias, self.running_mean, self.running_var

    def fold(self):
        return fold_bn(*self.stats(), eps=self.eps)

    @torch.no_grad()
    def update_stats(self, mean, var):
        """The running update of one train-mode forward (f32)."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def train_norm(self, x, stats: list, sliced: bool = False,
                   relu: bool = True, frozen: bool = False):
        """Train mode: ``BN(x)`` in x's dtype, then ``relu`` or not
        (:class:`_BatchNormReLU`), with the batch statistics, appending
        ``(self, mean, var)`` to ``stats`` for the running update.
        ``sliced`` for ``_SlicedBNRelu`` (DenseNet's bn1, the transitions,
        bn_final), else flax ``nn.BatchNorm``. ``frozen`` normalizes with
        the running statistics (flax ``use_running_average=True`` under
        training, R(2+1)D's stem): the scale and bias take gradients, the
        statistics neither gradients nor updates."""
        running = (self.running_mean, self.running_var) if frozen else None
        y, mean, var = _BatchNormReLU.apply(x, self.weight, self.bias,
                                            self.eps, sliced, relu, running)
        if not frozen:
            stats.append((self, mean, var))
        return y

    def eval_norm(self, x, relu: bool = True):
        """Eval mode (running statistics) of a flax ``nn.BatchNorm``: the
        affine in f32, rounded once to x's dtype, then ``relu`` or not."""
        mul, shift = self.fold()
        y = torch.addcmul(shift, x, mul).to(x.dtype)
        return torch.relu_(y) if relu else y

    def forward(self, x, train: bool, stats: list, relu: bool = True):
        """A flax ``nn.BatchNorm`` (then ``relu`` or not) over the last
        axis of ``x``: :meth:`train_norm` in train mode, else
        :meth:`eval_norm`."""
        return self.train_norm(x, stats, relu=relu) if train \
            else self.eval_norm(x, relu)


def _conv(c_in: int, c_out: int, k: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, bias=False)
    lecun_normal_(conv.weight, c_in * k * k, generator)
    return conv


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _matmul_1x1(x, conv: nn.Conv2d, dtype):
    """A 1x1 convolution of NHWC ``x`` as one GEMM in ``dtype``."""
    return x @ conv.weight[:, :, 0, 0].t().to(dtype)


class _DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth: int, bn_size: int, generator):
        super().__init__()
        self.bn1 = BatchNorm(c_in)
        self.conv1 = _conv(c_in, bn_size * growth, 1, generator)
        self.bn2 = BatchNorm(bn_size * growth)
        self.conv2 = _conv(bn_size * growth, growth, 3, generator)

    def train_growth(self, state, dtype):
        """Train mode: the (B, H, W, G) growth part of the NHWC ``state``,
        and the layer's ``(bn, mean, var)`` statistics."""
        stats: list = []
        h = _matmul_1x1(self.bn1.train_norm(state, stats, sliced=True),
                        self.conv1, dtype)
        h = self.bn2.train_norm(h, stats)
        h = F.conv2d(_nchw(h), self.conv2.weight.to(dtype), padding=1)
        return _nhwc(h), stats

    def train_growth_from_parts(self, *parts, dtype):
        """:meth:`train_growth` over the concatenation of ``parts``, the
        concatenation made inside (remat ``"growth"``)."""
        state = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return self.train_growth(state, dtype)


class _Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int, generator):
        super().__init__()
        self.bn = BatchNorm(c_in)
        self.conv = _conv(c_in, c_out, 1, generator)

    def train_forward(self, x, dtype, stats: list):
        h = _matmul_1x1(self.bn.train_norm(x, stats, sliced=True), self.conv,
                        dtype)
        return _nhwc(F.avg_pool2d(_nchw(h), 2, stride=2))


class DenseNet(nn.Module):
    """Feature extractor: (B, H, W, C) prepared input -> (B, F) features."""

    def __init__(self, spec: DenseNetSpec, dtype=torch.bfloat16,
                 in_channels: int = 3, remat: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.spec = spec
        self.dtype = dtype
        self.remat = remat
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            return self.train_features(x)
        return densenet_features(self.spec, self.operands(), x, self.dtype)

    def _block(self, x, i: int, dtype):
        """Train mode: dense block ``i`` over NHWC ``x``, concatenating each
        growth part onto the state; (state, statistics)."""
        stats: list = []
        for j in range(self.spec.block_config[i]):
            growth, s = getattr(self, f"block{i}_layer{j}").train_growth(
                x, dtype)
            stats += s
            x = torch.cat([x, growth], -1)
        return x, stats

    def _block_growth(self, x, i: int, dtype):
        """Train mode, remat ``"growth"``: each layer checkpointed over the
        block's parts, so only the parts (the block input and the growth
        outputs) are kept for the backward."""
        parts, stats = [x], []
        for j in range(self.spec.block_config[i]):
            layer = getattr(self, f"block{i}_layer{j}")
            growth, s = checkpoint(layer.train_growth_from_parts, *parts,
                                   dtype=dtype, use_reentrant=False)
            stats += s
            parts.append(growth)
        return torch.cat(parts, -1), stats

    def train_features(self, x: torch.Tensor) -> torch.Tensor:
        """The flax module's ``apply(train=True)``: (B, H, W, C) prepared
        input -> (B, F) features in the compute dtype, under autograd. The
        running statistics are updated once, after the forward (a
        checkpointed block's recomputation in the backward updates none).
        The folded eval operands are dropped: the weights are about to
        change."""
        self._operands = None
        dt = self.dtype
        stats: list = []
        x = _nhwc(F.conv2d(_nchw(x.to(dt)), self.conv0.weight.to(dt),
                           stride=2, padding=3))
        x = self.bn0.train_norm(x, stats)
        x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))
        last = len(self.spec.block_config) - 1
        for i in range(last + 1):
            if self.remat == "growth":
                x, s = self._block_growth(x, i, dt)
            elif self.remat == "block" or (self.remat == "hires" and i < 2):
                x, s = checkpoint(self._block, x, i, dt, use_reentrant=False)
            else:
                x, s = self._block(x, i, dt)
            stats += s
            if i != last:
                x = getattr(self, f"transition{i}").train_forward(x, dt, stats)
        x = self.bn_final.train_norm(x, stats, sliced=True)
        k = min(7, x.shape[1])
        x = _nhwc(F.avg_pool2d(_nchw(x), k, stride=k))
        for bn, mean, var in stats:
            bn.update_stats(mean, var)
        return x.reshape(x.shape[0], -1)
