"""DenseNet dense layers through one hand-written CUDA kernel per layer.

Counterpart of ``tennis_tpu/ops/pallas/dense_block.py``. One launch of
``csrc/dense_layer.cu`` runs a whole DenseNet-BC dense layer at inference
(folded BN1 -> ReLU -> 1x1 conv -> folded BN2 -> ReLU -> 3x3 conv) over an
unpadded NHWC block-state buffer ``(B, H, W, C_block_final)`` and writes the
layer's growth channels in place, so the concatenated state is never built.

Beside the kernel sits its plain PyTorch version, ``dense_layer_reference``.
``dense_layer`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.

``densenet_features`` drives the whole feature extractor: stem, transitions
and the final BN/pool are plain torch ops, every dense layer goes through
``dense_layer`` (DenseNet121: 58 launches per forward). It takes the BN-folded
operands that ``DenseNet.operands()`` prepares once at load.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

BOTTLENECK = 128  # bn_size * growth_rate that the kernel takes
GROWTH = 32


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as a per-channel affine ``x * inv + shift`` (f32)."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    shift = bias.float() - mean.float() * inv
    return inv, shift


class LayerOperands(NamedTuple):
    """One dense layer's operands: BN1/BN2 folded (f32), kernels in the
    compute dtype. ``w1`` is (F, C_in); ``w2`` is (3, 3, G, F)."""
    inv1: torch.Tensor
    sh1: torch.Tensor
    w1: torch.Tensor
    inv2: torch.Tensor
    sh2: torch.Tensor
    w2: torch.Tensor


def layer_operands(bn1, conv1_weight, bn2, conv2_weight, dtype) -> LayerOperands:
    """Fold one layer's BN parameters and lay its kernels out for the kernel.

    ``bn1``/``bn2`` are ``(scale, bias, mean, var)``; the conv weights are
    torch OIHW. Unlike the TPU version nothing is padded: the kernel reads
    exactly channels ``[0, C_in)``.
    """
    inv1, sh1 = fold_bn(*bn1)
    inv2, sh2 = fold_bn(*bn2)
    w1 = conv1_weight[:, :, 0, 0].to(dtype).contiguous()
    w2 = conv2_weight.permute(2, 3, 0, 1).to(dtype).contiguous()
    return LayerOperands(inv1.contiguous(), sh1.contiguous(), w1,
                         inv2.contiguous(), sh2.contiguous(), w2)


def dense_layer_reference(state: torch.Tensor, c_in: int,
                          ops: LayerOperands) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, in place.

    f32 math; the BN1 output and the bottleneck are rounded to the state's
    dtype before their convolution, as the kernel's tensor cores take them
    (a no-op for f32 state). conv2's zero padding is the image mask.
    """
    dt = state.dtype
    growth = ops.w2.shape[2]
    x = state[..., :c_in].float()
    h = torch.relu(x * ops.inv1 + ops.sh1).to(dt).float()
    b = F.conv2d(h.permute(0, 3, 1, 2), ops.w1.float()[:, :, None, None])
    b = torch.relu(b * ops.inv2[:, None, None] + ops.sh2[:, None, None])
    b = b.to(dt).float()
    part = F.conv2d(b, ops.w2.float().permute(2, 3, 0, 1), padding=1)
    state[..., c_in:c_in + growth] = part.permute(0, 2, 3, 1).to(dt)
    return state


def _check_kernel_args(state, c_in, ops):
    if state.dtype != torch.bfloat16:
        raise TypeError(f"dense_layer kernel takes bf16 state, got {state.dtype}")
    if state.dim() != 4 or not state.is_contiguous():
        raise ValueError("dense_layer kernel takes a contiguous NHWC state")
    f, growth = ops.w1.shape[0], ops.w2.shape[2]
    if (f, growth) != (BOTTLENECK, GROWTH):
        raise ValueError(f"dense_layer kernel takes bottleneck {BOTTLENECK} and "
                         f"growth {GROWTH}, got {f} and {growth}")
    channels = state.shape[-1]
    if c_in % 32 or channels % 8 or c_in + growth > channels:
        raise ValueError(f"dense_layer kernel: c_in {c_in} must be a multiple "
                         f"of 32 and c_in + {growth} fit in {channels} channels")
    want = {"inv1": ((c_in,), torch.float32), "sh1": ((c_in,), torch.float32),
            "w1": ((f, c_in), torch.bfloat16),
            "inv2": ((f,), torch.float32), "sh2": ((f,), torch.float32),
            "w2": ((3, 3, growth, f), torch.bfloat16)}
    for name, (shape, dtype) in want.items():
        t = getattr(ops, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"dense_layer kernel: {name} must be {shape} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != state.device or not t.is_contiguous():
            raise ValueError(f"dense_layer kernel: {name} must be contiguous "
                             f"on {state.device}")
    for t in (state, *ops):
        if t.data_ptr() % 16:
            raise ValueError("dense_layer kernel takes 16-byte aligned tensors")


def _launcher():
    from tennis_torch.ops._build import load_library

    fn = load_library("dense_layer").dense_layer_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dense_layer(state: torch.Tensor, c_in: int,
                ops: LayerOperands) -> torch.Tensor:
    """One dense layer in place: reads channels ``[0, c_in)`` of the NHWC
    block state, writes its growth part to ``[c_in, c_in + G)``; returns
    ``state``. CUDA tensors go through the kernel; CPU tensors through
    :func:`dense_layer_reference`."""
    if state.device.type == "cpu":
        return dense_layer_reference(state, c_in, ops)
    if state.device.type != "cuda":
        raise ValueError(f"dense_layer runs on cuda or cpu, not {state.device}")
    _check_kernel_args(state, c_in, ops)
    B, H, W, C = state.shape
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        err = _launcher()(
            state.data_ptr(), ops.inv1.data_ptr(), ops.sh1.data_ptr(),
            ops.w1.data_ptr(), ops.inv2.data_ptr(), ops.sh2.data_ptr(),
            ops.w2.data_ptr(), B, H, W, C, c_in, BOTTLENECK, GROWTH, stream)
    if err:
        raise RuntimeError(f"dense_layer kernel launch failed: CUDA error {err}")
    dense_layer.launches += 1
    return state


dense_layer.launches = 0  # kernel launches, so a run can show it took the kernel


def _bn_relu(x, inv_shift, dtype):
    inv, shift = inv_shift
    return torch.relu(x.float() * inv + shift).to(dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def densenet_features(spec, operands: dict, x: torch.Tensor, dtype,
                      layer=dense_layer) -> torch.Tensor:
    """DenseNet feature extraction, every dense layer through ``layer``.

    Equivalent to ``DenseNet.apply(..., train=False)`` of the JAX package:
    (B, H, W, C) prepared input -> (B, F) features, flattened in NHWC order
    after the fixed k = min(7, side), stride-k average pool (512^2 input:
    2 x 2 x 1024 = 4096). ``operands`` comes from ``DenseNet.operands()``.
    ``layer`` is :func:`dense_layer`; a comparison may pass
    :func:`dense_layer_reference` to run the plain version on any device.
    """
    x = x.to(dtype)
    x = _nhwc(F.conv2d(_nchw(x), operands["conv0"], stride=2, padding=3))
    x = _bn_relu(x, operands["bn0"], dtype)
    # max-pool padding counts as -inf, as in the JAX stem
    x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))

    channels = spec.num_init_features
    last = len(spec.block_config) - 1
    for i, num_layers in enumerate(spec.block_config):
        c_final = channels + num_layers * spec.growth_rate
        B, H, W, _ = x.shape
        # channels past the live ones are written by a layer before any reads
        state = torch.empty((B, H, W, c_final), dtype=dtype, device=x.device)
        state[..., :channels] = x
        for ops in operands["layers"][i]:
            state = layer(state, channels, ops)
            channels += spec.growth_rate
        x = state
        if i != last:
            bn, w = operands["transitions"][i]
            x = _bn_relu(x, bn, dtype) @ w  # 1x1 conv: (C, C/2) in dtype
            x = _nhwc(F.avg_pool2d(_nchw(x), 2, stride=2))
            channels //= 2

    x = _bn_relu(x, operands["bn_final"], dtype)
    k = min(7, x.shape[1])
    x = _nhwc(F.avg_pool2d(_nchw(x), k, stride=k))
    return x.reshape(x.shape[0], -1)  # NHWC flatten order, as the JAX head


def frame_model_apply(model, x: torch.Tensor, layer=dense_layer) -> torch.Tensor:
    """``FrameModel(DenseNet)`` forward with every dense layer through
    ``layer``: prepared input -> f32 logits (features when the model has no
    head). Counterpart of ``frame_model_apply_pallas``."""
    backbone = model.backbone
    feats = densenet_features(backbone.spec, backbone.operands(), x,
                              backbone.dtype, layer=layer)
    return model.head(feats)
