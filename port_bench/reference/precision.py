"""The precision a reference computes in, and the plain batch norm it uses.

``"f32"`` is the reference itself: float32 with TF32 off. ``"fp8"`` is the
control of a configuration that states bfloat16, as fp8 training computes:
every operand of a convolution or matrix product (activation and weight)
is rounded to float8 e4m3, and in the backward the gradient that reaches
each product's output is rounded to float8 e5m2, each with one scale a
tensor; the rest stays float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
PRECISIONS = ("f32", "fp8")


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """e4m3 rounding forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _same(x):
    return x


def rounding(precision: str):
    """``(q, qg)``: the rounding of each operand of a product, and the
    rounding of the gradient at each product's output."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "fp8":
        return _Fp8.apply, _Fp8Grad.apply
    return _same, _same


def batch_norm(x, p: dict, name: str, train: bool, eps: float,
               frozen: bool = False):
    """BatchNorm over channel axis 1: the batch's mean and biased variance
    in training, the running statistics in eval or when ``frozen``."""
    use_batch = train and not frozen
    return F.batch_norm(
        x, None if use_batch else p[f"{name}.running_mean"],
        None if use_batch else p[f"{name}.running_var"],
        p[f"{name}.weight"], p[f"{name}.bias"], training=use_batch, eps=eps)


def bn_shapes(name: str, c: int) -> dict:
    return {f"{name}.weight": ((c,), "bn_weight"),
            f"{name}.bias": ((c,), "bn_bias"),
            f"{name}.running_mean": ((c,), "bn_mean"),
            f"{name}.running_var": ((c,), "bn_var")}
