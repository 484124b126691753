"""Eval-stage image transforms (counterpart of ``tennis_tpu/data/transforms.py``).

The host does only uint8 geometry (cv2, imported when used); the device
stage turns uint8 NHWC into the normalized compute dtype:

    host:   decode -> Resize(+32) + CenterCrop -> uint8 NHWC
    device: u8 -> f32 / 255 -> normalize (f32) -> dtype

The train augmentation is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# flow-channel statistics
TWO_STREAM_MEAN = (0.485, 0.456, 0.406, 0.863, 0.871, 0.883)
TWO_STREAM_STD = (0.229, 0.224, 0.225, 0.098, 0.087, 0.095)


# --------------------------------------------------------------------- host stage


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter side equals ``size``, keeping the aspect ratio."""
    import cv2

    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    out = img[y0 : y0 + size, x0 : x0 + size]
    if out.shape[0] != size or out.shape[1] != size:  # undersized input: pad
        pad_h, pad_w = size - out.shape[0], size - out.shape[1]
        out = np.pad(out, ((0, pad_h), (0, pad_w), (0, 0)))
    return out


def test_geometry(img: np.ndarray, data_shape: int) -> np.ndarray:
    """Resize(+32) + CenterCrop(data_shape)."""
    return center_crop(resize_shorter(img, data_shape + 32), data_shape)


# ------------------------------------------------------------------- device stage


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """(B, H, W, C) float in [0,1] -> standardized. 6-channel input uses the
    two-stream statistics automatically."""
    c = x.shape[-1]
    if c == 6:
        mean, std = TWO_STREAM_MEAN, TWO_STREAM_STD
    m = torch.tensor(mean[:c], dtype=x.dtype, device=x.device)
    s = torch.tensor(std[:c], dtype=x.dtype, device=x.device)
    return (x - m) / s


def device_prepare(batch_u8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Eval path: uint8 NHWC -> normalized ``dtype`` (math in f32)."""
    x = batch_u8.to(torch.float32) / 255.0
    return normalize(x).to(dtype)
