"""Image transforms (counterpart of ``tennis_tpu/data/transforms.py``),
split into a host stage and a device stage.

The host does only uint8 geometry (cv2, imported when used); the device
stage turns uint8 NHWC into the normalized compute dtype:

    host:   decode -> RandomResizedCrop (train) | Resize(+32) + CenterCrop
            -> uint8 NHWC
    device: u8 -> f32 / 255 -> flip, color jitter in a random order per
            sample, PCA lighting, one clip (train) -> normalize -> dtype

The train augment is split into its draws (:func:`augment_draws`, from a
``torch.Generator``) and their application (:func:`apply_augment`), so a
test can inject the draws that ``jax.random`` made. The PARITY deviations
D6-D8 of the JAX package hold here too: values are clipped to [0, 1] once
at the end, the jitter order is drawn per sample, and contrast blends
towards the luma-weighted mean.
"""
from __future__ import annotations

import math
import threading
from itertools import permutations
from typing import NamedTuple

import numpy as np
import torch

# ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# flow-channel statistics
TWO_STREAM_MEAN = (0.485, 0.456, 0.406, 0.863, 0.871, 0.883)
TWO_STREAM_STD = (0.229, 0.224, 0.225, 0.098, 0.087, 0.095)

# ImageNet PCA lighting basis (alexnet convention), in [0,1] scale
_EIGVAL = np.array([0.2175, 0.0188, 0.0045], dtype=np.float32)
_EIGVEC = np.array(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    dtype=np.float32,
)


class ThreadLocalRng:
    """Per-thread numpy Generators for DataLoader transform closures, each
    spawned from one SeedSequence (numpy Generators are not thread-safe).
    Exact per-sample reproducibility also needs ``num_workers=1``."""

    def __init__(self, seed: int):
        self._seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._local = threading.local()

    def get(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                child = self._seq.spawn(1)[0]
            rng = np.random.default_rng(child)
            self._local.rng = rng
        return rng


# --------------------------------------------------------------------- host stage


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter side equals ``size``, keeping the aspect ratio;
    an image whose shorter side is ``size`` already comes back as it is (the
    resize would copy it exactly), with no cv2 needed."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    import cv2

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


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.Generator,
                        scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0)) -> np.ndarray:
    """Gluon/torchvision ``RandomResizedCrop``: random area+aspect crop ->
    resize; after 10 misses, the center crop of the shorter side."""
    import cv2

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            crop = img[y0:y0 + ch, x0:x0 + cw]
            return cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    return cv2.resize(center_crop(img, min(h, w)), (size, size),
                      interpolation=cv2.INTER_LINEAR)


def test_geometry(img: np.ndarray, data_shape: int) -> np.ndarray:
    """Resize(+32) + CenterCrop(data_shape)."""
    return center_crop(resize_shorter(img, data_shape + 32), data_shape)


def train_geometry(img: np.ndarray, data_shape: int,
                   rng: np.random.Generator) -> np.ndarray:
    return random_resized_crop(img, data_shape, rng)


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


def luma_of(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, (..., 3) -> (..., 1); weights sum to 1."""
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def color_jitter_coeffs(fb, fc, fs, mean_luma, order):
    """Per-sample (a, b, s) of brightness, contrast and saturation composed
    in the order ``order`` (an index into the six permutations, as mxnet's
    ``RandomOrderAug`` draws it): every op is affine in the pixels,
    ``x -> a x + b luma(x) + s``. All arguments and results are (B,)."""
    def brightness(a, b, s):
        return fb * a, fb * b, fb * s

    def contrast(a, b, s):
        return fc * a, fc * b, fc * s + (1.0 - fc) * ((a + b) * mean_luma + s)

    def saturation(a, b, s):
        return fs * a, fs * b + (1.0 - fs) * (a + b), s

    ops = (brightness, contrast, saturation)
    triplets = []
    for perm in permutations(range(3)):
        a, b, s = torch.ones_like(fb), torch.zeros_like(fb), torch.zeros_like(fb)
        for i in perm:
            a, b, s = ops[i](a, b, s)
        triplets.append(torch.stack([a, b, s], dim=-1))
    stacked = torch.stack(triplets)  # (6, B, 3)
    idx = order.long()[None, :, None].expand(1, *stacked.shape[1:])
    sel = torch.gather(stacked, 0, idx)[0]  # (B, 3)
    return sel[:, 0], sel[:, 1], sel[:, 2]


class AugmentDraws(NamedTuple):
    """One batch's random draws of :func:`apply_augment`, each (B,) but
    ``alpha`` (B, 3): flip or not, the brightness/contrast/saturation
    factors, the jitter order (0..5) and the lighting weights."""
    flip: torch.Tensor
    fb: torch.Tensor
    fc: torch.Tensor
    fs: torch.Tensor
    order: torch.Tensor
    alpha: torch.Tensor


def augment_draws(batch: int, generator: torch.Generator,
                  jitter: float = 0.4, lighting: float = 0.1) -> AugmentDraws:
    """The draws of ``device_augment`` for ``batch`` samples, from
    ``generator`` on its device (the JAX package draws them from a
    ``jax.random`` key; the distributions are the same, the values not)."""
    dev = generator.device

    def uniform():
        u = torch.rand(batch, generator=generator, device=dev)
        return 1.0 + (u * 2 - 1) * jitter

    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    fb, fc, fs = uniform(), uniform(), uniform()
    order = torch.randint(0, 6, (batch,), generator=generator, device=dev)
    alpha = torch.randn(batch, 3, generator=generator, device=dev) * lighting
    return AugmentDraws(flip, fb, fc, fs, order, alpha)


def apply_augment(batch_u8: torch.Tensor, draws: AugmentDraws,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Train path: uint8 NHWC (B, H, W, 3) -> flip + color jitter in the
    drawn order + PCA lighting + one clip to [0, 1] + normalize, in f32,
    then ``dtype``; the JAX ``device_augment`` op for op."""
    x = batch_u8.to(torch.float32) / 255.0
    x = torch.where(draws.flip[:, None, None, None], x.flip(2), x)
    luma = luma_of(x)
    mean_luma = luma.mean(dim=(1, 2, 3))
    a, b, s = color_jitter_coeffs(draws.fb, draws.fc, draws.fs, mean_luma,
                                  draws.order)
    x = a[:, None, None, None] * x + b[:, None, None, None] * luma \
        + s[:, None, None, None]
    eigval = torch.from_numpy(_EIGVAL).to(x.device)
    eigvec = torch.from_numpy(_EIGVEC).to(x.device)
    delta = (draws.alpha * eigval[None, :]) @ eigvec.T  # (B, 3)
    x = x + delta[:, None, None, :]
    x = torch.clamp(x, 0.0, 1.0)
    return normalize(x).to(dtype)


def device_augment(batch_u8: torch.Tensor, generator: torch.Generator,
                   dtype=torch.bfloat16, rows=None) -> torch.Tensor:
    """:func:`apply_augment` of fresh :func:`augment_draws`. ``rows =
    (global batch, positions)`` draws for the global batch and takes the
    draws at ``positions``: a data-parallel rank's rows get the draws their
    samples get in a single-process step."""
    if rows is None:
        draws = augment_draws(batch_u8.shape[0], generator)
    else:
        total, pos = rows
        draws = AugmentDraws(*(d[pos] for d in augment_draws(total,
                                                            generator)))
    return apply_augment(batch_u8, draws, dtype)
