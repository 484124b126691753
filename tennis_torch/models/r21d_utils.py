"""R(2+1)D test-clip utilities (a copy of ``tennis_tpu/models/r21d_utils.py``;
reference models/vision/rdnet/utils.py:118-183).

The clip loading and Kinetics normalisation helpers used to cross-check
converted weights against upstream activations. Training and evaluation
normalise clips with the ImageNet statistics of ``data/transforms.py``
(``device_prepare``), as the JAX driver does, not with these.
"""
from __future__ import annotations

import os

import numpy as np

# Kinetics/VMZ clip normalisation (reference utils.py:144-183)
CLIP_MEAN = (0.43216, 0.394666, 0.37645)
CLIP_STD = (0.22803, 0.22145, 0.216989)


def get_test_frames(frames_dir: str, t: int = 8, size: int = 112):
    """Load ``t`` consecutive frames from a directory into a (t, H, W, 3) uint8
    clip (sorted file order, center region)."""
    import cv2

    files = sorted(
        f for f in os.listdir(frames_dir) if f.lower().endswith((".jpg", ".png"))
    )[:t]
    if len(files) < t:
        raise ValueError(f"{frames_dir} has {len(files)} frames; need {t}")
    frames = []
    for f in files:
        img = cv2.cvtColor(cv2.imread(os.path.join(frames_dir, f)),
                           cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        scale = (size + 16) / min(h, w)
        img = cv2.resize(img, (round(w * scale), round(h * scale)))
        h, w = img.shape[:2]
        y0, x0 = (h - size) // 2, (w - size) // 2
        frames.append(img[y0 : y0 + size, x0 : x0 + size])
    return np.stack(frames)


def transform_frames(clip: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 → Kinetics-normalised float32 (B=1, T, H, W, 3) clip,
    ready for tennis_torch.models.r21d.R21D (NDHWC — no axis swap needed)."""
    x = clip.astype(np.float32) / 255.0
    x = (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return x[None]
