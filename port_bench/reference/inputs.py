"""Plain reference of the classifier's input stage, in float32.

``prepare``: uint8 NHWC (or N T H W C) -> x / 255, standardised with the
ImageNet mean and deviation. ``augment``: the train-time augment of uint8
frames, with its random draws worked out from ``(seed, step)`` on the
frames' device: a horizontal flip with probability 1/2; brightness,
contrast and saturation factors ``1 + U(-0.4, 0.4)`` applied in one of the
six orders (each an affine map ``x -> a x + b luma(x) + s``; contrast
blends towards the mean luma, saturation towards the luma, luma by ITU-R
601); AlexNet's PCA lighting with weights ``N(0, 0.1)`` on the ImageNet
eigenbasis; one clip to [0, 1]; then the standardisation. The draws come
from a ``torch.Generator`` seeded from ``SeedSequence([seed, step])``, in
the order flip, brightness, contrast, saturation, order, lighting.
"""
from __future__ import annotations

from itertools import permutations

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EIGVAL = (0.2175, 0.0188, 0.0045)
EIGVEC = ((-0.5675, 0.7192, 0.4009),
          (-0.5808, -0.0045, -0.8140),
          (-0.5836, -0.6948, 0.4203))
JITTER, LIGHTING = 0.4, 0.1


def standardise(x: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(MEAN, dtype=x.dtype, device=x.device)
    s = torch.tensor(STD, dtype=x.dtype, device=x.device)
    return (x - m) / s


def prepare(u8: torch.Tensor) -> torch.Tensor:
    return standardise(u8.to(torch.float32) / 255.0)


def generator(seed: int, step: int, device) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def draws(n: int, gen: torch.Generator):
    dev = gen.device
    flip = torch.rand(n, generator=gen, device=dev) < 0.5
    fb, fc, fs = (1.0 + (torch.rand(n, generator=gen, device=dev) * 2 - 1)
                  * JITTER for _ in range(3))
    order = torch.randint(0, 6, (n,), generator=gen, device=dev)
    alpha = torch.randn(n, 3, generator=gen, device=dev) * LIGHTING
    return flip, fb, fc, fs, order, alpha


def augment(u8: torch.Tensor, seed: int, step: int) -> torch.Tensor:
    flip, fb, fc, fs, order, alpha = draws(
        u8.shape[0], generator(seed, step, u8.device))
    x = u8.to(torch.float32) / 255.0
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    luma = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
    mean_luma = luma.mean(dim=(1, 2, 3))
    coeffs = []
    for row in range(x.shape[0]):
        a, b, s = 1.0, 0.0, 0.0
        f_b, f_c, f_s, m = fb[row], fc[row], fs[row], mean_luma[row]
        for op in list(permutations(range(3)))[int(order[row])]:
            if op == 0:      # brightness
                a, b, s = f_b * a, f_b * b, f_b * s
            elif op == 1:    # contrast
                a, b, s = (f_c * a, f_c * b,
                           f_c * s + (1.0 - f_c) * ((a + b) * m + s))
            else:            # saturation
                a, b, s = f_s * a, f_s * b + (1.0 - f_s) * (a + b), s
        coeffs.append(torch.stack([torch.as_tensor(v, device=x.device,
                                                   dtype=x.dtype)
                                   for v in (a, b, s)]))
    a, b, s = torch.stack(coeffs).unbind(1)
    x = a[:, None, None, None] * x + b[:, None, None, None] * luma \
        + s[:, None, None, None]
    eigval = torch.tensor(EIGVAL, device=x.device)
    eigvec = torch.tensor(EIGVEC, device=x.device)
    x = x + ((alpha * eigval) @ eigvec.T)[:, None, None, :]
    return standardise(torch.clamp(x, 0.0, 1.0))
