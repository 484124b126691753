"""Plain reference of R(2+1)D-34 (Tran et al., "A Closer Look at
Spatiotemporal Convolutions for Action Recognition", arXiv:1711.11248)
with a linear head.

NCDHW float32 through ``torch.nn.functional.conv3d``. Every (2+1)D
convolution is a (1, k, k) spatial convolution to ``M`` channels, BN,
ReLU, and a (k, 1, 1) temporal one, with ``M = floor(t k^2 N_in N_out /
(k^2 N_in + t N_out))`` (the paper's Eq. 1; 45 in the stem) and padding
``k // 2`` on each side. The stem is a (3, 7, 7) such convolution with
spatial stride 2, then a BN whose running statistics normalise in
training too (frozen), and a ReLU. Four stages of 3, 4, 6, 3 basic blocks
(64, 128, 256, 512 wide; stride 2 in every axis at the first block of
stages 2-4): conv-BN-ReLU-conv-BN, plus the input or its strided 1x1x1
projection and BN, then ReLU. Features are the mean over (T, H, W); the
``classes`` head follows. BN eps is 1e-3, statistics over the batch in
training. Convolutions have no bias.

Parameters are named as the classifier's checkpoints name them
(``backbone.init.spatial.weight``,
``backbone.stage{i}_block{j}.conv1.bn.weight``, ``classes.weight``),
kernels in (out, in, kt, kh, kw).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.precision import batch_norm, bn_shapes, rounding

EPS = 1e-3
STAGES = {34: ((3, 4, 6, 3), (64, 64, 128, 256, 512))}


def mid_channels(k, c_in: int, c_out: int) -> int:
    kt, kh, kw = k
    return int(math.floor(kt * kh * kw * c_in * c_out
                          / (kh * kw * c_in + kt * c_out)))


def blocks(cfg: dict):
    """(name, c_in, c_out, stride, projected) of every residual block."""
    layers, widths = STAGES[cfg["depth"]]
    out, c_in = [], widths[0]
    for i, n in enumerate(layers):
        c, stride = widths[i + 1], 1 if i == 0 else 2
        for j in range(n):
            s = stride if j == 0 else 1
            cin = c_in if j == 0 else c
            out.append((f"backbone.stage{i + 1}_block{j + 1}", cin, c, s,
                        j == 0 and (c != c_in or stride != 1)))
        c_in = c
    return out


def feature_dim(cfg: dict) -> int:
    return STAGES[cfg["depth"]][1][-1]


def _conv21d_shapes(name, c_in, c_out, k=(3, 3, 3), mid=None) -> dict:
    kt, kh, kw = k
    m = mid or mid_channels(k, c_in, c_out)
    p = {f"{name}.spatial.weight": ((m, c_in, 1, kh, kw), "conv")}
    p.update(bn_shapes(f"{name}.bn", m))
    p[f"{name}.temporal.weight"] = ((c_out, m, kt, 1, 1), "conv")
    return p


def param_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of every parameter and BN statistic."""
    stem = STAGES[cfg["depth"]][1][0]
    p = _conv21d_shapes("backbone.init", 3, stem, (3, 7, 7),
                        cfg["stem_mid_channels"])
    p.update(bn_shapes("backbone.init_bn", stem))
    for name, c_in, c, _, projected in blocks(cfg):
        p.update(_conv21d_shapes(f"{name}.conv1", c_in, c))
        p.update(bn_shapes(f"{name}.bn1", c))
        p.update(_conv21d_shapes(f"{name}.conv2", c, c))
        p.update(bn_shapes(f"{name}.bn2", c))
        if projected:
            p[f"{name}.down.weight"] = ((c, c_in, 1, 1, 1), "conv")
            p.update(bn_shapes(f"{name}.down_bn", c))
    if cfg["num_classes"] > 0:
        p["classes.weight"] = ((cfg["num_classes"], feature_dim(cfg)),
                               "linear")
        p["classes.bias"] = ((cfg["num_classes"],), "bias")
    return p


def _product(q, op, x, w, **kw):
    """``op(x, w)`` with the precision's roundings ``q``."""
    qi, qg = q
    return qg(op(qi(x), qi(w), **kw))


def _conv21d(p, name, x, train, q, k=(3, 3, 3), stride=1,
             spatial_stride=None):
    kt, kh, kw = k
    ss = stride if spatial_stride is None else spatial_stride
    h = _product(q, F.conv3d, x, p[f"{name}.spatial.weight"],
                 stride=(1, ss, ss), padding=(0, kh // 2, kw // 2))
    h = F.relu(batch_norm(h, p, f"{name}.bn", train, EPS))
    return _product(q, F.conv3d, h, p[f"{name}.temporal.weight"],
                    stride=(stride, 1, 1), padding=(kt // 2, 0, 0))


def _block(p, name, x, stride, projected, train, q):
    h = _conv21d(p, f"{name}.conv1", x, train, q, stride=stride)
    h = F.relu(batch_norm(h, p, f"{name}.bn1", train, EPS))
    h = _conv21d(p, f"{name}.conv2", h, train, q)
    h = batch_norm(h, p, f"{name}.bn2", train, EPS)
    if projected:
        r = _product(q, F.conv3d, x, p[f"{name}.down.weight"], stride=stride)
        x = batch_norm(r, p, f"{name}.down_bn", train, EPS)
    return F.relu(h + x)


def features(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
             precision: str = "f32", remat: bool = False) -> torch.Tensor:
    """(B, T, H, W, 3) normalised f32 clips -> (B, F) features. ``remat``
    recomputes each residual block in the backward (memory only)."""
    q = rounding(precision)
    x = x.permute(0, 4, 1, 2, 3)
    x = _conv21d(p, "backbone.init", x, train, q, k=(3, 7, 7), stride=1,
                 spatial_stride=2)
    x = F.relu(batch_norm(x, p, "backbone.init_bn", train, EPS, frozen=True))
    for name, _, _, stride, projected in blocks(cfg):
        if remat and train:
            x = checkpoint(_block, p, name, x, stride, projected, train, q,
                           use_reentrant=False)
        else:
            x = _block(p, name, x, stride, projected, train, q)
    return x.mean(dim=(2, 3, 4))


def logits(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
           precision: str = "f32", remat: bool = False) -> torch.Tensor:
    q = rounding(precision)
    f = features(p, x, cfg, train, precision, remat)
    return _product(q, F.linear, f, p["classes.weight"]) + p["classes.bias"]
