"""Plain reference of DenseNet-BC (Huang et al., "Densely Connected
Convolutional Networks", arXiv:1608.06993, Table 1) with a linear head.

NCHW float32 through ``torch.nn.functional``: a 7x7 stride-2 stem with BN,
ReLU and a 3x3 stride-2 max pool; dense blocks of layers BN-ReLU-1x1 conv
(``bn_size * growth`` wide)-BN-ReLU-3x3 conv (``growth`` wide), each
output concatenated onto the block's input; transitions BN-ReLU-1x1 conv
(compression 0.5)-2x2 average pool; a final BN-ReLU, then an average pool
of ``min(7, side)`` with the same stride (the TenniSet classifier's pool,
which leaves 2x2 cells at 512^2), flattened in (H, W, C) order, and the
``classes`` head. BN eps is 1e-5; train mode normalises with the batch's
statistics. Convolutions have no bias.

Parameters are named as the classifier's checkpoints name them
(``backbone.conv0.weight``, ``backbone.block{i}_layer{j}.bn1.weight``,
``backbone.transition{i}.conv.weight``, ``classes.weight``), with
convolution kernels in (out, in, kh, kw).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.precision import batch_norm, bn_shapes, rounding

EPS = 1e-5


def arch(cfg: dict) -> dict:
    return {"blocks": tuple(cfg["block_config"]),
            "growth": cfg["growth_rate"], "init": cfg["num_init_features"],
            "bn_size": cfg["bn_size"], "classes": cfg["num_classes"],
            "side": cfg["data_shape"]}


def final_side(side: int) -> int:
    """Side of the last dense block's map for a ``side`` input."""
    s = (side + 6 - 7) // 2 + 1          # stem conv, stride 2
    s = (s + 2 - 3) // 2 + 1             # max pool, stride 2
    return s


def layers(cfg: dict):
    """(block, layer, side, c_in) of every dense layer, in order."""
    a = arch(cfg)
    side, c = final_side(a["side"]), a["init"]
    out = []
    for i, n in enumerate(a["blocks"]):
        for j in range(n):
            out.append((i, j, side, c + a["growth"] * j))
        c += a["growth"] * n
        if i != len(a["blocks"]) - 1:
            c //= 2
            side //= 2
    return out, side, c


def feature_dim(cfg: dict) -> int:
    _, side, c = layers(cfg)
    k = min(7, side)
    return c * ((side - k) // k + 1) ** 2


def param_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of every parameter and BN statistic."""
    a = arch(cfg)
    g, mid = a["growth"], a["bn_size"] * a["growth"]
    p = {"backbone.conv0.weight": ((a["init"], 3, 7, 7), "conv")}
    p.update(bn_shapes("backbone.bn0", a["init"]))
    c = a["init"]
    for i, n in enumerate(a["blocks"]):
        for j in range(n):
            pre = f"backbone.block{i}_layer{j}"
            p.update(bn_shapes(f"{pre}.bn1", c))
            p[f"{pre}.conv1.weight"] = ((mid, c, 1, 1), "conv")
            p.update(bn_shapes(f"{pre}.bn2", mid))
            p[f"{pre}.conv2.weight"] = ((g, mid, 3, 3), "conv")
            c += g
        if i != len(a["blocks"]) - 1:
            p.update(bn_shapes(f"backbone.transition{i}.bn", c))
            p[f"backbone.transition{i}.conv.weight"] = ((c // 2, c, 1, 1),
                                                        "conv")
            c //= 2
    p.update(bn_shapes("backbone.bn_final", c))
    if a["classes"] > 0:
        p["classes.weight"] = ((a["classes"], feature_dim(cfg)), "linear")
        p["classes.bias"] = ((a["classes"],), "bias")
    return p


def _product(q, op, x, w, **kw):
    """``op(x, w)`` with the precision's roundings ``q``."""
    qi, qg = q
    return qg(op(qi(x), qi(w), **kw))


def _layer(p, pre, x, train, q):
    h = F.relu(batch_norm(x, p, f"{pre}.bn1", train, EPS))
    h = _product(q, F.conv2d, h, p[f"{pre}.conv1.weight"])
    h = F.relu(batch_norm(h, p, f"{pre}.bn2", train, EPS))
    return _product(q, F.conv2d, h, p[f"{pre}.conv2.weight"], padding=1)


def _block(p, i, n, x, train, q, remat):
    for j in range(n):
        pre = f"backbone.block{i}_layer{j}"
        if remat:
            h = checkpoint(_layer, p, pre, x, train, q, use_reentrant=False)
        else:
            h = _layer(p, pre, x, train, q)
        x = torch.cat([x, h], 1)
    return x


def features(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
             precision: str = "f32", remat: bool = False) -> torch.Tensor:
    """(B, H, W, 3) normalised f32 input -> (B, F) features. ``remat``
    keeps only each dense block's input for the backward, and in its
    recomputation each layer's (memory only: the values are the
    same)."""
    a = arch(cfg)
    q = rounding(precision)
    x = x.permute(0, 3, 1, 2)
    x = _product(q, F.conv2d, x, p["backbone.conv0.weight"], stride=2,
                 padding=3)
    x = F.relu(batch_norm(x, p, "backbone.bn0", train, EPS))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    remat = remat and train
    for i, n in enumerate(a["blocks"]):
        if remat:
            x = checkpoint(_block, p, i, n, x, train, q, remat,
                           use_reentrant=False)
        else:
            x = _block(p, i, n, x, train, q, remat)
        if i != len(a["blocks"]) - 1:
            pre = f"backbone.transition{i}"
            h = F.relu(batch_norm(x, p, f"{pre}.bn", train, EPS))
            x = F.avg_pool2d(_product(q, F.conv2d, h,
                                      p[f"{pre}.conv.weight"]), 2, stride=2)
    x = F.relu(batch_norm(x, p, "backbone.bn_final", train, EPS))
    k = min(7, x.shape[-1])
    x = F.avg_pool2d(x, k, stride=k)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def logits(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
           precision: str = "f32", remat: bool = False) -> torch.Tensor:
    q = rounding(precision)
    f = features(p, x, cfg, train, precision, remat)
    return _product(q, F.linear, f, p["classes.weight"]) + p["classes.bias"]
