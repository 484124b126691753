"""Scaled Luong (dot-product) attention (counterpart of
``tennis_tpu/ops/attention.py``): the query is projected by a bias-free
Dense to ``units``, scores are dot products scaled by 1/sqrt(units), masked,
softmaxed, and applied to the values.

With ``mem_sharding`` (a model world; the counterpart of the JAX
``NMTModel(mem_sharding=)``, under which GSPMD splits every attention
step) the keys, values and mask are this model rank's block of the
memory's time axis: the scores are local, the row maximum is all-reduced
with MAX, the exponent sums and the partial contexts with SUM over the
model group (:func:`sharded_masked_softmax`), and the weights returned
are this rank's block.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from tennis_torch.ops.rnn import dense
from tennis_torch.parallel.distributed import max_model_, reduce_model, \
    to_model


def masked_softmax(scores, mask, dim: int = -1):
    """Softmax with a boolean mask (True = attend). Fully-masked rows give
    zeros."""
    if mask is None:
        return torch.softmax(scores, dim=dim)
    neg = torch.finfo(torch.float32).min
    out = torch.softmax(scores.masked_fill(~mask, neg), dim=dim)
    return torch.where(mask.any(dim=dim, keepdim=True), out,
                       torch.zeros_like(out))


def sharded_masked_softmax(scores, mask, world, dim: int = -1):
    """:func:`masked_softmax` of scores whose ``dim`` is split over the
    model group, this rank's block: the weights of this block, normalised
    by the exponent sum over every block, the maximum taken over every
    block (a MAX all-reduce, without a gradient: the softmax does not
    depend on it). A block with no unmasked step gives zeros and no NaN:
    where the row has an unmasked step in another block, ``exp`` of the
    fill less that maximum is 0; where it has none in any block (a
    fully-masked row), every block's weights are zeroed, not a uniform
    spread."""
    neg = torch.finfo(torch.float32).min
    if mask is not None:
        scores = scores.masked_fill(~mask, neg)
    top = max_model_(scores.detach().amax(dim=dim, keepdim=True), world)
    e = torch.exp(scores - top)
    z = reduce_model(e.sum(dim=dim, keepdim=True), world)
    weights = e / to_model(z, world)
    if mask is not None:
        weights = torch.where(mask.any(dim=dim, keepdim=True), weights,
                              torch.zeros_like(weights))
    return weights


class LuongAttention(nn.Module):
    """query (B, Tq, C) x memory (B, Tm, units) -> (context (B, Tq, units),
    weights (B, Tq, Tm)); with ``mem_sharding`` the memory, its mask and
    the weights are this model rank's time block, the context whole."""

    def __init__(self, query_size: int, units: int, scaled: bool = True,
                 generator: torch.Generator | None = None,
                 mem_sharding=None):
        super().__init__()
        self.units = units
        self.scaled = scaled
        self.mem_sharding = mem_sharding
        self.query_proj = dense(query_size, units, bias=False,
                                generator=generator)

    def forward(self, query, keys, values, mask=None):
        world = self.mem_sharding
        q = self.query_proj(query)
        if world is not None:
            q = to_model(q, world)
        scores = torch.einsum("bqc,bmc->bqm", q, keys.to(q.dtype))
        if self.scaled:
            scores = scores / math.sqrt(self.units)
        if mask is not None and mask.dim() == 2:  # (B, Tm) -> (B, 1, Tm)
            mask = mask[:, None, :]
        if world is None:
            weights = masked_softmax(scores, mask)
        else:
            weights = sharded_masked_softmax(scores, mask, world)
        context = torch.einsum("bqm,bmc->bqc", weights, values.to(q.dtype))
        if world is not None:
            context = reduce_model(context, world)
        return context, weights
