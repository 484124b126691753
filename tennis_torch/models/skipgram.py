"""FastText-style SkipGram with subword n-gram hashing and negative sampling
(counterpart of ``tennis_tpu/models/skipgram.py``), with a torch body.

- subword units are fastText FNV-1a n-gram hashes (ngrams 3-6, 100 buckets),
  gluonnlp's ``NGramHashes``;
- a center word is the weighted mean of its word unit and its subword units:
  each vocab entry has a fixed-width row of unit indices (padding slots
  weigh 0), so a batch lookup is one gather and a weighted sum;
- negatives come from a unigram^0.75 alias table (built on the host) drawn
  on the device from a ``torch.Generator`` (the JAX package draws them with
  ``jax.random``: the same distribution, other values);
- the loss is the reference's masked binary-logistic pair loss, as softplus
  identities.

The tables and the parameters live on the device the model is built for.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def fasttext_hash(s: str) -> int:
    """FNV-1a 32-bit over the UTF-8 bytes (fastText's ngram hash)."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def word_ngram_hashes(word: str, ngrams: Sequence[int], num_buckets: int):
    """Subword hash ids of '<word>' for each n in ``ngrams`` (gluonnlp
    ``NGramHashes`` semantics)."""
    token = f"<{word}>"
    out = []
    for n in ngrams:
        for i in range(len(token) - n + 1):
            out.append(fasttext_hash(token[i: i + n]) % num_buckets)
    return out


def build_subword_table(idx_to_token, ngrams=(3, 4, 5, 6), num_buckets=100):
    """Padded (V, 1 + max_sub) unit-index table and (V, 1 + max_sub)
    weights: row v is [v, its subword ids offset by V...], each real slot
    weighing 1 / (1 + n_sub), padding 0."""
    subs = [word_ngram_hashes(t, ngrams, num_buckets) for t in idx_to_token]
    V = len(idx_to_token)
    width = 1 + max((len(s) for s in subs), default=0)
    idx = np.zeros((V, width), np.int32)
    w = np.zeros((V, width), np.float32)
    for v, s in enumerate(subs):
        weight = 1.0 / (1 + len(s))
        idx[v, 0] = v
        w[v, 0] = weight
        for j, u in enumerate(s):
            idx[v, 1 + j] = V + u
            w[v, 1 + j] = weight
    return idx, w


def build_alias_table(weights, smoothing: float = 0.75):
    """Walker alias tables (prob, alias) for unigram^smoothing sampling."""
    weights = np.asarray(weights, np.float64) ** smoothing
    N = len(weights)
    prob = (weights * N / weights.sum()).tolist()
    alias = [0] * N
    low = [i for i in range(N) if prob[i] < 1.0]
    high = [i for i in range(N) if prob[i] >= 1.0]
    while low and high:
        lo, hi = low.pop(), high.pop()
        alias[lo] = hi
        prob[hi] -= 1.0 - prob[lo]
        (low if prob[hi] < 1.0 else high).append(hi)
    for i in low + high:
        prob[i] = 1.0
        alias[i] = i
    return np.asarray(prob, np.float32), np.asarray(alias, np.int32)


def alias_sample(generator: torch.Generator, prob: torch.Tensor,
                 alias: torch.Tensor, shape) -> torch.Tensor:
    """Draw ``shape`` class ids (int64) from the alias tables, on the
    generator's device."""
    dev = generator.device
    idx = torch.randint(0, prob.shape[0], shape, generator=generator,
                        device=dev)
    accept = torch.rand(shape, generator=generator, device=dev) < prob[idx]
    return torch.where(accept, idx, alias[idx].long())


class SkipGram:
    """The tables and pure functions of the model (its parameters are two
    embedding tables, passed in as a dict)."""

    def __init__(self, vocab_size: int, num_buckets: int, emb_size: int,
                 counts, ngrams=(3, 4, 5, 6), num_negatives: int = 3,
                 smoothing: float = 0.75, idx_to_token=None,
                 device: str | torch.device = "cpu"):
        self.vocab_size = vocab_size
        self.num_units = vocab_size + num_buckets
        self.emb_size = emb_size
        self.num_negatives = num_negatives
        self.device = torch.device(device)
        sub_idx, sub_w = build_subword_table(
            idx_to_token if idx_to_token is not None
            else [str(i) for i in range(vocab_size)], ngrams, num_buckets)
        self.subword_idx = torch.from_numpy(sub_idx).long().to(self.device)
        self.subword_w = torch.from_numpy(sub_w).to(self.device)
        prob, alias = build_alias_table(counts, smoothing)
        self.alias_prob = torch.from_numpy(prob).to(self.device)
        self.alias_alias = torch.from_numpy(alias).to(self.device)

    def init_params(self, generator: torch.Generator) -> dict:
        """``embedding`` (units x D) uniform in +-1/D, ``embedding_out``
        (V x D) zero, on the model's device."""
        d = self.emb_size
        emb = torch.rand(self.num_units, d, generator=generator,
                         device=self.device) * (2.0 / d) - 1.0 / d
        return {"embedding": emb,
                "embedding_out": torch.zeros(self.vocab_size, d,
                                             device=self.device)}

    def embed_words(self, params: dict, word_ids: torch.Tensor):
        """Mean-of-units center embedding (word + its subword hashes)."""
        units = self.subword_idx[word_ids]          # (B, W)
        weights = self.subword_w[word_ids]          # (B, W)
        vecs = params["embedding"][units]           # (B, W, D)
        return torch.einsum("bw,bwd->bd", weights, vecs)

    def sample_negatives(self, generator: torch.Generator, batch: int):
        return alias_sample(generator, self.alias_prob, self.alias_alias,
                            (batch, self.num_negatives))

    def loss(self, params: dict, center: torch.Tensor, context: torch.Tensor,
             negatives: torch.Tensor):
        """Per-pair loss (B,): the positive pair's softplus(-x), the
        negatives' softplus(x) masked where a negative equals the center or
        the context, both over (mask sum + 1). ``negatives`` (B, K) from
        :meth:`sample_negatives`."""
        mask = ((negatives != center[:, None])
                & (negatives != context[:, None])).float()
        norm = mask.sum(dim=1) + 1
        emb_center = self.embed_words(params, center)            # (B, D)
        emb_context = params["embedding_out"][context]           # (B, D)
        pred_pos = (emb_center * emb_context).sum(-1)            # (B,)
        loss_pos = F.softplus(-pred_pos) / norm
        emb_neg = params["embedding_out"][negatives]             # (B, K, D)
        pred_neg = torch.einsum("bd,bkd->bk", emb_center, emb_neg)
        loss_neg = (F.softplus(pred_neg) * mask).sum(dim=1) / norm
        return loss_pos + loss_neg

    def token_vectors(self, params: dict) -> torch.Tensor:
        """Row-normalized per-token vectors, as the reference exports them."""
        vecs = self.embed_words(params, torch.arange(self.vocab_size,
                                                     device=self.device))
        norm = torch.sqrt((vecs * vecs).sum(dim=1) + 1e-10)
        return vecs / norm[:, None]
