"""Token vocabulary, index-compatible with gluonnlp's ``Vocab`` (a copy of
``tennis_tpu/data/vocab.py``: ``Vocab``, ``load_embeddings`` and
``captions_vocab``).

Layout: ``0 '<unk>'``, ``1 '<pad>'``, ``2 '<bos>'``, ``3 '<eos>'``, then
corpus tokens by descending frequency, ties alphabetical. Checkpoint token
ids depend on this exact order.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence


class Vocab:
    UNK = "<unk>"
    PAD = "<pad>"
    BOS = "<bos>"
    EOS = "<eos>"

    def __init__(self, counter: Counter | None = None,
                 max_size: int | None = None, min_freq: int = 1):
        self.unknown_token = self.UNK
        self.padding_token = self.PAD
        self.bos_token = self.BOS
        self.eos_token = self.EOS
        self.idx_to_token: list[str] = [self.UNK, self.PAD, self.BOS, self.EOS]
        if counter:
            # alphabetical first, then stable sort by freq desc
            items = sorted(counter.items(), key=lambda kv: kv[0])
            items.sort(key=lambda kv: kv[1], reverse=True)
            for token, freq in items:
                if freq < min_freq:
                    continue
                if max_size is not None and len(self.idx_to_token) >= max_size + 4:
                    break
                if token not in (self.UNK, self.PAD, self.BOS, self.EOS):
                    self.idx_to_token.append(token)
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}

    @classmethod
    def from_tokens(cls, tokens: Iterable[str], **kwargs) -> "Vocab":
        return cls(Counter(tokens), **kwargs)

    def __len__(self) -> int:
        return len(self.idx_to_token)

    def __contains__(self, token: str) -> bool:
        return token in self.token_to_idx

    def to_indices(self, tokens):
        if isinstance(tokens, str):
            return self.token_to_idx.get(tokens, self.token_to_idx[self.UNK])
        return [self.token_to_idx.get(t, self.token_to_idx[self.UNK])
                for t in tokens]

    def to_tokens(self, indices):
        if isinstance(indices, int):
            return self.idx_to_token[indices]
        return [self.idx_to_token[int(i)] for i in indices]

    def __getitem__(self, tokens):
        return self.to_indices(tokens)

    def __repr__(self):
        return f"Vocab(size={len(self)}, unk='{self.UNK}')"


def load_embeddings(path: str, vocab: Vocab, emb_dim: int | None = None):
    """Load an ``embeddings-ex.txt``-style file (``token v0 v1 ...`` a line)
    into a (len(vocab), D) f32 matrix; tokens absent from the file get zero
    vectors. The captioner's fixed ``tgt_embed`` init."""
    import numpy as np

    table = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split()
            if len(parts) < 2:
                continue
            token, vec = parts[0], np.asarray(parts[1:], dtype=np.float32)
            table[token] = vec
            if emb_dim is None:
                emb_dim = len(vec)
    if emb_dim is None:
        raise ValueError(f"no embeddings parsed from {path}")
    out = np.zeros((len(vocab), emb_dim), dtype=np.float32)
    for token, vec in table.items():
        if token in vocab:
            out[vocab[token]] = vec
    return out


def captions_vocab(captions: Sequence[str]) -> Vocab:
    """Vocabulary over whitespace-tokenized caption strings."""
    return Vocab(Counter(" ".join(captions).split()))
