"""Length-bucketed batching for the captioner (a copy of
``tennis_tpu/data/bucketing.py``: the same batches for the same seed and
epoch).

Equivalent of gluonnlp's ``FixedBucketSampler`` + Pad batchify used by the reference
(reference utils/captioning.py:28-86): samples are grouped into ``num_buckets``
buckets by length so padding waste is bounded, with constant / linear / exponential
bucket-width schemes and an optional ``ratio`` that scales batch size up in small
buckets.

Each bucket pads its time axes up to a multiple of ``pad_multiple``; the
captioner's loss divides by that padded target length, so the padding is
part of the result, not only of the speed.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def bucket_keys(lengths: Sequence[int], num_buckets: int, scheme: str = "constant",
                step: float = 1.2):
    """Compute bucket boundary keys (inclusive max length per bucket)."""
    max_len = max(lengths)
    min_len = min(lengths)
    span = max(max_len - min_len, 1)
    if num_buckets <= 1:
        return [max_len]
    if scheme == "constant":
        widths = [span / num_buckets] * num_buckets
    elif scheme == "linear":
        # widths proportional to 1, 2, 3, ...
        total = num_buckets * (num_buckets + 1) / 2
        widths = [span * (i + 1) / total for i in range(num_buckets)]
    elif scheme == "exp":
        total = sum(step**i for i in range(num_buckets))
        widths = [span * step**i / total for i in range(num_buckets)]
    else:
        raise NotImplementedError(f"bucket scheme {scheme!r}")
    keys, acc = [], float(min_len)
    for w in widths:
        acc += w
        keys.append(int(math.ceil(acc)))
    keys[-1] = max(keys[-1], max_len)
    return keys


class FixedBucketSampler:
    """Yields batches of sample indices, grouped by bucket.

    ``lengths`` may be ints or tuples; tuples are bucketed on element
    ``key_element`` and both axes are padded within the bucket. The reference's
    TRAIN sampler buckets gluonnlp-jointly on (frames, caption) while we key on
    frames alone — the axis that dominates padding waste; its VAL/TEST samplers
    bucket on caption length only (reference utils/captioning.py:38-39,
    ``target_*_lengths = map(x[-1], lens)``), which callers reproduce by
    passing ``key_element=-1``.
    """

    def __init__(self, lengths, batch_size: int, num_buckets: int = 5,
                 scheme: str = "constant", ratio: float = 0.0,
                 shuffle: bool = False, seed: int = 0,
                 batch_multiple: int = 1, key_element: int = 0):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # every yielded batch size is a multiple of this (data-parallel meshes
        # need the batch axis to divide across devices); ragged per-bucket tail
        # batches are trimmed, dropping < batch_multiple samples per bucket —
        # under shuffle a different tail each epoch (documented deviation: the
        # reference's gluonnlp sampler keeps ragged tails, single-GPU only)
        self.batch_multiple = max(1, batch_multiple)

        if not self.lengths:  # empty split: zero batches, still iterable
            self.keys, self.buckets, self.batch_sizes = [], [], []
            self.bucket_batch_sizes = []
            return

        scalar = [l[key_element] if isinstance(l, (tuple, list)) else l
                  for l in self.lengths]
        keys = bucket_keys(scalar, num_buckets, scheme)
        buckets: list[list[int]] = [[] for _ in keys]
        for i, l in enumerate(scalar):
            for b, k in enumerate(keys):
                if l <= k:
                    buckets[b].append(i)
                    break
        # batch size per bucket: larger batches for shorter buckets when ratio > 0
        # (gluonnlp's ratio semantics: scale ∝ max_key/key, floored at batch_size)
        self.bucket_batch_sizes = [
            max(int(batch_size * max(1.0, ratio * keys[-1] / max(k, 1))), batch_size)
            if ratio > 0 else batch_size
            for k in keys
        ]
        # keep every FULL batch intact under batch_multiple: round the
        # ratio-scaled per-bucket batch sizes DOWN to a multiple, so __iter__'s
        # trim only ever touches the ragged tail (< batch_multiple samples
        # dropped per bucket, as documented in PARITY.md D14)
        bm = self.batch_multiple
        if bm > 1:
            self.bucket_batch_sizes = [
                max(bm, bs - bs % bm) for bs in self.bucket_batch_sizes
            ]
        # drop empty buckets, keeping keys/buckets/batch_sizes ALIGNED (an
        # unfiltered key list would misattribute stats() lines past the first
        # empty bucket)
        kept = [(k, b, bs) for k, b, bs in
                zip(keys, buckets, self.bucket_batch_sizes) if b]
        self.keys = [k for k, _, _ in kept]
        self.buckets = [b for _, b, _ in kept]
        self.batch_sizes = [bs for _, _, bs in kept]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        bm = self.batch_multiple
        batches = []
        for bucket, bs in zip(self.buckets, self.batch_sizes):
            order = list(bucket)
            if self.shuffle:
                rng.shuffle(order)
            for i in range(0, len(order), bs):
                batch = order[i : i + bs]
                if bm > 1:
                    batch = batch[: len(batch) - len(batch) % bm]
                if batch:
                    batches.append(batch)
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        bm = self.batch_multiple
        total = 0
        for b, bs in zip(self.buckets, self.batch_sizes):
            total += len(b) // bs  # bs is always a positive multiple of bm
            tail = len(b) % bs
            if tail - tail % bm > 0:
                total += 1
        return total

    def stats(self) -> str:
        lines = ["FixedBucketSampler:"]
        for key, bucket, bs in zip(self.keys, self.buckets, self.batch_sizes):
            lines.append(f"  key<={key}: {len(bucket)} samples, batch {bs}")
        return "\n".join(lines)


class BucketedCaptionLoader:
    """Batches a captions-mode TennisSet: pads frame sequences and caption ids within
    each bucket (gluonnlp Pad/Stack batchify tuple, reference utils/captioning.py:
    33-37) and yields numpy tuples
    ``(src (B, T, ...), tgt (B, L), src_vl (B,), tgt_vl (B,)[, idx])``.
    """

    def __init__(self, dataset, batch_size: int, num_buckets: int = 5,
                 scheme: str = "constant", ratio: float = 0.0,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 8,
                 pad_multiple: int = 1, batch_multiple: int = 1,
                 key_element: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        self.dataset = dataset
        # key_element=0 buckets on frames (train); -1 on caption length, the
        # reference's val/test sampler key (utils/captioning.py:38-39)
        self.sampler = FixedBucketSampler(
            dataset.get_data_lens(), batch_size, num_buckets, scheme, ratio,
            shuffle, seed, batch_multiple=batch_multiple,
            key_element=key_element,
        )
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self._pool_cls = ThreadPoolExecutor

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def _round(self, n: int) -> int:
        m = self.pad_multiple
        return ((n + m - 1) // m) * m

    def __iter__(self):
        from tennis_torch.data.loader import padded_batch

        with self._pool_cls(self.num_workers) as pool:
            for batch_idx in self.sampler:
                samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                srcs = [s[0] for s in samples]
                caps = [np.asarray(s[1]) for s in samples]
                src, src_vl = padded_batch(srcs)
                tgt, tgt_vl = padded_batch(caps)
                # round padded time axes up so bucket shapes stay stable
                src = _pad_axis(src, 1, self._round(src.shape[1]))
                tgt = _pad_axis(tgt, 1, self._round(tgt.shape[1]))
                out = (src, tgt, src_vl.astype(np.float32),
                       tgt_vl.astype(np.float32))
                if len(samples[0]) == 5:  # inference mode appends idx
                    out = out + (np.asarray([s[4] for s in samples]),)
                yield out


def _pad_axis(arr: np.ndarray, axis: int, target: int):
    if arr.shape[axis] >= target:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, pad)
