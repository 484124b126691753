"""The port's host loader against the JAX package's: ``DataLoader`` batches
and order (shuffle, seed, epoch, ``drop_last``, shards), ``prefetch_to_device``
on the CPU (the same batches as host tensors, its stats, a loader exception
surfacing, an early break stopping both threads), and ``eval_iter``."""
import threading
import time

import numpy as np
import pytest
import torch

from tennis_tpu.data.loader import DataLoader as JaxDataLoader
from tennis_torch.data.loader import DataLoader, eval_iter, prefetch_to_device


class _Frames:
    """A map-style dataset of seeded uint8 frames: (img, label, idx)."""

    def __init__(self, n, side=6, seed=0):
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 11, n)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], int(self.labels[i]), i


def _flip(sample):
    img, label, idx = sample
    return img[::-1].copy(), label, idx


def _batches(loader):
    return [tuple(np.asarray(x) for x in b) for b in loader]


@pytest.mark.parametrize("n,batch,shuffle,drop_last,shards", [
    (37, 8, False, False, 1), (37, 8, True, False, 1), (37, 8, True, True, 1),
    (40, 8, True, True, 1), (37, 5, True, False, 2), (37, 4, False, True, 3),
    (5, 8, False, True, 1), (5, 8, True, False, 3)])
def test_dataloader_equals_jax(n, batch, shuffle, drop_last, shards):
    ds = _Frames(n)
    for epoch in (0, 3):
        for shard in range(shards):
            kw = dict(batch_size=batch, shuffle=shuffle, seed=11,
                      num_workers=3, drop_last=drop_last, num_shards=shards,
                      shard_id=shard, transform=_flip)
            got, want = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert len(got) == len(want)
            np.testing.assert_array_equal(got._indices(), want._indices())
            bg, bw = _batches(got), _batches(want)
            assert len(bg) == len(bw) == len(got)
            for g, w in zip(bg, bw):
                assert len(g) == len(w) == 3
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_prefetch_on_cpu_yields_the_batches_and_stats():
    ds = _Frames(37)
    loader = DataLoader(ds, batch_size=8, num_workers=2)
    stats = {}
    got = list(prefetch_to_device(iter(loader), "cpu", stats=stats))
    want = _batches(loader)
    assert len(got) == len(want) == 5
    for (img, labels, idxs), (w_img, w_labels, w_idxs) in zip(got, want):
        assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
        np.testing.assert_array_equal(img.numpy(), w_img)
        np.testing.assert_array_equal(labels, w_labels)  # host numpy
        np.testing.assert_array_equal(idxs, w_idxs)
    assert stats["batches"] == 5
    assert set(stats) == {"source_s", "device_put_s", "queue_full_s",
                          "batches"}
    assert all(stats[k] >= 0.0 for k in ("source_s", "device_put_s",
                                         "queue_full_s"))
    # a bare array batch moves whole; device None is the CPU
    arrays = [np.full((2, 3), i, np.float32) for i in range(3)]
    out = list(prefetch_to_device(iter(arrays)))
    assert [int(t[0, 0]) for t in out] == [0, 1, 2]


def test_prefetch_surfaces_loader_errors():
    def broken():
        yield np.zeros(4), np.zeros(4), np.arange(4)
        raise OSError("unreadable frame")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable frame"):
        next(it)


def test_prefetch_stops_when_the_consumer_breaks():
    """An early break leaves no prefetch thread behind (the producer would
    otherwise block on a full queue forever)."""
    before = threading.active_count()

    def endless():
        i = 0
        while True:
            yield np.full(4, i), np.zeros(4), np.arange(4)
            i += 1

    for k, _batch in enumerate(prefetch_to_device(endless(), "cpu",
                                                  buffer_size=1)):
        if k == 3:
            break
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_eval_iter_covers_every_sample_once():
    ds = _Frames(29)
    loader = DataLoader(ds, batch_size=8, num_workers=2)
    seen, sizes = [], []
    for out, labels, idxs in eval_iter(
            loader, lambda x: x.float().mean(dim=(1, 2, 3)).to(torch.bfloat16),
            "cpu"):
        assert out.dtype == np.float32
        np.testing.assert_array_equal(labels, ds.labels[idxs])
        np.testing.assert_allclose(out, ds.imgs[idxs].mean(axis=(1, 2, 3)),
                                   rtol=2 ** -7)
        seen += idxs.tolist()
        sizes.append(len(idxs))
    assert sorted(seen) == list(range(29))
    assert sizes == [8, 8, 8, 5]  # the ragged batch at its own size
