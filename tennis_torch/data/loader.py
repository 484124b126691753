"""Host data loader: threaded sample loading, then a two-stage prefetch to
the device (counterpart of ``tennis_tpu/data/loader.py``).

``DataLoader`` batches a map-style dataset on a thread pool (cv2 releases
the GIL while it decodes and resizes) into stacked numpy: uint8 images,
int labels, int sample indices. Its epoch permutation is seeded and shared
by every shard, each shard taking a disjoint stripe, as in the JAX package.

``prefetch_to_device`` overlaps the loader with device compute. A batch is a
tuple ``(inputs, *rest)``: ``inputs`` goes to the device and ``rest``
(labels, sample indices) stays on the host, where the drivers read it. On a
CUDA device the copy goes through pinned host buffers and a side stream.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch


def _default_collate(samples: Sequence):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(_default_collate([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    return np.asarray(samples)


class DataLoader:
    """Iterate a map-style dataset in batches with threaded sample loading."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = False,
                 collate_fn: Callable = _default_collate, num_shards: int = 1,
                 shard_id: int = 0, transform: Callable | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.transform = transform
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseeds the shuffle; every shard agrees on the permutation."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            # equal stripes: the permutation wraps to a multiple of
            # num_shards, so every shard sees the same number of batches
            per = -(-n // self.num_shards)
            idx = np.resize(idx, per * self.num_shards)
        return idx[self.shard_id::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, i: int):
        sample = self.dataset[int(i)]
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def __iter__(self) -> Iterator:
        idx = self._indices()
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(idx), self.batch_size):
                chunk = idx[start:start + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                yield self.collate_fn(list(pool.map(self._fetch, chunk)))


class _PinnedRing:
    """Pinned host buffers for the host-to-device copies, used in turn. A
    buffer is refilled only once the copy that last read it has completed
    (its event), so a copy never reads bytes of the next batch."""

    def __init__(self, slots: int):
        self._bufs = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def to_device(self, x: np.ndarray, device, stream):
        """(device tensor, event of its copy on ``stream``)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        src = torch.from_numpy(np.ascontiguousarray(x))
        nbytes = src.numel() * src.element_size()
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
        staged = buf[:nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        with torch.cuda.stream(stream):
            out = staged.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self._events[i] = event
        return out, event


def prefetch_to_device(iterator, device=None, buffer_size: int = 2,
                       stats: dict | None = None, moved: int = 1):
    """Move batches to ``device`` ahead of compute, in two stages.

    Stage 1 (source thread) pulls host batches from ``iterator`` into a
    queue; stage 2 (transfer thread) moves each batch's inputs (its first
    ``moved`` elements, or the batch itself when it is an array) to
    ``device`` into a second queue that the consumer reads; the rest of a
    tuple batch stays on the host as it is. On a CUDA device the transfer
    copies into a ring of pinned host buffers, then copies to the device
    without blocking on a side stream; the consumer's stream waits on the
    batch's last copy, and each device tensor is marked as used by the
    consumer's stream, so the allocator does not hand its memory to a later
    copy while the consumer's kernels may still read it. On the CPU
    (``device`` None or "cpu") the inputs are yielded as host tensors.

    ``stats`` (optional dict) accumulates ``source_s`` (time blocked on the
    upstream iterator: decode), ``device_put_s`` (time staging and enqueuing
    the copy), ``queue_full_s`` (time the transfer thread waited on a full
    queue: the consumer is the slower side) and ``batches``. A loader
    exception surfaces in the consumer; a consumer that stops early stops
    both threads.
    """
    device = torch.device(device if device is not None else "cpu")
    cuda = device.type == "cuda"
    if stats is not None:
        for k in ("source_s", "device_put_s", "queue_full_s"):
            stats.setdefault(k, 0.0)
        stats.setdefault("batches", 0)

    host_q: queue.Queue = queue.Queue(maxsize=buffer_size)
    dev_q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    err = []
    stop = threading.Event()  # the consumer abandoned the generator
    stream = torch.cuda.Stream(device) if cuda else None
    # slots: one per input of a batch that can be queued, being copied or
    # being consumed, so a refill seldom waits
    ring = _PinnedRing((buffer_size + 2) * moved) if cuda else None

    def put(batch):
        """(batch with its inputs moved, event of its last copy or None)."""
        tuple_batch = isinstance(batch, (tuple, list))
        inputs, rest = (batch[:moved], tuple(batch[moved:])) if tuple_batch \
            else ((batch,), ())
        out, event = [], None
        for x in inputs:
            if cuda:
                with torch.cuda.device(device):
                    x, event = ring.to_device(x, device, stream)
            else:
                x = torch.from_numpy(np.asarray(x))
            out.append(x)
        return ((*out, *rest) if tuple_batch else out[0]), event

    def _bounded_put(q, item) -> bool:
        # a consumer that left never drains the queue: a blocking put would
        # pin the thread, and the batches it holds, for the process's life
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def source():
        try:
            it = iter(iterator)
            while True:
                tic = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if stats is not None:
                    stats["source_s"] += time.perf_counter() - tic
                if not _bounded_put(host_q, batch):
                    return
        except Exception as e:  # surfaces on the consumer side
            err.append(e)
        finally:
            _bounded_put(host_q, sentinel)

    def transfer():
        try:
            while True:
                try:
                    item = host_q.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is sentinel:
                    break
                tic = time.perf_counter()
                item = put(item)
                toc = time.perf_counter()
                if not _bounded_put(dev_q, item):
                    return
                if stats is not None:
                    stats["device_put_s"] += toc - tic
                    stats["queue_full_s"] += time.perf_counter() - toc
                    stats["batches"] += 1
        except Exception as e:
            err.append(e)
        finally:
            _bounded_put(dev_q, sentinel)

    threads = [threading.Thread(target=source, daemon=True),
               threading.Thread(target=transfer, daemon=True)]
    for t in threads:
        t.start()
    try:
        while True:
            item = dev_q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for x in (batch[:moved] if isinstance(batch, tuple)
                          else (batch,)):
                    x.record_stream(consumer)
            yield batch
    finally:
        stop.set()  # GeneratorExit or an exception on the consumer side


def padded_batch(arrays: Sequence[np.ndarray], pad_value=0, axis: int = 0):
    """Stack variable-length arrays, padding ``axis`` to the batch's
    longest (gluonnlp's ``batchify.Pad``). Returns (stacked, int32
    lengths)."""
    lengths = np.asarray([a.shape[axis] for a in arrays], dtype=np.int32)
    max_len = int(lengths.max())
    out = []
    for a in arrays:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, max_len - a.shape[axis])
        out.append(np.pad(a, pad, constant_values=pad_value))
    return np.stack(out), lengths


def eval_iter(loader, step, device=None):
    """Drive an eval ``step`` over ``loader`` on one device: prefetch each
    batch to ``device``, run ``step(inputs)`` and yield ``(out, labels,
    idxs)`` as host numpy, ``out`` in f32. The single-device counterpart of
    the JAX package's ``sharded_eval_iter``: one shard, so no wrapped
    duplicates to drop, and no static batch shape, so the ragged last batch
    runs at its own size."""
    for inputs, labels, idxs in prefetch_to_device(iter(loader), device):
        out = step(inputs)
        yield out.float().cpu().numpy(), np.asarray(labels), np.asarray(idxs)
