"""Checkpoint / resume / model-selection conventions (counterpart of
``tennis_tpu/utils/checkpoint.py``):

- ``<exp_dir>/{epoch:04d}.params``  one flax-msgpack file per epoch;
- resume = the newest epoch file that parses, continued at epoch + 1; a
  file whose bytes do not parse is renamed ``<name>.corrupt``;
- ``<exp_dir>/scores.txt``          appended ``<epoch>\\t<score>`` lines,
  best = argmax.

The files are encoded and decoded by the port's own codec
(``utils.msgpack_codec``), byte for byte flax's format, so the JAX package
resumes and scores what the port writes and the other way round. Writes go
to a temp file in the same directory, are fsynced, then ``os.replace``d:
a process killed mid-save never leaves a truncated epoch file.
"""
from __future__ import annotations

import concurrent.futures
import logging
import os
import re

from tennis_torch.utils import msgpack_codec

_EPOCH_RE = re.compile(r"^(\d{4})\.params$")

log = logging.getLogger(__name__)


def _atomic_write(path: str, data: bytes) -> None:
    """Write via a same-directory temp file, fsync, then ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_state(path: str, tree) -> None:
    """Atomic write of a flax-layout tree (``bridge.state_to_flax``). The
    tree is whole under a model axis too: ``state_to_flax`` gathers the
    column blocks over the model group (every model rank calls it, one
    rank writes), so the file is the one the plain run writes."""
    _atomic_write(path, msgpack_codec.serialize(tree))


def load_raw(path: str):
    """Restore a checkpoint as plain nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_codec.restore(f.read())


def epoch_path(exp_dir: str, epoch: int) -> str:
    return os.path.join(exp_dir, f"{epoch:04d}.params")


def list_epochs(exp_dir: str) -> list[int]:
    if not os.path.isdir(exp_dir):
        return []
    epochs = []
    for f in os.listdir(exp_dir):
        m = _EPOCH_RE.match(f)
        if m:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def latest_epoch(exp_dir: str) -> int | None:
    epochs = list_epochs(exp_dir)
    return epochs[-1] if epochs else None


def append_score(exp_dir: str, epoch: int, score: float) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "scores.txt"), "a") as f:
        f.write(f"{epoch}\t{score}\n")


def best_epoch(exp_dir: str) -> tuple[int, float] | None:
    """Argmax epoch from scores.txt; rows whose checkpoint file is missing
    are skipped, since every caller loads that file next."""
    path = os.path.join(exp_dir, "scores.txt")
    if not os.path.exists(path):
        return None
    best = None
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                epoch, score = int(parts[0]), float(parts[1])
                if not os.path.exists(epoch_path(exp_dir, epoch)):
                    log.warning("scores.txt row for epoch %d has no %s — "
                                "skipping", epoch, epoch_path(exp_dir, epoch))
                    continue
                if best is None or score > best[1]:
                    best = (epoch, score)
    return best


def best_or_latest(exp_dir: str) -> tuple[int, float]:
    """Best epoch by scores.txt, else the latest checkpoint (score nan), else
    FileNotFoundError."""
    best = best_epoch(exp_dir)
    if best is None:
        latest = latest_epoch(exp_dir)
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoints or scores.txt in {exp_dir}")
        best = (latest, float("nan"))
    return best


def _readable(exp_dir: str, quarantine: bool):
    """``(epoch, tree)`` of the newest epoch file that parses, else None. A
    file whose bytes do not parse is passed over, and with ``quarantine``
    renamed to ``<name>.corrupt``. Errors reading the file itself propagate:
    the bytes may be healthy."""
    for epoch in reversed(list_epochs(exp_dir)):
        path = epoch_path(exp_dir, epoch)
        with open(path, "rb") as f:
            data = f.read()
        try:
            return epoch, msgpack_codec.restore(data)
        except msgpack_codec.DecodeError as e:
            moved = ""
            if quarantine:
                moved = path + ".corrupt"
                try:
                    os.replace(path, moved)
                except OSError:
                    moved = "<rename failed>"
                moved = f", quarantined to {moved}"
            log.warning("unreadable checkpoint %s (%s)%s - trying the "
                        "next-newest epoch", path, e, moved)
    return None


def latest_readable(exp_dir: str):
    """``(epoch, tree)`` of the newest epoch file that parses, else None;
    an unreadable file is skipped and left where it is."""
    return _readable(exp_dir, quarantine=False)


def resume_state(exp_dir: str, restore) -> int:
    """Crash-safe resume: the first epoch to run. The newest epoch file that
    parses goes to ``restore(tree)``, and the run continues at its epoch + 1
    (0 when none parses). A file whose bytes do not parse is quarantined to
    ``<name>.corrupt`` and the scan goes on to the next-newest. A file that
    parses but that ``restore`` refuses is an architecture or flag mismatch,
    not corruption: it raises ``ValueError`` and the file stays."""
    found = _readable(exp_dir, quarantine=True)
    if found is None:
        return 0
    epoch, tree = found
    try:
        restore(tree)
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(
            f"checkpoint {epoch_path(exp_dir, epoch)} parsed cleanly but does "
            f"not match the model - architecture/flag mismatch, not file "
            f"corruption; the file was left intact ({e})") from e
    return epoch + 1


def param_count(module) -> int:
    return sum(p.numel() for p in module.parameters())


class AsyncCheckpointer:
    """Overlap the msgpack encode and the disk write with the next epoch.

    ``save(path, tree)`` takes a host tree that no later step mutates
    (``bridge.state_to_flax`` copies every leaf off the live tensors, so
    taking it is the synchronous snapshot), then hands the encode and the
    atomic write to one background thread. Tasks run in submission order,
    so the resume scan only ever sees a consistent prefix of the saved
    epochs; ``submit(fn)`` sequences a side effect behind every earlier
    write (the trainer appends the ``scores.txt`` row only after its epoch
    file is durable). ``save`` first waits for every earlier task, so at most
    one snapshot is pending, and re-raises the first failure; ``wait()``
    drains and re-raises, and runs on context-manager exit.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._futures: list = []

    def save(self, path: str, tree) -> None:
        self.wait()  # bound in-flight snapshots to one; fail fast on errors
        self._futures.append(self._pool.submit(save_state, path, tree))

    def submit(self, fn) -> None:
        """Run ``fn()`` on the writer thread, after every earlier task."""
        self._futures.append(self._pool.submit(fn))

    def wait(self) -> None:
        """Drain pending tasks; re-raise the first error (once)."""
        futures, self._futures = self._futures, []
        try:
            for f in futures:
                f.result()
        except BaseException:
            for g in futures:
                if g is not f and g.exception() is not None:
                    log.warning("additional checkpoint-write failure: %s",
                                g.exception())
            raise

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
            return False
        # an exceptional unwind still drains and shuts the writer down, but
        # a write failure never masks the exception already in flight
        try:
            self.close()
        except Exception as e:
            log.warning("checkpoint writer failed during unwind: %s", e)
        return False
