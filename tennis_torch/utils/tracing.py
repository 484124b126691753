"""Spans and counts at the port's layer boundaries, off unless turned on.

Off (the default), :func:`span` returns one shared null context and
:func:`count` returns at once: the only cost is a check of a module-level
flag. On (:func:`enabled`), each span is kept in memory when it closes:
its name, start and end (``time.perf_counter_ns``), its thread and its
parent, the span open on the same thread when it opened. While a
``torch.profiler`` session runs, an open span is also a
``record_function`` range named ``tennis_torch/<name>``, so that the
profiler's trace holds the spans on its own clock, beside the device's
records; with no profiler running no range is opened.

:func:`snapshot` reduces what was kept, by name: calls, total host
seconds and self seconds (the total less the time its child spans cover),
the counts, and the counters that live beside the kernels and the
collectives (read where they live). :func:`reset` clears them all.

The spans of the port, one layer boundary each:

- ``train_step`` (``parallel/train_step.py``) around ``augment``,
  ``forward``, ``loss``, ``backward``, ``grad_all_reduce`` and ``update``;
- ``bn_forward`` and ``bn_backward``, the train-mode BN of DenseNet and
  R(2+1)D (``models/backbones/densenet.py``); a CUDA backward runs on
  autograd's device thread, where ``bn_backward`` has no parent;
- ``prepare`` and ``features`` of the extraction (``inference.py``), with
  ``transition`` around each DenseNet transition of the eval forward and
  ``dense_layer`` around the route, the checks and the dispatch of one
  dense layer (``ops/dense_block.py``), outside the op.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch.autograd.profiler as _profiler

PREFIX = "tennis_torch/"

_on = False
_NULL = contextlib.nullcontext()
_kept: list = []  # closed spans, in the order they closed
_counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
_local = threading.local()  # .stack: the open spans of this thread


class _Span:
    """One span while it is open and after it closed."""

    __slots__ = ("name", "start", "end", "thread", "parent", "child_ns",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0  # the time the span's children cover

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end - self.start
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _kept.append(self)
        return False


def span(name: str):
    """A context that records ``name`` around its block while tracing is
    on; the one shared null context while it is off."""
    return _Span(name) if _on else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` while tracing is on."""
    if _on:
        with _count_lock:
            _counts[name] += n


def enabled(on: bool) -> bool:
    """Turn tracing on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def _counters() -> dict:
    """The counters kept beside the kernels and the collectives, as their
    modules hold them now."""
    from tennis_torch.ops.dense_block import dense_layer
    from tennis_torch.ops.gru import gru_recurrence
    from tennis_torch.parallel import distributed

    return {"dense_layer.variant_launches": dense_layer.variant_launches,
            "gru_recurrence.variant_launches":
                gru_recurrence.variant_launches,
            "gru_recurrence.plain_routed": gru_recurrence.plain_routed,
            "distributed.model_collectives": distributed.model_collectives}


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "total_s", "self_s"}}, "counts":
    {name: n}, "counters": {...}}`` of what was kept since the last
    :func:`reset`; a span still open is not in it."""
    spans: dict = {}
    for s in list(_kept):
        agg = spans.setdefault(s.name, {"calls": 0, "total_s": 0.0,
                                        "self_s": 0.0})
        ns = s.end - s.start
        agg["calls"] += 1
        agg["total_s"] += ns / 1e9
        agg["self_s"] += (ns - s.child_ns) / 1e9
    counters = {k: dict(v) if isinstance(v, dict) else v
                for k, v in _counters().items()}
    with _count_lock:
        counts = dict(_counts)
    return {"spans": spans, "counts": counts, "counters": counters}


def reset() -> None:
    """Forget the kept spans and the counts, and zero the counters that
    :func:`snapshot` reads."""
    from tennis_torch.ops.gru import gru_recurrence

    _kept.clear()
    with _count_lock:
        _counts.clear()
    counters = _counters()
    for name in ("dense_layer.variant_launches",
                 "gru_recurrence.variant_launches"):
        launches = counters[name]
        launches.update(dict.fromkeys(launches, 0))
    counters["distributed.model_collectives"].clear()
    gru_recurrence.plain_routed = 0
