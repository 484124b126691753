"""Accuracy metrics with ignored labels (counterpart of
``tennis_tpu/metrics/accuracy.py``): plain accuracy, accuracy without the
background class, accuracy on the background class only, and top-k."""
from __future__ import annotations

import numpy as np


class Accuracy:
    """Streaming accuracy; samples whose label is in ``ignore_labels`` are
    skipped."""

    def __init__(self, name: str = "accuracy", ignore_labels=()):
        self.name = name
        self.ignore_labels = np.asarray(list(ignore_labels), dtype=np.int64)
        self.reset()

    def reset(self):
        self.num_correct = 0
        self.num_total = 0

    def update(self, labels, preds):
        labels = np.asarray(labels).reshape(-1).astype(np.int64)
        preds = np.asarray(preds)
        if preds.ndim > 1 and preds.shape != labels.shape:
            preds = preds.reshape(len(labels), -1).argmax(axis=-1)
        preds = preds.reshape(-1).astype(np.int64)
        keep = ~np.isin(labels, self.ignore_labels)
        self.num_correct += int((preds[keep] == labels[keep]).sum())
        self.num_total += int(keep.sum())

    def get(self):
        value = self.num_correct / self.num_total if self.num_total else float("nan")
        return self.name, value


class TopKAccuracy:
    """Streaming top-k accuracy over (N, C) scores."""

    def __init__(self, top_k: int = 5, name: str | None = None):
        self.top_k = top_k
        self.name = name or f"top_{top_k}_accuracy"
        self.reset()

    def reset(self):
        self.num_correct = 0
        self.num_total = 0

    def update(self, labels, preds):
        labels = np.asarray(labels).reshape(-1).astype(np.int64)
        preds = np.asarray(preds).reshape(len(labels), -1)
        k = min(self.top_k, preds.shape[-1])
        topk = np.argpartition(preds, -k, axis=-1)[:, -k:]
        self.num_correct += int((topk == labels[:, None]).any(axis=-1).sum())
        self.num_total += len(labels)

    def get(self):
        value = self.num_correct / self.num_total if self.num_total else float("nan")
        return self.name, value
