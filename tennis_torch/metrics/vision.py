"""Per-class precision / recall / F1 from a confusion matrix (counterpart of
``tennis_tpu/metrics/vision.py``, in numpy on the host).

As in the JAX package, precision is TP / predicted positives and recall TP /
actual positives (the reference swaps the two names; F1 and the
model-selection score ``AVG_NB_f1`` are symmetric in them).
"""
from __future__ import annotations

import numpy as np

_EPS = float(np.finfo(np.float64).eps)


def confusion_matrix(labels, preds, num_classes: int) -> np.ndarray:
    """(C, C) float32 counts ``mat[true, pred]``. ``preds`` holds class
    indices shaped like ``labels``, or scores with one trailing class axis
    (argmax taken; ties go to the first index)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    if preds.shape != labels.shape:
        preds = np.argmax(preds, axis=-1)
    flat = (labels.reshape(-1).astype(np.int64) * num_classes
            + preds.reshape(-1).astype(np.int64))
    counts = np.bincount(flat, minlength=num_classes * num_classes)
    return counts.astype(np.float32).reshape(num_classes, num_classes)


def prf1_from_confusion(mat):
    """Per-class (precision, recall, f1) arrays of a (C, C) confusion matrix."""
    mat = np.asarray(mat, dtype=np.float64)
    tp = np.diag(mat)
    actual = mat.sum(axis=1)  # row = true class
    predicted = mat.sum(axis=0)  # col = predicted class
    prec = tp / (predicted + _EPS)
    rec = tp / (actual + _EPS)
    f1 = 2.0 * prec * rec / (prec + rec + _EPS)
    return prec, rec, f1


class PRF1:
    """Streaming per-class P/R/F1 with the reference's ``update/get/reset``
    protocol and score names (``<class>_prec/_rec/_f1``, ``AVG_*``,
    ``AVG_NB_*``); ``AVG_NB_*`` leaves out class 0 (background, 'OTH')."""

    def __init__(self, label_names):
        self.label_names = list(label_names)
        self.num_classes = len(self.label_names)
        self.reset()

    def reset(self):
        self.mat = np.zeros((self.num_classes, self.num_classes),
                            dtype=np.float64)

    def update(self, labels, preds):
        """Accumulate a batch: ``labels`` int (N,), ``preds`` int (N,) or
        scores (N, C)."""
        self.mat += confusion_matrix(labels, preds, self.num_classes)

    def get(self):
        """A list of (name, value) pairs in the reference's order."""
        prec, rec, f1 = prf1_from_confusion(self.mat)
        scores = []
        for i, c in enumerate(self.label_names):
            scores.append((c + "_prec", float(prec[i])))
            scores.append((c + "_rec", float(rec[i])))
            scores.append((c + "_f1", float(f1[i])))
        scores.append(("AVG_prec", float(prec.mean())))
        scores.append(("AVG_rec", float(rec.mean())))
        scores.append(("AVG_f1", float(f1.mean())))
        scores.append(("AVG_NB_prec", float(prec[1:].mean())))
        scores.append(("AVG_NB_rec", float(rec[1:].mean())))
        scores.append(("AVG_NB_f1", float(f1[1:].mean())))
        return scores

    def get_dict(self):
        return dict(self.get())

    def confusion_str(self) -> str:
        """Tab-separated confusion matrix, a header row of class names."""
        lines = ["\t" + "\t".join(self.label_names)]
        for i, c in enumerate(self.label_names):
            lines.append(c + "\t" + "\t".join(str(int(v)) for v in self.mat[i]))
        return "\n".join(lines)
