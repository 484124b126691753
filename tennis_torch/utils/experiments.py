"""Experiment directory convention (counterpart of
``tennis_tpu/utils/experiments.py``): ``models/<kind>/experiments/<model_id>/``
relative to ``base`` (the working directory by default)."""
from __future__ import annotations

import os


def experiment_dir(kind: str, model_id: str, base: str = ".") -> str:
    if kind not in ("vision", "captioning", "embeddings"):
        raise ValueError(f"unknown experiment kind {kind!r}")
    d = os.path.join(base, "models", kind, "experiments", model_id)
    os.makedirs(d, exist_ok=True)
    return d
