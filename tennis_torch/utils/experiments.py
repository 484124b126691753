"""Experiment directory and logging conventions (counterpart of
``tennis_tpu/utils/experiments.py``): ``models/<kind>/experiments/<model_id>/``
relative to ``base`` (the working directory by default), holding ``log.txt``
(the file log, starting with the serialized flag set) beside the checkpoints
and ``scores.txt``."""
from __future__ import annotations

import logging
import os


def experiment_dir(kind: str, model_id: str, base: str = ".") -> str:
    if kind not in ("vision", "captioning", "embeddings"):
        raise ValueError(f"unknown experiment kind {kind!r}")
    d = os.path.join(base, "models", kind, "experiments", model_id)
    os.makedirs(d, exist_ok=True)
    return d


# FileHandlers this module installed: a second driver run in one process
# drops only these, so lines stop going to a stale experiment's log.txt
# without touching handlers that other code owns
_own_file_handlers: list[logging.FileHandler] = []


def setup_logging(exp_dir: str, flags_dict: dict | None = None):
    """Root logger at INFO to stderr and ``<exp_dir>/log.txt``; the flags
    are logged first, one ``--name=value`` a line. Calling it again (drivers
    chained in one process) moves the file log to the new ``exp_dir``."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in _own_file_handlers:
        logger.removeHandler(h)
        h.close()
    _own_file_handlers.clear()
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        logger.addHandler(logging.StreamHandler())
    fh = logging.FileHandler(os.path.join(exp_dir, "log.txt"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(fh)
    _own_file_handlers.append(fh)
    if flags_dict:
        logging.info("flags:\n%s", "\n".join(
            f"--{k}={v}" for k, v in sorted(flags_dict.items())))
    return logger


def summary_writer(exp_dir: str):
    """A tensorboardX writer under ``<exp_dir>/tb``, or None without
    tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=os.path.join(exp_dir, "tb"))
