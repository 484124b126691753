"""Where the pre-resized frames mirror lives (counterpart of the read side
of ``tennis_tpu/data/frame_cache.py``). ``TennisSet(frames_cache=S)`` reads
``<root>/frames_s<S>`` and falls back to the original tree per file; the
CLI that writes the mirror is not ported yet."""
from __future__ import annotations

import os


def cache_dir(root: str, short: int) -> str:
    """``<root>/frames_s<short>``: the cache mirror of ``<root>/frames``."""
    return os.path.join(root, f"frames_s{short}")
