"""TenniSet class list (counterpart of ``tennis_tpu/data/tennis_set.py``;
only the class list is ported yet)."""
from __future__ import annotations

import os

DEFAULT_CLASSES = [
    "OTH", "SFI", "SFF", "SFL", "SNI", "SNF", "SNL", "HFL", "HFR", "HNL", "HNR",
]


def load_classes(root: str = "data") -> list[str]:
    """Class list from ``<root>/classes.names``, falling back to the canonical
    11 TenniSet classes when the file is absent."""
    names_file = os.path.join(root, "classes.names")
    if os.path.exists(names_file):
        with open(names_file, "r") as f:
            return [line.strip() for line in f if line.strip()]
    return list(DEFAULT_CLASSES)
