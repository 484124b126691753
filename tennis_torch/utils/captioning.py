"""Caption IO helpers (a copy of ``tennis_tpu/utils/captioning.py``).

The bucketed loaders live in tennis_torch.data.bucketing; this module keeps the
text-file and comparison-string helpers with the reference's exact formats.
"""
from __future__ import annotations

import io


def write_sentences(sentences, file_path: str) -> None:
    with io.open(file_path, "w", encoding="utf-8") as f:
        for sent in sentences:
            if isinstance(sent, (list, tuple)):
                f.write(" ".join(sent) + "\n")
            else:
                f.write(str(sent) + "\n")


def read_sentences(file_path: str):
    """Token lists per line (the reference left this as a stub,
    utils/captioning.py:98-99)."""
    with io.open(file_path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n").split() for line in f]


def get_comp_str(tgts, prds) -> str:
    """GT-vs-prediction comparison block (reference utils/captioning.py:102-119),
    used for the TensorBoard caption panels."""
    out = ""
    for tgt, prd in zip(tgts, prds):
        out += "GT:\t"
        out += (" ".join(tgt) if isinstance(tgt, (list, tuple)) else str(tgt))
        out += "\n\nPD:\t"
        out += (" ".join(prd) if isinstance(prd, (list, tuple)) else str(prd))
        out += "\n\n\n"
    return out
