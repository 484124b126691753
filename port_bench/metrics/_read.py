"""What several per-layer readers share: the parts of a run's record."""
from __future__ import annotations

COPIES = ("Memcpy", "Memset")


def trace(record) -> dict | None:
    """The traced segment, or None where the run was not traced."""
    return record.get("trace")


def kernels(record) -> dict:
    """{name: [device seconds, launches]} of the traced segment's kernels
    (copies and fills left out); empty where the trace was dropped."""
    seg = trace(record)
    if seg is None:
        return {}
    return {n: v for n, v in seg["kernels"].items()
            if not n.startswith(COPIES)}


def loader_wait_pct(record) -> float | None:
    w = record["window"]
    if w["seconds"] <= 0:
        return None
    return 100.0 * w["spans"].get("loader_wait", 0.0) / w["seconds"]


def idle_pct(record) -> float | None:
    """Share of the traced window with nothing on the device; None where
    the busy seconds exceed the window (a segment timed by CUDA events
    reads them over other units than the window)."""
    seg = trace(record)
    if seg is None or not 0 < seg["busy_s"] <= seg["window_s"]:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])


def mfu(record) -> float | None:
    """Model FLOPs of the window's units over the window's seconds at the
    chips' bf16 peak."""
    peaks, w = record.get("peaks"), record["window"]
    if not peaks or w["seconds"] <= 0:
        return None
    flops = record["flops_per_unit"] * w["units"]
    return 100.0 * flops / (w["seconds"] * peaks["bf16_flops"]
                            * record["chips"])


def per_unit_ms(record, match) -> float | None:
    """Device ms a unit in the kernels whose name ``match`` accepts."""
    ks = kernels(record)
    if not ks:
        return None
    s = sum(v[0] for n, v in ks.items() if match(n))
    return 1e3 * s / trace(record)["units"]
