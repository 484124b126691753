"""Counts of R(2+1)D: model FLOPs from the reference."""
from __future__ import annotations

from port_bench import flops as _count
from port_bench.reference import r21d as ref


def forward_flops(cfg: dict, batch: int) -> int:
    return _count.counted(ref, cfg, batch, train=False)


def train_flops(cfg: dict, batch: int) -> int:
    return _count.counted(ref, cfg, batch, train=True)
