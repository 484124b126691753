"""Counts of DenseNet-BC: model FLOPs from the reference, and the work of
each fused dense layer (BN-ReLU-1x1 conv-BN-ReLU-3x3 conv) as a roofline
needs it."""
from __future__ import annotations

from port_bench import flops as _count
from port_bench.reference import densenet as ref


def forward_flops(cfg: dict, batch: int) -> int:
    return _count.counted(ref, cfg, batch, train=False)


def train_flops(cfg: dict, batch: int) -> int:
    return _count.counted(ref, cfg, batch, train=True)


def layer_work(batch, side, c_in, f=128, g=32, elem=2):
    """(FLOP, bytes) one dense layer needs: each input read once, each output
    written once; ``elem`` bytes a state and kernel element (2 bf16, 4 f32)."""
    px = batch * side * side
    flops = 2 * px * (c_in * f + 9 * f * g)
    nbytes = elem * px * (c_in + g) + elem * (f * c_in + 9 * g * f) + \
        4 * (2 * c_in + 2 * f)
    return flops, nbytes


def dense_layer_work(cfg: dict, batch: int, elem: int = 2) -> list:
    """(FLOP, bytes) of every dense layer of one forward at ``batch``."""
    f, g = cfg["bn_size"] * cfg["growth_rate"], cfg["growth_rate"]
    return [layer_work(batch, side, c_in, f, g, elem)
            for _, _, side, c_in in ref.layers(cfg)[0]]
