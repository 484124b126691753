"""Operation and byte counts of the benchmarked model families.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference (``port_bench/reference``) on meta tensors, so the count
depends on the model's shapes and not on what computes each layer: every
convolution and product of the forward; for a train step also the input
and weight gradients (the first convolution's input takes none), no
recomputation.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

STATISTICS = ("bn_mean", "bn_var")  # buffers, not trained


def input_shape(cfg: dict, batch: int) -> tuple:
    s = cfg["data_shape"]
    window = cfg.get("window", 1)
    return (batch, s, s, 3) if window == 1 else (batch, window, s, s, 3)


def counted(ref, cfg: dict, batch: int, train: bool) -> int:
    """FLOPs of one forward (``train`` False) or one train step of the
    reference ``ref`` at ``batch``."""
    dev = torch.device("meta")
    params = {n: torch.empty(shape, device=dev,
                             requires_grad=train and kind not in STATISTICS)
              for n, (shape, kind) in ref.param_shapes(cfg).items()}
    x = torch.empty(input_shape(cfg, batch), device=dev)
    with FlopCounterMode(display=False) as count:
        if train:
            y = ref.logits(params, x, cfg, train=True)
            loss = torch.nn.functional.cross_entropy(
                y, torch.zeros(batch, dtype=torch.long, device=dev))
            torch.autograd.grad(loss, [p for p in params.values()
                                       if p.requires_grad])
        else:
            with torch.no_grad():
                ref.features(params, x, cfg)
    return count.get_total_flops()


def bound_s(flops: float, nbytes: float, peaks: dict, ops: str = "bf16_flops"):
    """(least seconds, what bounds it): operations at the peak rate ``ops``
    or bytes at the memory's peak, whichever takes longer."""
    t_ops, t_bytes = flops / peaks[ops], nbytes / peaks["bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
