"""Model FLOPs of the window's clip train steps (counted over the
reference: forward, input and weight gradients) over the window at the
bf16 peak of the chips used."""
from port_bench.metrics import _read


def read(record):
    return _read.mfu(record)
