"""Model FLOPs of the window's extraction batches (counted over the
reference) over the window at the bf16 peak."""
from port_bench.metrics import _read


def read(record):
    return _read.mfu(record)
