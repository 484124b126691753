"""Device ms a traced clip train step in PyTorch's own at::native kernels:
elementwise, reductions and copies (the f32 BN passes of the (2+1)D
blocks and the casts)."""
from port_bench.metrics import _read


def read(record):
    return _read.per_unit_ms(record, lambda n: "at::native::" in n)
