"""Device ms a traced step in PyTorch's own at::native kernels:
elementwise, reductions and concatenation copies (the f32 BN passes and
the torch.cat of the dense blocks)."""
from port_bench.metrics import _read


def read(record):
    return _read.per_unit_ms(record, lambda n: "at::native::" in n)
