"""Host microseconds a call of the op ``tennis_torch::dense_layer`` (route
and launch of one dense layer), from the profiler's host events."""
from port_bench.metrics import _read

OP = "tennis_torch::dense_layer"


def read(record):
    seg = _read.trace(record)
    if seg is None or OP not in seg["host_ops"]:
        return None
    seconds, calls = seg["host_ops"][OP]
    return 1e6 * seconds / calls if calls else None
