"""Share of the training window the host spent waiting on the prefetch
iterator's next batch (the benchmark's span around next())."""
from port_bench.metrics import _read


def read(record):
    return _read.loader_wait_pct(record)
