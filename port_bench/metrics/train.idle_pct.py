"""Share of the traced training segment in which no operation ran on the
device."""
from port_bench.metrics import _read


def read(record):
    return _read.idle_pct(record)
