"""The dense-layer kernels' share of their roofline in the traced
extraction batches: the least time the card could take for the forward's
dense layers (per layer the larger of its FLOPs at the bf16 peak and its
bytes, each input read once and each output written once, at the
memory's peak) over the kernels' device time a batch. Nothing is read
unless the trace holds every launch (one a dense layer a batch)."""
from port_bench import flops as counts
from port_bench.flops import densenet
from port_bench.metrics import _read

KERNEL = "dense_layer"


def read(record):
    peaks, seg = record.get("peaks"), _read.trace(record)
    ks = _read.kernels(record)
    if not peaks or not ks:
        return None
    hits = {n: v for n, v in ks.items() if KERNEL in n and "f32" not in n}
    work = densenet.dense_layer_work(record["config"],
                                     record["traffic"]["batch"])
    if sum(v[1] for v in hits.values()) != len(work) * seg["units"]:
        return None
    device_s = sum(v[0] for v in hits.values()) / seg["units"]
    least_s = sum(counts.bound_s(f, b, peaks)[0] for f, b in work)
    return 100.0 * least_s / device_s
