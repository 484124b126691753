"""The reduction of a traced segment: busy time as the union of the
device's records, the benchmark's own ranges left out of it, idle gaps
named by the host span open when the device went idle, and the readers
that find nothing to read return nothing."""
import types

from torch.autograd import DeviceType

from port_bench import trace
from port_bench.metrics import _read


def ev(name, start, end, device=True):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_busy_is_the_union_of_the_device_records():
    device = trace.device_events([ev("k1", 0, 10), ev("k2", 5, 20),
                                  ev("k3", 30, 40),
                                  ev("loader_wait", 0, 100)],
                                 skip={"loader_wait"})
    assert trace.busy(device) == [[0, 20], [30, 40]]
    assert trace.by_name(device)["k1"] == [10 / 1e6, 1]


def test_idle_gaps_are_named_by_the_open_host_span():
    events = [ev(trace.WINDOW, 0, 100, device=False),
              ev("step_enqueue", 0, 50, device=False),
              ev("loader_wait", 50, 90, device=False),
              ev("tennis_torch::dense_layer", 10, 14, device=False),
              ev("kernel", 5, 40), ev("kernel", 70, 95),
              ev("loader_wait", 50, 90)]  # its device-side annotation
    host = trace.reduce_host(events, set(("step_enqueue", "loader_wait")))
    # idle 0-5 and 40-70 inside step_enqueue, 95-100 in no span
    assert host["idle_gaps"] == [["step_enqueue", 30 / 1e6],
                                 ["step_enqueue", 5 / 1e6],
                                 ["other", 5 / 1e6]]
    assert host["host_ops"]["tennis_torch::dense_layer"] == [4 / 1e6, 1]


def test_a_dropped_trace_gives_no_kernel_metric():
    record = {"trace": {"kernels": {}, "units": 2, "window_s": 1.0,
                        "busy_s": 0.5, "host_ops": {}}}
    assert _read.kernels(record) == {}
    assert _read.per_unit_ms(record, lambda n: True) is None
    assert _read.idle_pct(record) == 50.0


def test_busy_past_the_window_gives_no_idle_share():
    record = {"trace": {"kernels": {}, "units": 2, "window_s": 1.0,
                        "busy_s": 1.2, "host_ops": {}, "dropped": True}}
    assert _read.idle_pct(record) is None
