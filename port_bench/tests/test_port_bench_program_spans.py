"""The program-span diagnostic's reduction, on synthetic profiler records:
a kernel, or a wait on the device, goes to the innermost program span
open on the thread of the op that made it; the idle gaps are named by the
program span the window's thread was in (and, beside them, by the
benchmark's spans); the per-layer numbers it gives from a fixed record,
and none without one; the benchmark's readers read a record the same with
a ``program`` key in its traced segment; one ``span()`` costs little."""
import copy
import glob
import os

import pytest

from port_bench import harness, program_spans as ps

MAIN, AUTOGRAD = 1, 2


def host(name, start, end, thread=MAIN, corr=0):
    return ps.Event(name, False, thread, start, end, corr, 0)


def kernel(start, end, link, name="k"):
    return ps.Event(name, True, 0, start, end, 0, link)


def span(name, start, end, thread=MAIN):
    return host(ps.PREFIX + name, start, end, thread)


EVENTS = [
    host(ps.WINDOW, 0, 1000),
    host("step_enqueue", 0, 900),
    span("train_step", 0, 900),
    span("forward", 10, 400),
    span("bn_forward", 20, 60),
    span("bn_forward", 100, 140),
    span("backward", 400, 800),
    span("bn_backward", 450, 500, thread=AUTOGRAD),
    host("aten::sum", 25, 30, corr=11),          # in bn_forward
    host("aten::conv", 70, 90, corr=12),         # in forward alone
    host("aten::mul", 460, 470, AUTOGRAD, 13),   # in bn_backward
    host("aten::conv_bw", 600, 620, AUTOGRAD, 14),  # no span on its thread
    host("aten::add", 950, 960, corr=15),        # after the step
    kernel(40, 100, 11), kernel(100, 300, 12), kernel(480, 520, 13),
    kernel(620, 700, 14), kernel(960, 970, 15), kernel(970, 990, 99),
    # the host waiting on the device, from an op of bn_forward
    ps.Event("cudaStreamSynchronize", False, 77, 26, 29, 5, 11),
    # the device side of a program range and of a benchmark span
    ps.Event(ps.PREFIX + "forward", True, 0, 40, 300, 0, 0),
    ps.Event("step_enqueue", True, 0, 40, 990, 0, 0),
]


def test_a_kernel_goes_to_the_innermost_span_on_its_launching_thread():
    program = ps.reduce_program(EVENTS, {"step_enqueue"})
    assert program["device"] == {"bn_forward": [60 / 1e9, 1],
                                 "forward": [200 / 1e9, 1],
                                 "bn_backward": [40 / 1e9, 1],
                                 "other": [110 / 1e9, 3]}
    assert program["syncs"] == {"bn_forward": [3 / 1e9, 1]}


def test_idle_gaps_are_named_by_program_spans():
    program = ps.reduce_program(EVENTS, {"step_enqueue"})
    # idle: 0-40 (train_step), 300-480 (forward: 300-400 is its tail),
    # 520-620 (backward), 700-960 (backward), 990-1000 (none)
    assert program["idle_gaps"] == [
        ["backward", 260 / 1e9], ["forward", 180 / 1e9],
        ["backward", 100 / 1e9], ["train_step", 40 / 1e9],
        ["other", 10 / 1e9]]
    assert [n for n, _ in program["bench_idle_gaps"]] == \
        ["step_enqueue"] * 4 + ["other"]


def test_no_window_or_no_device_record_gives_nothing():
    assert ps.reduce_program([e for e in EVENTS if e.name != ps.WINDOW]) \
        is None
    assert ps.reduce_program([e for e in EVENTS if not e.device]) is None


PROGRAM = {
    "device": {"bn_forward": [0.2, 300], "bn_backward": [0.3, 400],
               "prepare": [0.004, 12], "other": [1.0, 10]},
    "host": {"spans": {
        "bn_forward": {"calls": 242, "total_s": 0.06, "self_s": 0.05},
        "bn_backward": {"calls": 242, "total_s": 0.07, "self_s": 0.07},
        "dense_layer": {"calls": 116, "total_s": 0.0058, "self_s": 0.0058}}},
}


def test_the_values_of_a_fixed_record():
    got = ps.values(PROGRAM, 2, "train")
    assert got == pytest.approx({"train.bn_ms_per_step": 250.0,
                                 "train.bn_host_ms_per_step": 60.0,
                                 "train.prepare_ms_per_batch": 2.0,
                                 "train.dense_layer_route_us": 50.0})
    assert ps.values({}, 2, "extract") == {}
    assert ps.values({"device": {"bn_forward": [0.1, 1]}}, 2, "x") == {}


def test_readers_read_the_same_with_a_program_key(bench):
    """Every per-layer reader of the benchmark gives one value on a traced
    record with and without a ``program`` key in its segment."""
    cell = harness.find_cell(bench, "densenet121-512.extract.b64")
    record = {
        "cell": cell.name, "config": cell.config,
        "traffic": {"batch": 64}, "chips": 1, "counters": {},
        "window": {"seconds": 40.0, "units": 100, "samples": 6400,
                   "spans": {"loader_wait": 0.4}},
        "peaks": harness.peaks_of("NVIDIA H100 80GB HBM3"),
        "flops_per_unit": 5.6e15,
        "trace": {"window_s": 0.8, "busy_s": 0.7, "units": 2,
                  "dropped": False, "host_ops": {
                      "tennis_torch::dense_layer": [0.01, 116]},
                  "kernels": {"void at::native::k": [0.6, 17000],
                              "dense_layer_persistent_kernel": [0.1, 116],
                              "Memcpy HtoD": [0.01, 2]}}}
    with_program = copy.deepcopy(record)
    with_program["trace"]["program"] = copy.deepcopy(PROGRAM)
    names = [os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(harness.HERE, "metrics", "*.py"))
             if not os.path.basename(p).startswith("_")]
    assert len(names) == len(bench["per_layer"])
    for name in names:
        read = harness.load_module("metrics", name).read
        assert read(with_program) == read(record), name


def test_a_span_costs_little_on_the_host():
    cost = ps.span_ns(calls=20_000)
    assert cost["off"] < cost["on"]
    assert cost["off"] < 5_000  # ns: a flag check and a null context
