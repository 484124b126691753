"""The port's spans (``tennis_torch.utils.tracing``) on the CPU: spans nest
and a span's self time is its total less its children's; off, ``span``
hands out one shared null context and nothing is kept; each thread has
its own stack (autograd's device thread opens ``bn_backward`` with no
parent); ``snapshot`` carries the counters that live beside the kernels
and ``reset`` clears them; a small DenseNet train step records each phase
once and ``bn_forward`` and ``bn_backward`` once per BN module; under a
CPU ``torch.profiler`` session the spans are ranges ``tennis_torch/<name>``
among the profiler's events, around the ops they enclose; and with
tracing off (or on, with no profiler) ``torch.export`` gives the graph it
gave before the spans were there."""
import contextlib
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel
from tennis_torch.models.backbones.densenet import BatchNorm
from tennis_torch.ops import dense_block, gru
from tennis_torch.parallel import distributed
from tennis_torch.parallel import train_step as ts
from tennis_torch.utils import tracing

BLOCKS, SIDE, BATCH, CLASSES = (1, 1), 32, 4, 5
PHASES = ("train_step", "augment", "forward", "loss", "backward",
          "grad_all_reduce", "update")


@pytest.fixture(autouse=True)
def _tracing_off_and_empty():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    tracing.enabled(False)
    tracing.reset()
    torch.set_num_threads(threads)


def _kept(name):
    return [s for s in tracing._kept if s.name == name]


def test_spans_nest_and_self_time_is_total_less_children():
    tracing.enabled(True)
    with tracing.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with tracing.span("inner"):
                time.sleep(0.003)
    snap = tracing.snapshot()["spans"]
    (outer,) = _kept("outer")
    inner = _kept("inner")
    assert [s.parent for s in inner] == [outer, outer]
    assert outer.parent is None
    assert snap["outer"]["calls"] == 1 and snap["inner"]["calls"] == 2
    covered = sum(s.end - s.start for s in inner)
    assert outer.child_ns == covered
    assert snap["outer"]["self_s"] == pytest.approx(
        snap["outer"]["total_s"] - covered / 1e9, abs=1e-9)
    assert snap["inner"]["self_s"] == snap["inner"]["total_s"]
    assert snap["outer"]["self_s"] >= 0.002 and covered >= 6e6


def test_off_span_is_the_one_shared_null_and_keeps_nothing():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        tracing.count("n", 3)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counts"] == {}
    assert tracing.enabled(True) is False
    assert tracing.span("a") is not tracing.span("a")
    assert tracing.enabled(False) is True


def test_each_thread_has_its_own_stack():
    """A span opened on another thread while this thread's span is open
    has no parent: how ``bn_backward`` looks on autograd's device
    thread, with ``backward`` open on the caller's."""
    tracing.enabled(True)
    opened, release = threading.Event(), threading.Event()

    def device_thread():
        with tracing.span("bn_backward"):
            opened.set()
            release.wait(5)

    with tracing.span("backward"):
        worker = threading.Thread(target=device_thread)
        worker.start()
        assert opened.wait(5)
        with tracing.span("update"):
            release.set()
        worker.join(5)
    assert not worker.is_alive()
    (bn,), (backward,), (update,) = (_kept(n) for n in (
        "bn_backward", "backward", "update"))
    assert bn.parent is None and bn.thread != backward.thread
    assert update.parent is backward
    assert backward.child_ns == update.end - update.start


def test_snapshot_carries_the_counters_and_reset_clears_them():
    tracing.enabled(True)
    tracing.count("steps")
    tracing.count("steps", 2)
    dense_block.dense_layer.variant_launches["persistent"] += 58
    gru.gru_recurrence.variant_launches["async"] += 3
    gru.gru_recurrence.plain_routed += 1
    distributed.model_collectives["sum"] += 2
    snap = tracing.snapshot()
    assert snap["counts"] == {"steps": 3}
    counters = snap["counters"]
    assert counters["dense_layer.variant_launches"]["persistent"] == 58
    assert counters["gru_recurrence.variant_launches"]["async"] == 3
    assert counters["gru_recurrence.plain_routed"] == 1
    assert counters["distributed.model_collectives"] == {"sum": 2}
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["counts"] == {}
    assert not any(snap["counters"]["dense_layer.variant_launches"].values())
    assert not any(
        snap["counters"]["gru_recurrence.variant_launches"].values())
    assert snap["counters"]["gru_recurrence.plain_routed"] == 0
    assert snap["counters"]["distributed.model_collectives"] == {}
    assert set(dense_block.dense_layer.variant_launches) == set(
        dense_block.ROUTES)


def _train_step():
    torch.manual_seed(0)
    spec = DenseNetSpec(BLOCKS)
    model = FrameModel(DenseNet(spec, dtype=torch.float32), CLASSES,
                       dtype=torch.float32, feature_dim=spec.final_channels)
    tx, _ = ts.sgd_with_schedule(0.01, 0.9, 1e-4, [], 0.75, 1)
    state = ts.create_train_state(model, tx)
    step = ts.make_train_step(state, lambda x, generator: x.float() / 255)
    images = torch.randint(0, 256, (BATCH, SIDE, SIDE, 3), dtype=torch.uint8)
    labels = torch.arange(BATCH) % CLASSES
    bns = sum(isinstance(m, BatchNorm) for m in model.modules())
    return step, images, labels, bns


def test_train_step_records_each_phase_once_and_each_bn_both_ways():
    step, images, labels, bns = _train_step()
    step(images, labels)  # off: nothing kept
    assert tracing.snapshot()["spans"] == {}
    tracing.enabled(True)
    step(images, labels)
    spans = tracing.snapshot()["spans"]
    assert {p: spans[p]["calls"] for p in PHASES} == dict.fromkeys(PHASES, 1)
    assert bns == 7
    assert spans["bn_forward"]["calls"] == bns
    assert spans["bn_backward"]["calls"] == bns
    assert set(spans) == set(PHASES) | {"bn_forward", "bn_backward"}
    (root,) = _kept("train_step")
    assert all(_kept(p)[0].parent is root for p in PHASES[1:])
    assert {s.parent.name for s in _kept("bn_forward")} == {"forward"}
    # a CPU backward runs on the calling thread, inside ``backward``
    assert {s.parent.name for s in _kept("bn_backward")} == {"backward"}
    assert spans["train_step"]["self_s"] < spans["train_step"]["total_s"]


def test_ranges_are_on_the_profiler_clock():
    """Each span is a ``tennis_torch/<name>`` range among the profiler's
    events, on the thread and around the ops it encloses; with tracing off
    there is none, and with no profiler running no range is opened."""
    step, images, labels, bns = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(images, labels)
    assert not [e for e in prof.events()
                if e.name.startswith(tracing.PREFIX)]

    tracing.enabled(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(images, labels)
    events = prof.events()
    ranges = [e for e in events if e.name.startswith(tracing.PREFIX)]
    by_name: dict = {}
    for e in ranges:
        by_name.setdefault(e.name[len(tracing.PREFIX):], []).append(e)
    assert {n: len(v) for n, v in by_name.items()} == dict(
        dict.fromkeys(PHASES, 1), bn_forward=bns, bn_backward=bns)
    forward = by_name["forward"][0]
    convs = [e for e in events if e.name == "aten::convolution"
             and e.thread == forward.thread
             and forward.time_range.start <= e.time_range.start
             and e.time_range.end <= forward.time_range.end]
    assert convs  # the forward's convolutions fall inside its range
    for bn in by_name["bn_forward"]:
        assert forward.time_range.start <= bn.time_range.start
        assert bn.time_range.end <= forward.time_range.end

    def no_range(name):
        raise AssertionError(f"a range {name!r} with no profiler running")

    tracing.reset()
    real = tracing._profiler.record_function
    tracing._profiler.record_function = no_range
    try:
        step(images, labels)
    finally:
        tracing._profiler.record_function = real
    assert tracing.snapshot()["spans"]["bn_forward"]["calls"] == bns


def _exported_graph():
    torch.manual_seed(0)
    net = DenseNet(DenseNetSpec(BLOCKS), dtype=torch.float32).eval().fold()

    class Features(torch.nn.Module):
        def forward(self, x):
            return net(x)

    x = torch.zeros((2, SIDE, SIDE, 3))
    with torch.no_grad():
        program = torch.export.export(Features(), (x,))
    return program.graph_module.code


def test_export_graph_with_tracing_off_is_the_graph_before(monkeypatch):
    off = _exported_graph()
    assert "tennis_torch.dense_layer" in off
    assert "record_function" not in off and "profiler" not in off
    tracing.enabled(True)
    on = _exported_graph()
    tracing.enabled(False)
    monkeypatch.setattr(dense_block, "span",
                        lambda name: contextlib.nullcontext())
    before = _exported_graph()
    assert off == before and on == before
