"""The traced segment of a ``--trace 1`` run: a fixed number of the cell's
units (batches or steps) after the window, under ``torch.profiler``, reduced
to what the per-layer readers and the ``breakdown`` need.

The segment runs twice. First with the device's activity alone: its
kernels, the device's busy seconds and the host's seconds for the units
(``window_s``), with the profiler's cost on the host kept to its CUPTI
records. Then with the host's activity too, and the benchmark's spans as
ranges: the host's time in the program's ops, and what the host was doing
in each idle gap. Host profiling costs a few microseconds an op, which
would widen the idle share of a launch-bound step, so the idle share and
the kernel times are read from the first.

The profiler now and then drops a session's device records: a segment
with none is taken again, up to ``ATTEMPTS`` times. Where every attempt
was dropped, the device segment is timed by CUDA events instead (the
stream spins while the host queues the units, so the events bracket the
device's work): that gives ``busy_s`` and nothing by kernel name, and the
readers that need names find nothing to read.
"""
from __future__ import annotations

import time

ATTEMPTS = 4
WINDOW = "port_bench.traced_window"
# SM clock cycles the stream spins (~20 ms on an H100) while the host
# queues the units that the CUDA events time
QUEUE_AHEAD_CYCLES = 40_000_000
TOP = 10
NAME_CHARS = 160


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_events(events, skip=()) -> list:
    """(name, start us, end us) of the device's records, the benchmark's
    own ranges (``skip``) left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA and e.name not in skip]


def busy(device) -> list:
    """The device's busy intervals, merged."""
    return _merge([(s, e) for _, s, e in device])


def by_name(device) -> dict:
    kernels: dict = {}
    for name, s, e in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    return kernels


def reduce_host(events, span_names) -> dict | None:
    """Host op seconds and calls by name, and the idle gaps of the
    device's timeline named by the span the host was in, from a segment
    traced with the host's activity; None where it lacks its window or
    any device record."""
    from torch.autograd import DeviceType

    window, spans, host_ops = None, [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name == WINDOW:
            window = (start, end)
        elif e.name in span_names:
            spans.append((start, end, e.name))
        agg = host_ops.setdefault(e.name, [0.0, 0])
        agg[0] += (end - start) / 1e6
        agg[1] += 1
    device = device_events(events, set(span_names) | {WINDOW})
    if window is None or not device:
        return None
    w0, w1 = window
    gaps, at = [], w0
    for s, e in busy(device) + [[w1, w1]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    spans.sort()

    def doing(t):
        name = "other"
        for s, e, n in spans:
            if s > t:
                break
            if e > t:
                name = n  # the innermost span open at t
        return name

    named = sorted(((doing(s), (e - s) / 1e6) for s, e in gaps),
                   key=lambda g: -g[1])
    return {"host_ops": host_ops, "idle_gaps": [[n, s] for n, s in
                                                named[:TOP]]}


def _device_segment(run, kind, n: int) -> dict | None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(n):
            kind.unit(run)
        kind.drain(run)
        window_s = time.perf_counter() - tic
    device = device_events(prof.events())
    if not device:
        return None
    kernels = by_name(device)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"window_s": window_s,
            "busy_s": sum(e - s for s, e in busy(device)) / 1e6,
            "kernels": kernels, "dropped": False,
            "device_ops": [[k[:NAME_CHARS], v[0]] for k, v in top]}


def _host_segment(run, kind, n: int) -> dict | None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    run.spans.trace = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(n):
                    kind.unit(run)
                kind.drain(run)
        torch.cuda.synchronize()
    finally:
        run.spans.trace = False
    return reduce_host(prof.events(), set(run.spans.NAMES))


def _by_events(run, kind, n: int) -> dict:
    """The segment timed by CUDA events: device seconds of ``n`` units
    queued behind a spin, and the host window of ``n`` more. The two are
    not the same units: where the device seconds exceed the window, the
    readers find no idle share (``_read.idle_pct``)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(n):
        kind.unit(run)
    end.record()
    kind.drain(run)
    end.synchronize()
    busy_s = start.elapsed_time(end) / 1e3
    tic = time.perf_counter()
    for _ in range(n):
        kind.unit(run)
    kind.drain(run)
    window_s = time.perf_counter() - tic
    return {"window_s": window_s, "busy_s": busy_s,
            "kernels": {}, "dropped": True, "device_ops": []}


def _attempts(fn):
    for attempt in range(ATTEMPTS):
        out = fn()
        if out is not None:
            return out, attempt + 1
        time.sleep(0.5)
    return None, ATTEMPTS


def segment(run, kind, device) -> dict:
    """The record of ``traffic["traced_units"]`` units, traced."""
    n = run.traffic["traced_units"]
    if device.type != "cuda":  # a CPU test: nothing to trace
        seg, tries = {"window_s": 0.0, "busy_s": 0.0, "kernels": {},
                      "dropped": True, "device_ops": []}, 0
        host = None
    else:
        seg, tries = _attempts(lambda: _device_segment(run, kind, n))
        if seg is None:
            seg = _by_events(run, kind, n)
        host, _ = _attempts(lambda: _host_segment(run, kind, n))
    seg.update(attempts=tries, units=n, samples=n * run.traffic["batch"],
               host_ops=host["host_ops"] if host else {},
               breakdown={"device_ops": seg.pop("device_ops"),
                          "idle_gaps": host["idle_gaps"] if host else []})
    return seg
