"""The program's own spans (``tennis_torch.utils.tracing``) read against
the card, for one cell: a diagnostic beside the benchmark, which no cell
runs.

    python3 port_bench/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--pairs <k>]

from the root of a checkout, on the card. After the cell's set-up (its
kind, weights and inputs from the seed, as ``run.py`` makes them):

1. ``windows``: ``2 k`` windows of ``--seconds`` each, the program's
   tracing off and on in turns (off, on, on, off, ...), on the same state
   and inputs: the rate of each, and so what tracing costs when on;
2. ``span_ns``: the host cost of one ``span()`` when off and when on (no
   profiler), each over an empty loop's;
3. the cell's ``traced_units`` units under ``torch.profiler`` with
   tracing on: ``program.device``, ``[device s, launches]`` of the
   kernels by the innermost program span open on their launching thread
   (a kernel is linked to the op that launched it by the profiler's
   correlation id; ``other`` where no span was open), and
   ``program.idle_gaps``, the device's idle gaps named by the innermost
   program span the window's thread was in, beside ``bench_idle_gaps``,
   the same gaps named by the benchmark's spans, and ``program.syncs``,
   ``[host s, calls]`` of the host's waits on the device
   (``cuda*Synchronize``) by the span they were made in;
4. as many units with tracing on and no profiler: ``program.host``, the
   program's ``snapshot()``, host time without the profiler's cost;
5. ``host_small``: the same units at batch ``SMALL_BATCH`` (set up anew),
   where the device's work is far shorter than the host's launches, so
   that no span waits for room in the launch queue.

The last line of standard output is one JSON object with these and
``values``, the per-layer numbers the spans give (``<cell's prefix>.``
``bn_ms_per_step``, ``bn_host_ms_per_step``, ``prepare_ms_per_batch``,
``dense_layer_route_us``, where the cell has the span).
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness, trace  # noqa: E402

PREFIX = "tennis_torch/"  # the program's ranges: tennis_torch/<span>
WINDOW = "port_bench.program_window"
SYNC = "Synchronize"  # cuda{Stream,Event,Device}Synchronize: the host waits
ATTEMPTS = 4
SMALL_BATCH = 2
TOP = 10
# the rate metric of a cell -> the prefix of its per-layer metrics
METRIC_PREFIX = {"train_samples_per_s": "train",
                 "clip_train_samples_per_s": "clip_train",
                 "eval_frames_per_s": "extract"}


class Event(NamedTuple):
    """One profiler record: a host range or op (``device`` false) or a
    device record; times in ns; ``correlation`` the record's id,
    ``link`` the id of the host op a device record was launched from (0
    for a host op)."""
    name: str
    device: bool
    thread: int
    start: int
    end: int
    correlation: int
    link: int


def profiler_events(prof) -> list:
    """The raw records of a finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() == DeviceType.CUDA,
                  e.start_thread_id(), e.start_ns(), e.end_ns(),
                  e.correlation_id(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


class _Innermost:
    """The innermost of a thread's nested ranges open at a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)  # (start, end, name)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            s, e, name = self.ranges[i]
            if e > t:
                return name
        return None


def reduce_program(events, bench_names=()) -> dict | None:
    """``{"device", "syncs", "idle_gaps", "bench_idle_gaps"}`` of a
    session traced with tracing on (see the module's docstring); None
    where it lacks the window or any device record."""
    ranges: dict = {}
    bench: dict = {}
    ops: dict = {}
    window = None
    for e in events:
        if e.device:
            continue
        if e.name == WINDOW:
            window = e
        elif e.name.startswith(PREFIX):
            ranges.setdefault(e.thread, []).append(
                (e.start, e.end, e.name[len(PREFIX):]))
        elif e.name in bench_names:
            bench.setdefault(e.thread, []).append((e.start, e.end, e.name))
        if e.link == 0:
            ops[e.correlation] = e
    skip = set(bench_names) | {WINDOW}
    kernels = [e for e in events if e.device and e.name not in skip
               and not e.name.startswith(PREFIX)]
    if window is None or not kernels:
        return None
    inner = {t: _Innermost(r) for t, r in ranges.items()}

    def launched_in(e):
        op = ops.get(e.link)
        if op is not None and op.thread in inner:
            return inner[op.thread].at(op.start) or "other"
        return "other"

    device: dict = {}
    syncs: dict = {}
    for by, records in ((device, kernels), (syncs, [
            e for e in events if not e.device and e.link
            and SYNC in e.name])):
        for e in records:
            agg = by.setdefault(launched_in(e), [0.0, 0])
            agg[0] += (e.end - e.start) / 1e9
            agg[1] += 1
    busy = trace.busy([(k.name, k.start, k.end) for k in kernels])
    gaps, at = [], window.start
    for s, e in busy + [[window.end, window.end]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    main = inner.get(window.thread, _Innermost([]))
    main_bench = _Innermost(bench.get(window.thread, []))

    def named(by):
        out = sorted(((by.at(s) or "other", (e - s) / 1e9) for s, e in gaps),
                     key=lambda g: -g[1])
        return [[n, s] for n, s in out[:TOP]]

    return {"device": device, "syncs": syncs, "idle_gaps": named(main),
            "bench_idle_gaps": named(main_bench)}


def values(program: dict, units: int, prefix: str) -> dict:
    """The per-layer numbers of ``program`` (``device`` and ``host``) over
    ``units`` traced units, each where its span is there."""
    device = program.get("device") or {}
    host = (program.get("host") or {}).get("spans", {})
    out = {}
    bn = ("bn_forward", "bn_backward")
    if all(n in device for n in bn):
        out["bn_ms_per_step"] = 1e3 * sum(device[n][0] for n in bn) / units
    if all(n in host for n in bn):
        out["bn_host_ms_per_step"] = 1e3 * sum(
            host[n]["self_s"] for n in bn) / units
    if "prepare" in device:
        out["prepare_ms_per_batch"] = 1e3 * device["prepare"][0] / units
    if host.get("dense_layer", {}).get("calls"):
        d = host["dense_layer"]
        out["dense_layer_route_us"] = 1e6 * d["total_s"] / d["calls"]
    return {f"{prefix}.{k}": v for k, v in out.items()}


def span_ns(calls: int = 200_000) -> dict:
    """Host ns of one ``span()`` with its block, off and on (no profiler),
    each less an empty loop's ns a pass."""
    from tennis_torch.utils import tracing

    def per_call(fn):
        tic = time.perf_counter_ns()
        fn()
        return (time.perf_counter_ns() - tic) / calls

    def empty():
        for _ in range(calls):
            pass

    def spans():
        for _ in range(calls):
            with tracing.span("x"):
                pass

    was = tracing.enabled(False)
    try:
        base = per_call(empty)
        off = per_call(spans) - base
        tracing.enabled(True)
        on = per_call(spans) - base
    finally:
        tracing.enabled(was)
        tracing.reset()
    return {"off": off, "on": on}


def _units(run, kind, n: int) -> None:
    for _ in range(n):
        kind.unit(run)
    kind.drain(run)


def _profiled(run, kind, n: int) -> dict | None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tennis_torch.utils import tracing

    was = tracing.enabled(True)
    run.spans.trace = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                _units(run, kind, n)
        torch.cuda.synchronize()
    finally:
        run.spans.trace = False
        tracing.enabled(was)
    return reduce_program(profiler_events(prof), set(run.spans.NAMES))


def _host(run, kind, n: int) -> dict:
    """The program's snapshot of ``n`` units with tracing on, no
    profiler."""
    from tennis_torch.utils import tracing

    tracing.reset()
    tracing.enabled(True)
    try:
        _units(run, kind, n)
    finally:
        tracing.enabled(False)
    snap = tracing.snapshot()
    tracing.reset()
    return snap


def _set_up(cell, seed: int):
    import torch

    kind = cell.kind()
    run = harness.Run(cell, seed, torch.device("cuda"))
    kind.setup(run)
    torch.cuda.synchronize()
    return run, kind


def diagnose(cell, seed: int, seconds: float, pairs: int) -> dict:
    import torch

    from tennis_torch.utils import tracing

    torch.cuda.init()
    run, kind = _set_up(cell, seed)
    windows = []
    for on in ([False, True, True, False] * pairs)[:2 * pairs]:
        tracing.reset()
        tracing.enabled(on)
        try:
            w = harness.measure(run, kind, seconds)
        finally:
            tracing.enabled(False)
        windows.append({"tracing": on, "units": w["units"],
                        "seconds": w["seconds"],
                        "rate": w["samples"] / w["seconds"]})
    n = run.traffic["traced_units"]
    program = None
    for _ in range(ATTEMPTS):
        program = _profiled(run, kind, n)
        if program is not None:
            break
    program = program or {}
    program["host"] = _host(run, kind, n)
    kind.release(run)
    harness.free_device(run)
    prefix = METRIC_PREFIX[cell.rate]
    out = {"cell": cell.name, "seed": seed, "card": harness.power_limit(),
           "windows": windows, "span_ns": span_ns(), "units": n,
           "program": program, "values": values(program, n, prefix)}
    small = dataclasses.replace(cell, traffic=dict(
        cell.traffic, batch=SMALL_BATCH, pool=4 * SMALL_BATCH))
    del run
    run, kind = _set_up(small, seed)
    host = _host(run, kind, n)
    kind.release(run)
    out["host_small"] = {"batch": SMALL_BATCH, "host": host,
                         "values": values({"host": host}, n, prefix)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=2)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("program_spans needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, a.workload)
    print(json.dumps(diagnose(cell, a.seed, a.seconds, a.pairs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
