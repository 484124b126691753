"""The benchmark's machinery: finding a cell's files by name, making its
weights and inputs from the seed, timing the window, reading the trace,
holding the outputs against the reference, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything of
one configuration, traffic mix, driver kind or per-layer metric sits in a
file of its own, found by name:

- ``configs/<config>.json``: the model, its widths, dtype and source;
- ``traffic/<traffic>.json``: the mix; its ``kind`` names the driver,
  its ``rate`` (where given) the end-to-end metric that the window's
  samples a second are reported as;
- ``kinds/<kind>.py``: drives one kind of entry point of the program;
- ``metrics/<metric>.py``: ``read(record)`` of one per-layer metric;
- ``reference/<family>.py`` and ``flops/<family>.py``: the plain reference
  and the counts of the configuration's ``family``;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tennis_tpu")
GIB = 1 << 30


# ----------------------------------------------------------------- finding


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_file(roots, folder: str, name: str, ext: str) -> str:
    """``<root>/<folder>/<name><ext>`` in the first of ``roots`` that has
    it."""
    for root in roots:
        path = os.path.join(root, folder, f"{name}{ext}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {folder}/{name}{ext} under {list(roots)}")


def load_module(folder: str, name: str, roots=(HERE,)):
    """The module ``<folder>/<name>.py`` (a metric's name may hold dots, so
    a module is loaded from its path)."""
    path = find_file(roots, folder, name, ".py")
    if os.path.dirname(os.path.dirname(path)) == HERE and "." not in name:
        return importlib.import_module(f"port_bench.{folder}.{name}")
    key = f"port_bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell and what its name leads to."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    bench: dict
    roots: tuple = (HERE,)

    @property
    def chips(self) -> int:
        return self.entry["chips"]

    def kind(self):
        return load_module("kinds", self.traffic["kind"], self.roots)

    def reference(self):
        return load_module("reference", self.config["family"], self.roots)

    def counts(self):
        return load_module("flops", self.config["family"], self.roots)

    def metric(self, name: str):
        return load_module("metrics", name, self.roots)

    @property
    def rate(self) -> str:
        """The end-to-end metric the window's samples over its seconds
        are reported as: the traffic's ``rate``, else its kind's."""
        return self.traffic.get("rate", self.kind().RATE)

    def limits(self) -> dict:
        return read_json(find_file(self.roots, "limits", self.name,
                                   ".json"))["limits"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in moved]


def find_cell(bench: dict, name: str, roots=(HERE,)) -> Cell:
    """The cell ``name`` of ``bench``; its files are looked up in
    ``roots`` in order (the benchmark's folder last)."""
    roots = tuple(roots) if HERE in roots else tuple(roots) + (HERE,)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[name]
    config = read_json(find_file(roots, "configs", entry["config"], ".json"))
    traffic = read_json(find_file(roots, "traffic", entry["traffic"],
                                  ".json"))
    return Cell(name, entry, config, traffic, bench, roots)


def forbidden_loaded() -> list:
    """Top-level names of the JAX stack or the JAX package in
    ``sys.modules``, compared whole (``tennis_torch`` is not
    ``tennis_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------- spans


class Spans:
    """Host seconds by span name, summed; in a traced segment each span is
    also a ``record_function`` range, so the trace can name what the host
    did while the device sat idle."""

    NAMES = ("loader_wait", "step_enqueue", "copy_back", "synchronize")

    def __init__(self):
        self.seconds: dict = {}
        self.trace = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import record_function
            rf = record_function(name)
        tic = time.perf_counter()
        with rf:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            time.perf_counter() - tic


# ---------------------------------------------------------------- the run


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream (weights, frames, labels) of ``seed``."""
    import numpy as np
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Run:
    """What one run of a cell holds: its cell, seed and device, the
    weights the benchmark made (host copies once the program has them),
    the kind's own state, spans and counters."""
    cell: Cell
    seed: int
    device: object
    spans: Spans = dataclasses.field(default_factory=Spans)
    weights: dict | None = None
    state: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note the host time at which a part of set-up ended."""
        self.marks.append((name, time.perf_counter()))

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def generator(self, stream: int):
        import torch
        return torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, stream))

    def make_weights(self) -> dict:
        """Every parameter and BN statistic of the reference's list, made on
        the device from the seed in one draw: convolutions N(0, 2/fan_in),
        linear layers N(0, 1/fan_in), BN scale 1 + N(0, 0.01), shift and
        running mean N(0, 0.01), running variance exp(N(0, 0.04)), biases
        N(0, 1e-4)."""
        import torch
        shapes = self.cell.reference().param_shapes(self.cfg)
        total = sum(math.prod(s) for s, _ in shapes.values())
        flat = torch.randn(total, generator=self.generator(1),
                           device=self.device)
        out, at = {}, 0
        for name, (shape, kind) in shapes.items():
            n = math.prod(shape)
            v = flat[at:at + n].view(shape)
            at += n
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
            if kind == "conv":
                v = v * math.sqrt(2.0 / fan_in)
            elif kind == "linear":
                v = v * math.sqrt(1.0 / fan_in)
            elif kind == "bn_weight":
                v = 1.0 + 0.1 * v
            elif kind in ("bn_bias", "bn_mean"):
                v = 0.1 * v
            elif kind == "bn_var":
                v = torch.exp(0.2 * v)
            elif kind == "bias":
                v = 0.01 * v
            else:
                raise ValueError(f"unknown parameter kind {kind!r}")
            out[name] = v.contiguous()
        return out

    def pool(self, n: int):
        """``n`` seeded uint8 samples (frames or clips) on the host, made on
        the device, and ``n`` labels. The traffic's ``content``: ``noise``,
        every byte uniform (a network's features hardly tell such frames
        apart), or ``smooth``, a random colour field of ``GRID`` x ``GRID``
        cells a frame, bilinear to full size, with uniform noise of a tenth
        of the range on top (features a tenth apart from frame to
        frame)."""
        import torch
        s, window = self.cfg["data_shape"], self.cfg.get("window", 1)
        shape = (n, s, s, 3) if window == 1 else (n, window, s, s, 3)
        gen = self.generator(2)
        content = self.traffic.get("content", "noise")
        if content == "noise":
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              generator=gen, device=self.device)
        elif content == "smooth":
            x = smooth_frames(n * (window if window > 1 else 1), s, gen,
                              self.device).reshape(shape)
        else:
            raise ValueError(f"unknown content {content!r}")
        y = torch.randint(0, self.cfg["num_classes"], (n,),
                          generator=self.generator(3), device=self.device)
        return x.cpu().numpy(), y.cpu().numpy()


GRID = 4


def smooth_frames(n: int, side: int, gen, device):
    """``n`` uint8 (side, side, 3) frames: see :meth:`Run.pool`."""
    import torch
    import torch.nn.functional as F
    low = torch.rand(n, 3, GRID, GRID, generator=gen, device=device)
    x = F.interpolate(low, size=(side, side), mode="bilinear",
                      align_corners=False)
    x += 0.1 * (torch.rand(x.shape, generator=gen, device=device) - 0.5)
    x = (x.clamp_(0, 1) * 255).round_().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous()


def build_program_model(run: Run, builder):
    """The program's model built by ``builder()`` on the meta device (no
    host initialisation), moved to the run's device and loaded with the
    benchmark's weights; the benchmark keeps host copies of them. The
    truncated-normal initialiser is skipped while it builds: the values are
    replaced, and on meta tensors its clamp runs through torch's Python
    decompositions, whose first use took ~10 s of set-up on the card's
    host."""
    import torch
    with torch.device("meta"), patched(torch.nn.init, "trunc_normal_",
                                       lambda t, *a, **k: t):
        model = builder()
    run.mark("build")
    model = model.to_empty(device=run.device)
    weights = run.make_weights()
    run.mark("weights")
    model.load_state_dict(weights, strict=True)
    if run.cfg["dtype"] == "float64":  # the parameters too
        model.double()
    run.weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    run.mark("load")
    return model


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name`` set to ``value`` while the context is open."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def start_peak(run: Run) -> None:
    """Free what the benchmark made on the device and start the peak
    reading: from here on it counts the program's memory."""
    import gc

    import torch
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def dtype_of(cfg: dict):
    """The dtype the configuration states the program computes in."""
    import torch
    return getattr(torch, cfg["dtype"])


def reference_weights(run: Run, trained: bool = False) -> dict:
    """The benchmark's weights on the device, in f32 (in f64 where the
    configuration states f64, as a test at a small size may); with
    ``trained`` the parameters (not the BN statistics) take gradients."""
    import torch
    dt = torch.float64 if run.cfg["dtype"] == "float64" else torch.float32
    shapes = run.cell.reference().param_shapes(run.cfg)
    out = {}
    for name, w in run.weights.items():
        t = w.to(run.device, dt, copy=True)
        if trained and shapes[name][1] not in ("bn_mean", "bn_var"):
            t.requires_grad_(True)
        out[name] = t
    return out


def free_device(run: Run) -> None:
    import gc

    import torch
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- readings


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|, infinite where a is not finite."""
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def row_gap(got, want) -> float:
    """The widest relative L2 gap of a row, |got - want| / |want|, of two
    (rows, values) tensors; infinite where ``got`` is not finite."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not got.isfinite().all():
        return math.inf
    num = (got - want).norm(dim=1)
    return float((num / want.norm(dim=1).clamp_min(1e-30)).max())


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of that leaf's reference norm and the median leaf's (some
    gradients are all but zero); ``keep`` limits the leaves. A leaf the
    program lacks, or reads as not finite, has an infinite gap."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    gaps = []
    for n in names:
        p = prog.get(n, math.nan)
        gaps.append(abs(p - ref[n]) / max(ref[n], median, 1e-30)
                    if math.isfinite(p) else math.inf)
    return gaps


def median_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The median of :func:`leaf_gaps`."""
    if keep is not None and not keep:
        return math.inf
    return statistics.median(leaf_gaps(prog, ref, keep))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) over the numbers ``limits``
    names: each there, finite and at most its limit. A number the kind
    reads that has no limit is not compared (its readings gave no limit;
    ``PERF.md`` names them)."""
    checks, ok = {}, True
    for name, entry in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": entry["limit"]}
        if value is None or not math.isfinite(value) or \
                value > entry["limit"]:
            ok = False
    return ok, checks


# ------------------------------------------------------------------ device


def device_info(chips: int, device) -> dict:
    """The result's ``device``, with this process's peak on ``device``."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str | None:
    """The card's name and power limit from nvidia-smi, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def peaks_of(kind: str) -> dict | None:
    return read_json(os.path.join(HERE, "peaks.json"))["cards"].get(kind)


# ------------------------------------------------------------------ window


def measure(run: Run, kind, seconds: float) -> dict:
    """Units (batches or steps) back to back for ``seconds`` of host time,
    then the kind's drain (a synchronize): the window is all of it."""
    tic = time.perf_counter()
    n = 0
    while True:
        kind.unit(run)
        n += 1
        if time.perf_counter() - tic >= seconds:
            break
    kind.drain(run)
    return {"seconds": time.perf_counter() - tic, "units": n,
            "samples": n * run.traffic["batch"],
            "spans": dict(run.spans.seconds)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None, t0: float | None = None) -> tuple:
    """One run of ``cell``: set-up, the window, the traced segment (with
    ``trace``), the reference check. Returns ``(result, checks)``; the
    result lacks nothing the last line needs. ``device`` defaults to the
    card (a test may pass the CPU)."""
    import torch

    from port_bench import trace as tracing

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device("cuda" if device is None else device)
    kind = cell.kind()
    run = Run(cell, seed, device)
    run.mark("imports")
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        run.mark("cuda")
    kind.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.mark("warm")
    setup_s = time.perf_counter() - t0
    at = t0
    parts = []
    for name, t in run.marks:
        parts.append(f"{name} {t - at:.3f} s")
        at = t
    print("set-up: " + ", ".join(parts), file=sys.stderr)
    run.spans.seconds.clear()
    window = measure(run, kind, seconds)
    record = {"cell": cell.name, "config": cell.config,
              "traffic": cell.traffic, "window": window,
              "counters": run.counters, "chips": cell.chips}
    seg = None
    if trace:
        seg = tracing.segment(run, kind, device)
        record["trace"] = seg
    card = device.type == "cuda"
    info = device_info(cell.chips, device) if card else {
        "platform": "cpu", "kind": "cpu", "count": cell.chips,
        "memory_peak_bytes": 0}
    record["peaks"] = peaks_of(info["kind"]) if card else None
    record["flops_per_unit"] = kind.flops_per_unit(run)
    kind.release(run)
    free_device(run)
    numbers = kind.check(run)
    correct, checks = judge(numbers, cell.limits())
    metrics = {}
    if not trace:
        values = {cell.rate: window["samples"] / window["seconds"],
                  "peak_mem_gib": info["memory_peak_bytes"] / GIB,
                  "setup_s": setup_s}
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            value = cell.metric(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": window["units"],
              "failed": run.counters.get("failed", 0), "metrics": metrics,
              "device": info}
    if trace and seg is not None:
        result["device"]["busy_s"] = seg["busy_s"]
        result["device"]["window_s"] = seg["window_s"]
        result["breakdown"] = seg["breakdown"]
    if result["failed"]:
        result["correct"] = False
    return result, checks


def main(workload: str, seed: int, seconds: float, trace: bool,
         t0: float) -> int:
    """The command's body: 0 with the result as the last line of standard
    output; another code, and no result, where the card is missing, the
    program or the benchmark's files are not all there, or the JAX stack
    was loaded."""
    root = os.path.dirname(HERE)
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cell = find_cell(bench, workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result, checks = run_cell(cell, seed, seconds, trace, t0=t0)
    loaded = forbidden_loaded()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark drives tennis_torch "
              f"alone", file=sys.stderr)
        return 4
    print(f"card: {power_limit()}", file=sys.stderr)
    print(report(result, checks), flush=True)
    return 0


def report(result: dict, checks: dict) -> str:
    """The result's line, with ``checks`` (each number compared beside
    its limit) as its last key; the same numbers go to standard error
    as its last lines."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(dict(result, checks=checks))
