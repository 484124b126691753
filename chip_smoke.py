#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, torch, numpy and the stdlib, and builds the port's kernels from the
sources under ``tennis_torch/csrc``. Phases, one line each:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: ``nvcc`` of every kernel, with its time and ptxas report;
3. kernel vs plain version: the dense-layer kernel against
   ``dense_layer_reference`` in bf16 at the first and last layer shape of
   each DenseNet121-512 block (batch 8), a ragged 7x7 map and batch 1; times
   of the kernel, the plain version and the two cuDNN convolutions of the
   layer (the library yardstick); then the whole 58-layer stack of one
   batch-8 forward the same three ways;
4. main path: ``FrameModel(DenseNet121)`` at 512^2 with seeded random
   weights in flax naming, loaded through ``bridge.load_flax``, served by
   ``serve.make_service``: 16 concurrent frames through its ``Batcher``,
   ``GET /healthz`` over HTTP, probabilities checked, 58 kernel launches per
   batch, batch-8 logits against the plain-version forward;
5. ``{"kernels": [...]}``, then the card line, then ``{"ok": true, ...}``.

Any failure exits nonzero before the last line. Without a GPU, or without
the repo beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
KERNEL_TOL = 1e-2         # max |kernel - plain| / max |plain|, bf16 state
LOGIT_TOL = 5e-2          # same measure on batch-8 logits after 120 layers
DATA_SHAPE = 512
BATCH = 8
N_REQUESTS = 16
SEED = 0

# (name, batch, side, c_in, c_final): first and last layer of each
# DenseNet121-512 block at batch 8, a ragged map, batch 1
LAYER_CASES = [
    ("block0_first", 8, 128, 64, 256), ("block0_last", 8, 128, 224, 256),
    ("block1_first", 8, 64, 128, 512), ("block1_last", 8, 64, 480, 512),
    ("block2_first", 8, 32, 256, 1024), ("block2_last", 8, 32, 992, 1024),
    ("block3_first", 8, 16, 512, 1024), ("block3_last", 8, 16, 992, 1024),
    ("ragged_7x7", 8, 7, 512, 1024), ("batch1", 1, 128, 64, 256),
]


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls,
    CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_profile(fn):
    """Device time (ms) and launch count by kernel name over one call of
    ``fn``, from torch.profiler's CUPTI trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    return by_name


def dense_layer_device(fn):
    """(device ms, launches) of the dense-layer kernel over one call of ``fn``."""
    hits = [v for k, v in device_profile(fn).items() if "dense_layer_kernel" in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def layer_work(batch, side, c_in, f=128, g=32):
    """(FLOP, bytes) one dense layer needs: each input read once, each output
    written once."""
    px = batch * side * side
    flops = 2 * px * (c_in * f + 9 * f * g)
    nbytes = 2 * px * (c_in + g) + 2 * (f * c_in + 9 * g * f) + 4 * (2 * c_in + 2 * f)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def random_layer(gen, batch, side, c_in, c_final, dev):
    from tennis_torch.ops.dense_block import LayerOperands

    def rand(*shape, lo=None, hi=None, std=1.0):
        t = torch.empty(shape, device=dev)
        if lo is not None:
            return t.uniform_(lo, hi, generator=gen)
        return t.normal_(0.0, std, generator=gen)

    state = rand(batch, side, side, c_final).to(torch.bfloat16)
    ops = LayerOperands(
        rand(c_in, lo=0.5, hi=1.5), rand(c_in, std=0.5),
        rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
        rand(128, lo=0.5, hi=1.5), rand(128, std=0.5),
        rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))
    return state, ops


def library_convs(state, c_in, ops):
    """The layer's two convolutions as cuDNN calls on contiguous
    channels-last bf16 inputs: the library yardstick, never on the port's path."""
    x = state[..., :c_in].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w1 = ops.w1[:, :, None, None].contiguous(memory_format=torch.channels_last)
    w2 = ops.w2.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(F.conv2d(x, w1), w2, padding=1)


def kernel_phase():
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst_abs = 0.0
    for name, batch, side, c_in, c_final in LAYER_CASES:
        state, ops = random_layer(gen, batch, side, c_in, c_final, dev)
        got = db.dense_layer(state.clone(), c_in, ops)
        want = db.dense_layer_reference(state.clone(), c_in, ops)
        torch.cuda.synchronize()
        part_g = got[..., c_in:c_in + 32].float()
        part_w = want[..., c_in:c_in + 32].float()
        abs_err = (part_g - part_w).abs().max().item()
        rel_err = abs_err / part_w.abs().max().item()
        untouched = torch.equal(torch.cat([got[..., :c_in], got[..., c_in + 32:]], -1),
                                torch.cat([state[..., :c_in], state[..., c_in + 32:]], -1))
        ok = bool(torch.isfinite(part_g).all()) and rel_err <= KERNEL_TOL and untouched
        ms = time_ms(lambda: db.dense_layer(state, c_in, ops))
        device_ms, _ = dense_layer_device(lambda: db.dense_layer(state, c_in, ops))
        plain_ms = time_ms(lambda: db.dense_layer_reference(state, c_in, ops), reps=3)
        lib_ms = time_ms(library_convs(state, c_in, ops))
        b_ms, b_by = bound(*layer_work(batch, side, c_in))
        log("kernel", case=name, shape=[batch, side, side, c_final], c_in=c_in,
            max_abs_err=abs_err, rel_err=rel_err, tol=KERNEL_TOL,
            other_channels_untouched=untouched, ms=ms, device_ms=device_ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            ok=ok)
        if not ok:
            raise SystemExit(f"dense_layer kernel disagrees with its plain "
                             f"version at {name}")
        worst_abs = max(worst_abs, abs_err)
    return worst_abs


def stack_phase():
    """The 58 dense layers of one DenseNet121-512 batch-8 forward, timed as
    kernel, plain version and library convolutions."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    blocks = []  # (state, [(c_in, ops)])
    flops = nbytes = 0
    side, channels = DATA_SHAPE // 4, 64
    for num_layers in (6, 12, 24, 16):
        c_final = channels + 32 * num_layers
        layers = []
        for j in range(num_layers):
            state, ops = random_layer(gen, BATCH, side, channels + 32 * j,
                                      c_final, dev)
            layers.append((channels + 32 * j, ops))
            f, b = layer_work(BATCH, side, channels + 32 * j)
            flops, nbytes = flops + f, nbytes + b
        blocks.append((state, layers))
        channels, side = c_final // 2, side // 2

    def run(fn):
        def go():
            for state, layers in blocks:
                for c_in, ops in layers:
                    fn(state, c_in, ops)
        return go

    lib = [library_convs(state, c_in, ops)
           for state, layers in blocks for c_in, ops in layers]
    ms = time_ms(run(db.dense_layer), reps=5)
    plain_ms = time_ms(run(db.dense_layer_reference), reps=1)
    library_ms = time_ms(lambda: [f() for f in lib], reps=5)
    # the kernels' own time, without the host gaps between launches
    device_ms, launches = dense_layer_device(run(db.dense_layer))
    b_ms, b_by = bound(flops, nbytes)
    n_layers = sum(len(layers) for _, layers in blocks)
    log("stack", layers=n_layers, batch=BATCH, data_shape=DATA_SHAPE,
        gflop=flops / 1e9, gbytes=nbytes / 1e9, ms=ms, device_ms=device_ms,
        profiled_launches=launches, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=b_ms, bound_by=b_by, device_tflops=flops / device_ms / 1e9,
        roofline_share=b_ms / device_ms)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def random_flax_tree(tree, rng):
    """Redraw every leaf of a flax-named tree: kernels lecun-normal
    (truncated at 2 std), BN scale 1 / bias 0, statistics perturbed away from
    (0, 1) so the folded affine is non-trivial."""
    def draw(name, leaf):
        shape = leaf.shape
        if name == "kernel":
            std = (1.0 / np.prod(shape[:-1])) ** 0.5 / 0.87962566103423978
            z = rng.standard_normal(shape)
            while (bad := np.abs(z) > 2).any():
                z[bad] = rng.standard_normal(int(bad.sum()))
            return (z * std).astype(np.float32)
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        return np.zeros(shape, np.float32)  # bias

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in t.items()}

    return walk(tree)


def main_path_phase(dev):
    from http.server import ThreadingHTTPServer

    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import build_frame_model, make_predict_probs
    from tennis_torch.ops import dense_block as db
    from tennis_torch.serve import make_service

    rng = np.random.default_rng(SEED)
    classes = list(DEFAULT_CLASSES)
    model = build_frame_model("DenseNet121", len(classes), DATA_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    torch.cuda.reset_peak_memory_stats()
    predict_probs = make_predict_probs(model, dev)
    handler, batcher = make_service(classes, predict_probs, BATCH, DATA_SHAPE,
                                    max_wait_ms=200)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        frames = rng.integers(0, 256, (N_REQUESTS, DATA_SHAPE, DATA_SHAPE, 3),
                              dtype=np.uint8)
        results = [None] * N_REQUESTS

        def request(i):
            results[i] = batcher.submit(frames[i], timeout=300)

        batches0 = batcher.batches
        db.dense_layer.launches = 0
        start = time.perf_counter()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - start
        launches = db.dense_layer.launches
        batches = batcher.batches - batches0
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise SystemExit("not every request was answered")
        url = "http://127.0.0.1:%d/healthz" % httpd.server_address[1]
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()

    probs = np.stack(results)
    finite = bool(np.isfinite(probs).all())
    sums_ok = bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3))
    if not (finite and sums_ok and probs.shape == (N_REQUESTS, len(classes))):
        raise SystemExit(f"bad probabilities: finite={finite} sums_ok={sums_ok} "
                         f"shape={probs.shape}")
    if launches != 58 * batches or batches < 1:
        raise SystemExit(f"{launches} dense-layer launches for {batches} "
                         f"batches, expected 58 per batch")
    if health["status"] != "ok" or health["requests"] < N_REQUESTS:
        raise SystemExit(f"healthz: {health}")

    # batch-8 latency through the entry point (uint8 in, host probabilities out)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        predict_probs(frames[:BATCH])
        lat.append((time.perf_counter() - t0) * 1e3)
    latency_ms = statistics.median(lat)
    # where the time of one batch goes on the device
    kernels = device_profile(lambda: predict_probs(frames[:BATCH]))
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("breakdown", batch=BATCH, latency_ms=latency_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / latency_ms,
        dense_layer_ms=sum(v[0] for k, v in kernels.items()
                           if "dense_layer_kernel" in k),
        top=[[k[:60], v[0], v[1]] for k, v in top])

    # logits: kernel path vs the plain-version forward on the same frames
    # (comparison runs, after the counts were read)
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames[:BATCH]).to(dev))
        got = db.frame_model_apply(model, x)
        want = db.frame_model_apply(model, x, layer=db.dense_layer_reference)
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    served = np.allclose(torch.softmax(got, -1).cpu().numpy(), probs[:BATCH],
                         atol=1e-2)
    log("main_path", requests=N_REQUESTS, batches=batches, launches=launches,
        launches_per_batch=launches / batches, wall_s=wall,
        batch8_latency_ms=latency_ms, frames_per_s=BATCH / latency_ms * 1e3,
        healthz=health, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        logits_rel_err=rel, logit_tol=LOGIT_TOL, top1_agrees=top1,
        served_probs_match_forward=served)
    if not (rel <= LOGIT_TOL and top1 and served):
        raise SystemExit("kernel forward disagrees with the plain-version forward")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tennis_torch")):
        print("chip_smoke: tennis_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # the plain versions are the yardstick: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log("card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda)

    from tennis_torch.ops import _build

    t0 = time.perf_counter()
    _build.build("dense_layer")
    seconds, report = _build.build_info["dense_layer"]
    log("build", kernel="dense_layer", seconds=seconds,
        wall_s=time.perf_counter() - t0,
        ptxas=[l for l in report.splitlines() if "registers" in l or "spill" in l])

    max_abs = kernel_phase()
    stack = stack_phase()
    launches = main_path_phase(torch.device("cuda"))

    print(json.dumps({"kernels": [{
        "name": "dense_layer", "route": "cuda",
        "source": "tennis_torch/csrc/dense_layer.cu",
        "replaces": "tennis_tpu/ops/pallas/dense_block.py:92",
        "launches": launches, "max_abs_err": max_abs,
        "ms": stack["ms"], "device_ms": stack["device_ms"],
        "plain_ms": stack["plain_ms"],
        "bound_ms": stack["bound_ms"], "bound_by": stack["bound_by"],
        "library_ms": stack["library_ms"],
        "work": f"58 dense layers of DenseNet121 at {DATA_SHAPE}^2, batch {BATCH}",
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
