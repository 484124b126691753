#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, torch, numpy and the stdlib, and builds the port's kernels from the
sources under ``tennis_torch/csrc``. Phases, one line each:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: ``nvcc`` of every kernel, all started together, with each one's
   time and ptxas report;
3. kernel vs plain version: the three dense-layer kernels (persistent for
   the large maps, cluster split-K for the small ones, tile) against
   ``dense_layer_reference`` in bf16 at the first and last layer shape of
   each DenseNet121-512 block (batch 8), two more 64^2 shapes (the last c_in
   with w1 resident in the persistent kernel and the first with w1
   streamed), ragged 7x7 and 14x14 maps, batch 1, DenseNet201's c_in 1888
   and a c_in whose units do not divide by the cluster size; the cluster
   kernel at every cluster size; device times of each, which one the wrapper
   chooses, times of the plain version and of the two cuDNN convolutions of
   the layer (the library yardstick). Then ``[route]``: every small-map
   layer shape of DenseNet121/169/201 at 512^2 (c_in in steps of 64) and
   the ragged maps, at batch 1 and 8, each kernel and cluster size timed by
   device time in three rounds of alternating order, the fastest beside the
   wrapper's route, and the same for DenseNet121's 32^2, 16^2 and 7x7
   maps at batch 64. Then the whole 58-layer stack of one batch-8 forward,
   every layer through every kernel against the plain version, and block by
   block: the wrapper's choice, each kernel alone, the plain version and
   cuDNN; and the stack at batch 64 (``[stack64]``), every layer through
   the route's kernel against the plain version, block by block beside
   cuDNN and the bytes bound;
4. classifier path: ``FrameModel(DenseNet121)`` at 512^2 with seeded random
   weights in flax naming, loaded through ``bridge.load_flax``, served by
   ``serve.make_service``: 16 concurrent frames through its ``Batcher``,
   ``GET /healthz`` over HTTP, probabilities checked, 58 kernel launches per
   batch split between the kernels as the wrapper's route names them,
   batch-8 logits against the plain-version forward;
4b. extraction (``[extract]``): ``train.save_features`` over an in-memory
   split of 32 x 64 + 37 frames at 512^2 (256 distinct seeded frames; no
   JPEG is decoded, the card machine may lack cv2), through ``DataLoader``,
   the pinned ``prefetch_to_device`` and the kernels to .npy files: 2085
   files of f32 (4096,), 58 launches a batch split as the route names them
   for batch 64 and 37, the first and the ragged batch against the
   plain-version features; frames/s, device busy and idle share, the
   prefetch and writer stats, peak memory. ``[evaluate]``: the same split
   through ``eval_iter`` and the metric set, PRF1 against the plain
   version's, frames/s; the ``--temp_pool mean`` wrap through the backbone
   at 2 clips x 8 frames (58 launches, one forward);
4c. training (``[train]``, run after phase 7): ``FrameModel(DenseNet121,
   11)`` at 512^2 and
   batch 64 over 256 seeded in-memory uint8 frames, through
   ``make_train_step``: ``apply_augment``, the bf16 train-mode forward and
   backward (plain torch ops and cuDNN, as the JAX package trains through
   its flax module), momentum SGD. With ``remat`` none and block: 3
   warm-up and 20 timed steps each (step ms, samples/s, device busy and
   idle share over 2 profiled steps, the largest kernels, peak memory,
   model FLOPs and ``mfu`` against the dense bf16 peak). Gates: every loss
   finite; 30 steps on one repeated batch lower the loss; the first bf16
   step against the same step in f32 (TF32 off) at batch 16: the loss, the
   running statistics and the update; remat block gives the first-step
   loss of none and a lower peak. ``[train_driver]``: ``train.fit`` over
   in-memory train (256 frames), val and test (64 + 37 each) splits for 2
   epochs of 3 batches into a temporary experiment: ``0000.params``,
   ``0001.params`` and ``scores.txt`` written and read back bit for bit as
   saved, momentum included; each evaluation (2 val passes and the final
   test) 58 dense launches a forward split by the route, its first batch's
   logits against the plain-version forward of a model loaded with that
   epoch's weights, and (val) nearer them than those of the weights before
   (lr 0.01, so a stale BN fold would show); the final test on the best
   epoch's weights; resuming
   from ``0000.params`` and taking epoch 1's first step gives the
   uninterrupted run's parameters;
5. GRU kernels vs plain version: ``gru_recurrence`` against
   ``gru_recurrence_reference`` in f32, both kernels (``"async"`` at every
   cluster size that takes the shape, and ``"barrier"`` where it fits), at
   the 0102 serving shape (T 128, batch 4, H 256), the measured ``/caption``
   lengths 21/30/104/69 (every row ends before T), H 512, the evaluate batch
   (32), the default width (H 128), T 1, and a per-epoch decode batch of the
   captioning trainer (batch 32, T 512, lengths 64-512); device times of
   each, which one
   the route takes, times of the plain version, the port's whole layer
   (input GEMM + kernel) and cuDNN's ``nn.GRU`` over the same layer, the
   bound, and the serial floors: T cluster-barrier round trips for the
   barrier kernel, one ``st.async`` + mbarrier round trip of the kernel's
   own exchange per live step for the async one;
6. caption path: the 0102 captioner (features 4096, H 256, 2 layers, 1
   bidirectional, E 100, V 254) with seeded random weights in flax naming,
   served by ``make_service``: 8 concurrent ``POST /caption`` over HTTP at
   ``--caption_batch_size 4``, ``--src_max_len 128``, beam 4, max length 70;
   3 GRU-kernel launches per batch by the routed variant, the kernel-path
   encoder against the
   plain-version encoder, and the kernel path's top beams rescored
   teacher-forced through the plain-encoded decoder; latency split into
   encode and decode loop, device busy and idle share;
6b. captioner training (``[caption_train]``): the same captioner with
   dropout 0.2, Adam 1e-3 and clip 5 over an in-memory train split of 512
   points (64-512 frames of seeded 4096-d features, captions of 8-50 ids),
   through ``make_seq2seq_train_step`` at ``--batch_size 128``: 3 warm-up
   and 20 timed steps over the bucketed batches (step ms, target tokens/s,
   source frames/s, device busy and idle share and launches over 2 profiled
   steps, the largest kernels, peak memory). Gates: every loss finite; 30
   steps on one batch lower the loss; the first step's loss (1e-4 relative)
   and gradients (1e-3 global relative L2) at dropout 0 against the CPU's;
   the differentiable recurrence against the GRU kernel within 1e-4; no
   GRU kernel launch in a train step. ``[caption_driver]``:
   ``train_gnmt.train`` for 2 epochs over that split and val and test splits
   of 96 points at ``--test_batch_size 32``, a resumed run to 3 epochs and
   ``evaluate_gnmt.evaluate --force --metrics_out``, with EOS biased far
   down so that every decode runs the max length of 70 steps: 3 GRU kernel
   launches a decode batch by the routed variant, the first evaluation's
   encoder
   outputs within 1e-4 of the plain version, the epoch files read back bit
   for bit, the resumed run's rate the saved one with one decay after it,
   the evaluator's ``best_test_out.txt`` byte for byte the trainer's, the 7
   metrics in range; decode ms (a batch and a step), a decode's device
   idle share, wall per epoch;
7. DenseNet161 path: ``FrameModel(DenseNet161)`` at 224^2 with seeded
   random weights, its batch-2 warm-up forward through ``make_service``:
   78 dense layers through ``dense_layer_convs`` (widths no TPU kernel
   computes), no dense-kernel launch, logits against the plain-version
   forward;
8. ``{"kernels": [...]}``, then the card line, then ``{"ok": true, ...}``.

Any failure exits nonzero before the last line. Without a GPU, or without
the repo beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
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
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
KERNEL_TOL = 1e-2         # max |kernel - plain| / max |plain|, bf16 state
LOGIT_TOL = 5e-2          # same measure on batch-8 logits after 120 layers
GRU_TOL = 1e-4            # max |kernel - plain|, f32, another summation order
RESCORE_TOL = 1e-3        # |reported - rescored| penalized log-prob of a beam
DATA_SHAPE = 512
BATCH = 8
N_REQUESTS = 16
SEED = 0
KERNELS = ["dense_layer", "dense_layer_persistent", "dense_layer_cluster",
           "gru_recurrence", "gru_recurrence_async"]
# profiler name of each dense-layer kernel variant (no name holds another);
# the cluster kernel's name also carries its cluster size, <2>, <4> or <8>
DENSE_KERNELS = {"persistent": "dense_layer_persistent_kernel",
                 "tile": "dense_layer_kernel",
                 "cluster": "dense_layer_cluster_kernel"}
# profiler name of each GRU kernel variant (neither name holds the other)
GRU_KERNELS = {"barrier": "gru_recurrence_kernel",
               "async": "gru_recurrence_async_kernel"}
ROUTE_ROUNDS = 3
# profiler sessions tried before a trace that dropped kernel records fails
# the run (three in a row did, once in a dozen runs)
TRACE_ATTEMPTS = 6
ROUTE_REPS = 3

# the 0102 captioner (README, train_gnmt flags): 0006 features, 2 GRU layers
# of 256 (the first bidirectional), embeddings of 100, 4 specials + 250 words
FEAT_DIM = 4096
CAPTION_ARGV = ["--feats_model=0006", "--num_hidden=256", "--num_layers=2",
                "--num_bi_layers=1", "--emb_size=100", "--cell_type=gru"]
VOCAB_WORDS = 250
SRC_MAX_LEN = 128
CAPTION_BATCH = 4
N_CAPTIONS = 8
# the captioner's training and per-epoch evaluation (train_gnmt defaults):
# in-memory splits of 512 / 96 / 96 points, sources of 64-512 frames and
# captions of 8-50 ids (BOS and EOS included), both uniform; features drawn
# from (SEED, split, point). The card-vs-CPU gradient check at dropout 0
# takes CAP_CPU_ROWS rows of the shortest train batch.
CAP_POINTS = {"train": 512, "val": 96, "test": 96}
CAP_SRC_LEN, CAP_IDS_LEN = (64, 512), (8, 50)
CAP_TRAIN_ARGV = CAPTION_ARGV + [
    "--batch_size=128", "--test_batch_size=32", "--dropout=0.2",
    "--optimizer=adam", "--lr=0.001", "--clip=5", "--emb_file=",
    "--device=cuda"]
CAP_WARMUP, CAP_TIMED, CAP_PROFILED = 3, 20, 2
CAP_CPU_ROWS = 16
# the driver's EOS logit bias: far enough below every word's that its 12
# Adam steps at 1e-3 cannot lift EOS into a beam, so every decode runs the
# translator's max length (--tgt_max_len + 20), as /caption's decodes do on
# random weights
CAP_EOS_BIAS = -100.0
CAP_LOSS_TOL = 1e-4  # |card - CPU| / |CPU| loss, first step, TF32 off
CAP_GRAD_TOL = 1e-3  # global relative L2 of the gradients, same step
# DenseNet161 (bottleneck 192, growth 48) at the 224^2 of its ImageNet config
D161_SHAPE = 224
D161_BATCH = 2
# feature extraction and evaluation: the drivers' default --batch_size over
# an in-memory split of 32 full batches and a ragged one, 256 distinct
# frames indexed modulo; the pooled wrap at batch 2 x window 8
EXTRACT_BATCH = 64
EXTRACT_FRAMES = 32 * EXTRACT_BATCH + 37
EXTRACT_DISTINCT = 256
PROFILE_BATCHES = 4
POOL_BATCH, POOL_WINDOW = 2, 8
# training: the driver's --batch_size and default optimizer; the f32
# comparison at a smaller batch, to hold two models' activations at once
TRAIN_BATCH = 64
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 3, 20, 2
OVERFIT_STEPS = 30
F32_BATCH = 16
# bf16 against f32, first step (PERF.md, Findings): relative loss, worst
# running statistic over max |f32 statistic|, global relative L2 of the
# update. The update's bound is O(1): at random weights bf16 rounding moves
# the gradients of a deep DenseNet by O(1) in the JAX package too (tests/
# test_torch_train_densenet.py holds the port's gap to the JAX package's)
TRAIN_LOSS_TOL, TRAIN_STATS_TOL, TRAIN_UPDATE_TOL = 2e-2, 5e-2, 1.0
REMAT_LOSS_TOL = 2 ** -7  # one bf16 step, relative
# the driver: 2 epochs of DRIVER_BATCHES steps over DRIVER_TRAIN frames;
# val and test of a full and a ragged batch; a resumed step's parameters
# within RESUME_TOL of the uninterrupted run's, relative to that step's
# own update (global L2; cuDNN's backward sums in a varying order)
DRIVER_TRAIN, DRIVER_EVAL, DRIVER_BATCHES = 256, EXTRACT_BATCH + 37, 3
RESUME_TOL = 2e-2

# (name, T, batch, H, valid lengths): the 0102 serving shape, the lengths of
# the measured /caption batch (all end before T), --num_hidden 512, the
# evaluate batch (--test_batch_size 32), the default --num_hidden, one step,
# and a per-epoch decode batch of train_gnmt (batch 32 over sources of
# 64-512 frames)
GRU_CASES = [
    ("serve_0102", 128, 4, 256, [128, 100, 37, 1]),
    ("caption_lengths", 128, 4, 256, [21, 30, 104, 69]),
    ("serve_h512", 128, 4, 512, [128, 100, 37, 1]),
    ("evaluate_b32", 128, 32, 256, [128 * (31 - i) // 31 for i in range(32)]),
    ("default_h128", 128, 4, 128, [128, 100, 37, 1]),
    ("t1", 1, 4, 256, [1, 0, 1, 1]),
    ("decode_b32_t512", 512, 32, 256,
     [64 + 448 * ((7 * i) % 32) // 31 for i in range(32)]),
]

# (name, batch, side, c_in, c_final): first and last layer of each
# DenseNet121-512 block at batch 8, the last 64^2 layer with w1 resident in
# the persistent kernel and the first with w1 streamed, ragged maps (DenseNet
# at 224^2), batch 1, DenseNet201's last c_in, 9 units over up to 8 CTAs
LAYER_CASES = [
    ("block0_first", 8, 128, 64, 256), ("block0_last", 8, 128, 224, 256),
    ("block1_first", 8, 64, 128, 512), ("block1_c288", 8, 64, 288, 512),
    ("block1_c320", 8, 64, 320, 512), ("block1_last", 8, 64, 480, 512),
    ("block2_first", 8, 32, 256, 1024), ("block2_last", 8, 32, 992, 1024),
    ("block3_first", 8, 16, 512, 1024), ("block3_last", 8, 16, 992, 1024),
    ("ragged_7x7", 8, 7, 512, 1024), ("ragged_14x14", 8, 14, 256, 512),
    ("batch1", 1, 128, 64, 256), ("batch1_16", 1, 16, 512, 1024),
    ("d201_c1888", 8, 16, 1888, 1920), ("c288", 1, 16, 288, 320),
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
    ``fn``, from torch.profiler's CUPTI trace of the device's activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    return by_name


def traced_kernels(fn, *names, launches=None):
    """{name: [device ms, launches]} of the kernels whose name holds one of
    ``names`` (any kernel without names) over one call of ``fn``. A trace
    that recorded none of them, or not ``launches`` of them, is taken again,
    up to TRACE_ATTEMPTS times: the tracer drops a session's records now and
    then."""
    seen = []
    for attempt in range(TRACE_ATTEMPTS):
        if attempt:
            time.sleep(0.5)
        hits = {k: v for k, v in device_profile(fn).items()
                if not names or any(n in k for n in names)}
        seen.append(sum(v[1] for v in hits.values()))
        if hits and launches in (None, seen[-1]):
            return hits
    raise SystemExit(f"the profiler recorded {seen} launches of the kernels "
                     f"{names or ''} where {launches} were expected")


def kernel_device(fn, *names, launches=None):
    """(device ms, launches) of the kernels whose name holds one of
    ``names`` over one call of ``fn``."""
    hits = traced_kernels(fn, *names, launches=launches).values()
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def dense_device_ms(fn, launches):
    """Device ms of the dense-layer kernels over one call of ``fn``, which
    launches them ``launches`` times."""
    return kernel_device(fn, *DENSE_KERNELS.values(), launches=launches)[0]


def all_device_ms(fn):
    """Device ms of every kernel over one call of ``fn``."""
    return kernel_device(fn)[0]


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


def _rand(gen, dev, *shape, lo=None, hi=None, std=1.0):
    t = torch.empty(shape, device=dev)
    if lo is not None:
        return t.uniform_(lo, hi, generator=gen)
    return t.normal_(0.0, std, generator=gen)


def random_ops(gen, c_in, dev):
    """Seeded operands of one dense layer at ``c_in``."""
    from tennis_torch.ops.dense_block import LayerOperands

    def rand(*shape, **kw):
        return _rand(gen, dev, *shape, **kw)

    return LayerOperands(
        rand(c_in, lo=0.5, hi=1.5), rand(c_in, std=0.5),
        rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
        rand(128, lo=0.5, hi=1.5), rand(128, std=0.5),
        rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))


def random_layer(gen, batch, side, c_in, c_final, dev):
    state = _rand(gen, dev, batch, side, side, c_final).to(torch.bfloat16)
    return state, random_ops(gen, c_in, dev)


def library_convs(state, c_in, ops):
    """The layer's two convolutions as cuDNN calls on contiguous
    channels-last bf16 inputs: the library yardstick, never on the port's path."""
    x = state[..., :c_in].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w1 = ops.w1[:, :, None, None].contiguous(memory_format=torch.channels_last)
    w2 = ops.w2.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(F.conv2d(x, w1), w2, padding=1)


def check_layer(state, got, want, c_in):
    """(max |kernel - plain| over the growth channels, that over max |plain|,
    every other channel untouched, ok)."""
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    abs_err = (part_g - part_w).abs().max().item()
    rel = abs_err / part_w.abs().max().item()
    untouched = torch.equal(
        torch.cat([got[..., :c_in], got[..., c_in + 32:]], -1),
        torch.cat([state[..., :c_in], state[..., c_in + 32:]], -1))
    ok = bool(torch.isfinite(part_g).all()) and untouched and rel <= KERNEL_TOL
    return abs_err, rel, untouched, ok


def kernel_phase():
    """The three dense-layer kernels against the plain version at
    LAYER_CASES, the cluster kernel at every cluster size it takes there;
    returns the worst max |kernel - plain| of each variant."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst_abs = dict.fromkeys(db.VARIANTS, 0.0)
    for name, batch, side, c_in, c_final in LAYER_CASES:
        state, ops = random_layer(gen, batch, side, c_in, c_final, dev)
        want = db.dense_layer_reference(state.clone(), c_in, ops)
        chosen, routed_size = db.dense_layer_route(batch, side, side, c_in)
        size = db.dense_layer_cluster_size(batch, side, side, c_in)
        runs = [(v, None) for v in db.VARIANTS if v != "cluster"]
        runs += [("cluster", s) for s in db.CLUSTER_SIZES]
        row, ok = {}, True
        for variant, s in runs:
            key = variant if s is None else f"cluster{s}"
            got = db.dense_layer(state.clone(), c_in, ops, variant, s)
            torch.cuda.synchronize()
            abs_err, rel, untouched, v_ok = check_layer(state, got, want, c_in)
            ok = ok and v_ok
            worst_abs[variant] = max(worst_abs[variant], abs_err)
            row[f"{key}_max_abs_err"] = abs_err
            row[f"{key}_rel_err"] = rel
            row[f"{key}_untouched"] = untouched
            row[f"{key}_device_ms"] = kernel_device(
                lambda v=variant, s=s: db.dense_layer(state, c_in, ops, v, s),
                DENSE_KERNELS[variant], launches=1)[0]
        ms = time_ms(lambda: db.dense_layer(state, c_in, ops))
        plain_ms = time_ms(lambda: db.dense_layer_reference(state, c_in, ops), reps=3)
        lib = library_convs(state, c_in, ops)
        b_ms, b_by = bound(*layer_work(batch, side, c_in))
        smem, resident = db.persistent_smem_bytes(c_in)
        chosen_key = chosen if routed_size is None else f"cluster{routed_size}"
        log("kernel", case=name, shape=[batch, side, side, c_final], c_in=c_in,
            variant=chosen, cluster_size=size, tol=KERNEL_TOL, ms=ms,
            device_ms=row[f"{chosen_key}_device_ms"], **row, plain_ms=plain_ms,
            library_ms=time_ms(lib), library_device_ms=all_device_ms(lib),
            bound_ms=b_ms, bound_by=b_by, persistent_smem_bytes=smem,
            persistent_w1_resident=resident,
            cluster_smem_bytes={s: db.cluster_smem_bytes(s)
                                for s in db.CLUSTER_SIZES}, ok=ok)
        if not ok:
            raise SystemExit(f"a dense_layer kernel disagrees with its plain "
                             f"version at {name}")
    return worst_abs


def route_shapes():
    """(batch, side, c_in) of every small-map layer of DenseNet121/169/201
    at 512^2 (c_in in steps of 64, and each block's last c_in), and of the
    ragged 14x14 and 7x7 maps of DenseNet121 at 224^2, at batch 1 and 8;
    and at the extraction batch (64), DenseNet121's 32^2 and 16^2 maps at
    512^2 and its 7x7 map at 224^2."""
    # side: the blocks' first c_in in steps of 64 to the last of DenseNet201,
    # and the last c_in of DenseNet121, 169 and 201
    c_ins = {32: sorted({*range(256, 1761, 64), 992, 1248, 1760}),
             16: sorted({*range(512, 1889, 64), 992, 1632, 1888}),
             14: [256, 608, 992], 7: [512, 736, 992]}
    d121 = {32: [*range(256, 993, 64), 992], 16: [*range(512, 993, 64), 992],
            7: [*range(512, 993, 64), 992]}
    return [(batch, side, c) for batch in (8, 1) for side, cs in c_ins.items()
            for c in cs] + [(EXTRACT_BATCH, side, c)
                            for side, cs in d121.items() for c in cs]


def route_phase():
    """Device time of every kernel and cluster size at every route_shapes()
    shape, ROUTE_ROUNDS rounds of ROUTE_REPS launches each, the order of the
    kernels rotated from round to round; one profiler session per round,
    whose kernel records are matched to the launches in order. Logs one
    ``[route]`` line per shape; returns how often the route is the fastest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = []
    for batch, side, c_in in route_shapes():
        state, ops = random_layer(gen, batch, side, c_in, c_in + 32, dev)
        runs = [(v, None) for v in ("tile", "persistent")]
        runs += [("cluster", s) for s in db.CLUSTER_SIZES]
        cases.append((batch, side, c_in, state, ops, runs))

    def launch_all(rnd):
        """Every case's kernels, rotated by the round; [(case, key)]."""
        order = []
        for i, (_, _, c_in, state, ops, runs) in enumerate(cases):
            k = rnd % len(runs)
            for variant, s in runs[k:] + runs[:k]:
                for _ in range(ROUTE_REPS):
                    db.dense_layer(state, c_in, ops, variant, s)
                    order.append((i, variant if s is None else f"cluster{s}"))
        return order

    def traced_round(rnd):
        """[(case, key, device ms)] of one round's launches, in order; a
        trace that dropped records is taken again, up to TRACE_ATTEMPTS
        times."""
        for attempt in range(TRACE_ATTEMPTS):
            if attempt:
                time.sleep(0.5)
            launch_all(rnd)  # warm: every kernel built, its cluster size checked
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                order = launch_all(rnd)
                torch.cuda.synchronize()
            records = sorted((e for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and "dense_layer" in e.name),
                             key=lambda e: e.time_range.start)
            if len(records) == len(order):
                return [(i, key, e.time_range.elapsed_us() / 1e3)
                        for (i, key), e in zip(order, records)]
        raise SystemExit(f"route phase: {len(records)} kernel records for "
                         f"{len(order)} launches, {TRACE_ATTEMPTS} times")

    times = [{} for _ in cases]  # key -> [per-round mean ms]
    for rnd in range(ROUTE_ROUNDS):
        sums = {}
        for i, key, ms in traced_round(rnd):
            sums[i, key] = sums.get((i, key), 0.0) + ms
        for (i, key), total in sums.items():
            times[i].setdefault(key, []).append(total / ROUTE_REPS)
    agree = {}  # batch -> [shapes where the route is the fastest, shapes]
    for (batch, side, c_in, _, _, _), t in zip(cases, times):
        med = {k: statistics.median(v) for k, v in t.items()}
        fastest = min(med, key=med.get)
        variant, size = db.dense_layer_route(batch, side, side, c_in)
        routed = variant if size is None else f"cluster{size}"
        tally = agree.setdefault(batch, [0, 0])
        tally[0] += routed == fastest
        tally[1] += 1
        log("route", batch=batch, side=side, c_in=c_in, device_ms=med,
            spread=[min(min(v) / med[k] for k, v in t.items()),
                    max(max(v) / med[k] for k, v in t.items())],
            fastest=fastest, routed=routed,
            routed_over_fastest=med[routed] / med[fastest])
    return agree


def stack_phase():
    """The 58 dense layers of one DenseNet121-512 batch-8 forward: every
    layer through every kernel against the plain version, each layer's
    routed kernel, plain version and library convolutions timed, and block
    by block the wrapper's choice, each kernel alone, the plain version and
    the library. Returns the per-block rows, the per-layer rows and the
    device ms of each kernel over the routed stack."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    blocks = []  # (state, [(c_in, ops)], flops, bytes)
    side, channels = DATA_SHAPE // 4, 64
    for num_layers in (6, 12, 24, 16):
        c_final = channels + 32 * num_layers
        layers, flops, nbytes = [], 0, 0
        for j in range(num_layers):
            state, ops = random_layer(gen, BATCH, side, channels + 32 * j,
                                      c_final, dev)
            layers.append((channels + 32 * j, ops))
            f, b = layer_work(BATCH, side, channels + 32 * j)
            flops, nbytes = flops + f, nbytes + b
        blocks.append((state, layers, flops, nbytes))
        channels, side = c_final // 2, side // 2

    def run(fn, which, **kw):
        def go():
            for state, layers, _, _ in which:
                for c_in, ops in layers:
                    fn(state, c_in, ops, **kw)
        return go

    layer_rows, worst_rel = [], dict.fromkeys(db.VARIANTS, 0.0)
    for i, (state, layers, _, _) in enumerate(blocks):
        side = state.shape[1]
        for c_in, ops in layers:
            want = db.dense_layer_reference(state.clone(), c_in, ops)
            for variant in db.VARIANTS:
                got = db.dense_layer(state.clone(), c_in, ops, variant)
                torch.cuda.synchronize()
                _, rel, _, ok = check_layer(state, got, want, c_in)
                worst_rel[variant] = max(worst_rel[variant], rel)
                if not ok:
                    raise SystemExit(f"the {variant} kernel disagrees with its "
                                     f"plain version at block {i}, c_in {c_in}")
            flops, nbytes = layer_work(BATCH, side, c_in)
            layer_rows.append({
                "block": i, "c_in": c_in, "flops": flops, "bytes": nbytes,
                "variant": db.dense_layer_variant(BATCH, side, side, c_in),
                "ms": time_ms(lambda: db.dense_layer(state, c_in, ops), rounds=3),
                "plain_ms": time_ms(
                    lambda: db.dense_layer_reference(state, c_in, ops),
                    reps=1, rounds=3),
                "library_ms": time_ms(library_convs(state, c_in, ops), rounds=3)})
    log("stack_check", layers=len(layer_rows), tol=KERNEL_TOL,
        worst_rel_err=worst_rel)

    rows = []
    for i, blk in enumerate(blocks):
        state, layers, flops, nbytes = blk
        lib = [library_convs(state, c_in, ops) for c_in, ops in layers]

        def lib_go(lib=lib):
            for f in lib:
                f()

        mine = [r for r in layer_rows if r["block"] == i]
        b_ms, b_by = bound(flops, nbytes)
        row = {"block": i, "side": state.shape[1], "layers": len(layers),
               "variants": {v: sum(r["variant"] == v for r in mine)
                            for v in db.VARIANTS},
               "ms": time_ms(run(db.dense_layer, [blk]), reps=5),
               "device_ms": dense_device_ms(run(db.dense_layer, [blk]),
                                            len(layers))}
        for variant in db.VARIANTS:
            row[f"{variant}_ms"] = time_ms(
                run(db.dense_layer, [blk], variant=variant), reps=5)
            row[f"{variant}_device_ms"] = dense_device_ms(
                run(db.dense_layer, [blk], variant=variant), len(layers))
        row.update(plain_ms=sum(r["plain_ms"] for r in mine),
                   library_ms=sum(r["library_ms"] for r in mine),
                   library_device_ms=all_device_ms(lib_go), bound_ms=b_ms,
                   bound_by=b_by, flops=flops, bytes=nbytes)
        log("stack_block", **row)
        rows.append(row)

    flops = sum(r["flops"] for r in rows)
    nbytes = sum(r["bytes"] for r in rows)
    ms = time_ms(run(db.dense_layer, blocks), reps=5)
    plain_ms = sum(r["plain_ms"] for r in rows)
    library_ms = sum(r["library_ms"] for r in rows)
    # the kernels' own time, without the host gaps between launches
    n_layers = sum(len(layers) for _, layers, _, _ in blocks)
    by_name = traced_kernels(run(db.dense_layer, blocks),
                             *DENSE_KERNELS.values(), launches=n_layers)
    routed_device = {v: sum(t for k, (t, _) in by_name.items() if n in k)
                     for v, n in DENSE_KERNELS.items()}
    device_ms = sum(routed_device.values())
    launches = sum(c for _, c in by_name.values())
    alone = {f"{v}_only_device_ms": dense_device_ms(
        run(db.dense_layer, blocks, variant=v), n_layers) for v in db.VARIANTS}
    b_ms, b_by = bound(flops, nbytes)
    log("stack", layers=n_layers, batch=BATCH, data_shape=DATA_SHAPE,
        gflop=flops / 1e9, gbytes=nbytes / 1e9, ms=ms, device_ms=device_ms,
        device_ms_by_variant=routed_device, **alone,
        profiled_launches=launches, plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=sum(r["library_device_ms"] for r in rows),
        bound_ms=b_ms, bound_by=b_by, device_tflops=flops / device_ms / 1e9,
        roofline_share=b_ms / device_ms,
        choice_beats_each_alone=all(device_ms < t for t in alone.values()))
    return rows, layer_rows, routed_device


def stack64_phase():
    """The 58 dense layers of one DenseNet121-512 forward at the extraction
    batch (64): every layer through the route's kernel against the plain
    version, then block by block the device ms of the route's kernels and
    of cuDNN's two convolutions a layer, beside the bytes bound."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    batch, side, channels = EXTRACT_BATCH, DATA_SHAPE // 4, 64
    rows, worst_rel, totals = [], 0.0, {"flops": 0, "bytes": 0}
    for i, num_layers in enumerate((6, 12, 24, 16)):
        c_final = channels + 32 * num_layers
        state = _rand(gen, dev, batch, side, side, c_final).to(torch.bfloat16)
        layers = [(channels + 32 * j, random_ops(gen, channels + 32 * j, dev))
                  for j in range(num_layers)]
        flops = nbytes = 0
        variants = dict.fromkeys(db.VARIANTS, 0)
        for c_in, ops in layers:
            want = db.dense_layer_reference(state.clone(), c_in, ops)
            got = db.dense_layer(state.clone(), c_in, ops)
            torch.cuda.synchronize()
            _, rel, _, ok = check_layer(state, got, want, c_in)
            del want, got
            worst_rel = max(worst_rel, rel)
            if not ok:
                raise SystemExit(f"dense_layer disagrees with its plain version "
                                 f"at batch {batch}, block {i}, c_in {c_in}")
            f, b = layer_work(batch, side, c_in)
            flops, nbytes = flops + f, nbytes + b
            variants[db.dense_layer_variant(batch, side, side, c_in)] += 1

        def routed(state=state, layers=layers):
            for c_in, ops in layers:
                db.dense_layer(state, c_in, ops)

        lib = [library_convs(state, c_in, ops) for c_in, ops in layers]
        b_ms, b_by = bound(flops, nbytes)
        row = {"block": i, "side": side, "layers": num_layers,
               "variants": variants,
               "device_ms": dense_device_ms(routed, num_layers),
               "library_device_ms": all_device_ms(
                   lambda lib=lib: [f() for f in lib]),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes}
        del lib
        log("stack64_block", batch=batch, **row)
        rows.append(row)
        totals["flops"] += flops
        totals["bytes"] += nbytes
        channels, side = c_final // 2, side // 2
    device_ms = sum(r["device_ms"] for r in rows)
    library_ms = sum(r["library_device_ms"] for r in rows)
    b_ms, b_by = bound(totals["flops"], totals["bytes"])
    variants = {v: sum(r["variants"][v] for r in rows) for v in db.VARIANTS}
    log("stack64", layers=sum(r["layers"] for r in rows), batch=batch,
        data_shape=DATA_SHAPE, tol=KERNEL_TOL, worst_rel_err=worst_rel,
        launches_by_variant=variants, gflop=totals["flops"] / 1e9,
        gbytes=totals["bytes"] / 1e9, device_ms=device_ms,
        device_ms_per_frame=device_ms / batch, library_device_ms=library_ms,
        bound_ms=b_ms, bound_by=b_by, roofline_share=b_ms / device_ms,
        device_tflops=totals["flops"] / device_ms / 1e9)
    return {"rows": rows, "device_ms": device_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def random_flax_tree(tree, rng):
    """Redraw every leaf of a flax-named tree: kernels lecun-normal
    (truncated at 2 std), embeddings normal with variance 1/width, BN scale
    1 / bias 0, statistics perturbed away from (0, 1) so the folded affine is
    non-trivial."""
    def draw(name, leaf):
        shape = leaf.shape
        if name == "embedding":
            return (rng.standard_normal(shape) / shape[-1] ** 0.5).astype(
                np.float32)
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


def routed_launches(db, batch=BATCH):
    """Launches of each dense-layer kernel that the route names for one
    DenseNet121-512 forward at ``batch``."""
    counts = dict.fromkeys(db.ROUTES, 0)
    side, channels = DATA_SHAPE // 4, 64
    for num_layers in (6, 12, 24, 16):
        for j in range(num_layers):
            counts[db.dense_layer_variant(batch, side, side,
                                          channels + 32 * j)] += 1
        channels, side = (channels + 32 * num_layers) // 2, side // 2
    return counts


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
        reset_dense_counts(db)
        start = time.perf_counter()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - start
        launches = db.dense_layer.launches
        by_variant = dict(db.dense_layer.variant_launches)
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
    routed = {v: n * batches for v, n in routed_launches(db).items()}
    if by_variant != routed:
        raise SystemExit(f"dense-layer launches by kernel {by_variant}, the "
                         f"route names {routed}")
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
                           if any(n in k for n in DENSE_KERNELS.values())),
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
        launches_per_batch=launches / batches, launches_by_variant=by_variant,
        routed_launches_by_variant=routed, wall_s=wall,
        batch8_latency_ms=latency_ms, frames_per_s=BATCH / latency_ms * 1e3,
        healthz=health, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        logits_rel_err=rel, logit_tol=LOGIT_TOL, top1_agrees=top1,
        served_probs_match_forward=served)
    if not (rel <= LOGIT_TOL and top1 and served):
        raise SystemExit("kernel forward disagrees with the plain-version forward")
    return by_variant


class MemorySplit:
    """An in-memory split with what the loader, ``save_features`` and
    ``train.fit`` read of a TennisSet: ``len``, ``(img, label, idx)`` items,
    ``save_feature_path``, ``classes`` and the split name. Item i is frame
    ``i % len(frames)`` (so host memory stays bounded) with label
    ``i % 11``; ``window`` > 1 makes item i a clip of that many consecutive
    frames."""

    def __init__(self, frames, n, feat_dir, split, window=1):
        from tennis_torch.data.tennis_set import DEFAULT_CLASSES

        self.frames, self.n, self.feat_dir = frames, n, feat_dir
        self._split, self.window = split, window
        self.classes = list(DEFAULT_CLASSES)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        k = len(self.frames)
        if self.window == 1:
            img = self.frames[idx % k]
        else:
            img = self.frames[[(idx * self.window + t) % k
                               for t in range(self.window)]]
        return img, idx % 11, idx

    def save_feature_path(self, idx):
        from tennis_torch.data.tennis_set import get_feature_path

        return get_feature_path(self.feat_dir, self._split, int(idx))


def reset_dense_counts(db):
    db.dense_layer.launches = 0
    db.dense_layer.variant_launches = dict.fromkeys(db.ROUTES, 0)


def extraction_inputs(dev):
    """``FrameModel(DenseNet121)`` at 512^2 with seeded random weights in
    flax naming through ``bridge.load_flax``, and EXTRACT_DISTINCT seeded
    uint8 frames."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.inference import build_frame_model

    rng = np.random.default_rng(SEED + 6)
    model = build_frame_model("DenseNet121", 11, DATA_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    frames = rng.integers(0, 256, (EXTRACT_DISTINCT, DATA_SHAPE, DATA_SHAPE, 3),
                          dtype=np.uint8)
    return model, frames


def plain_features(model, frames, dev):
    """f32 backbone features of ``frames`` with every dense layer through
    the plain version (the yardstick, never on the dump's path)."""
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.ops import dense_block as db

    bb = model.backbone
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames).to(dev), bb.dtype)
        return db.densenet_features(bb.spec, bb.operands(), x, bb.dtype,
                                    layer=db.dense_layer_reference).float()


def extract_phase(dev, model, frames):
    """``train.save_features`` at full width: an in-memory split of
    EXTRACT_FRAMES frames through DataLoader -> pinned prefetch_to_device ->
    the dense-layer kernels -> .npy files under a temporary directory."""
    import glob
    import tempfile

    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import make_extract_features
    from tennis_torch.ops import dense_block as db

    extract = make_extract_features(model, dev)

    def dump(ds):
        loader = DataLoader(ds, EXTRACT_BATCH, num_workers=8)
        return driver.save_features(extract, [ds], {ds._split: loader},
                                    dev)[ds._split]

    with tempfile.TemporaryDirectory() as tmp:
        dump(MemorySplit(frames, EXTRACT_BATCH, tmp, "warmup"))
        split = MemorySplit(frames, EXTRACT_FRAMES, tmp, "extract")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_dense_counts(db)
        t0 = time.perf_counter()
        report = dump(split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = db.dense_layer.launches
        by_variant = dict(db.dense_layer.variant_launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        files = glob.glob(os.path.join(tmp, "extract.mp4", "*", "*.npy"))
        bad = [f for f in files
               if (a := np.load(f)).dtype != np.float32 or a.shape != (FEAT_DIM,)
               or not np.isfinite(a).all()]
        errs = {}
        for name, first, n in (("first", 0, EXTRACT_BATCH),
                               ("ragged", EXTRACT_FRAMES // EXTRACT_BATCH
                                * EXTRACT_BATCH, EXTRACT_FRAMES % EXTRACT_BATCH)):
            idx = np.arange(first, first + n)
            got = np.stack([np.load(split.save_feature_path(i)) for i in idx])
            want = plain_features(model, frames[idx % EXTRACT_DISTINCT],
                                  dev).cpu().numpy()
            errs[name] = float(np.abs(got - want).max() / np.abs(want).max())

        # device busy and idle share over PROFILE_BATCHES batches
        small = MemorySplit(frames, PROFILE_BATCHES * EXTRACT_BATCH, tmp,
                            "profile")
        walls = []

        def profiled():
            t = time.perf_counter()
            dump(small)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)

        by_name = device_profile(profiled)
    copy_ms = sum(v[0] for k, v in by_name.items() if k.startswith("Memcpy"))
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    full, ragged = divmod(EXTRACT_FRAMES, EXTRACT_BATCH)
    want_counts = {v: full * n + routed_launches(db, ragged)[v]
                   for v, n in routed_launches(db, EXTRACT_BATCH).items()}
    ok = (len(files) == EXTRACT_FRAMES and not bad
          and launches == 58 * (full + 1) and by_variant == want_counts
          and all(e <= LOGIT_TOL for e in errs.values()))
    log("extract", frames=EXTRACT_FRAMES, batch=EXTRACT_BATCH,
        ragged_batch=ragged, data_shape=DATA_SHAPE, files=len(files),
        bad_files=len(bad), launches=launches, launches_by_variant=by_variant,
        routed_launches_by_variant=want_counts, wall_s=wall,
        frames_per_s=EXTRACT_FRAMES / wall, seconds_in_dump=report["seconds"],
        prefetch=report["prefetch"], copy_wait_s=report["copy_wait_s"],
        write_drain_s=report["write_drain_s"], peak_mem_gib=peak_gib,
        features_rel_err=errs, tol=LOGIT_TOL,
        profile={"frames": PROFILE_BATCHES * EXTRACT_BATCH,
                 "wall_ms": walls[-1], "device_busy_ms": busy_ms,
                 "idle_share": 1 - busy_ms / walls[-1],
                 "memcpy_ms": copy_ms,
                 "device_ms_per_frame": busy_ms / (PROFILE_BATCHES
                                                   * EXTRACT_BATCH),
                 "dense_layer_ms": sum(
                     v[0] for k, v in by_name.items()
                     if any(n in k for n in DENSE_KERNELS.values())),
                 "top": [[k[:60], v[0], v[1]] for k, v in sorted(
                     by_name.items(), key=lambda kv: -kv[1][0])[:8]]},
        ok=ok)
    if not ok:
        raise SystemExit("feature extraction failed its gates")
    return by_variant


def evaluate_phase(dev, model, frames):
    """The in-memory split through ``eval_iter`` and the port's metric set,
    the kernel path's PRF1 against the plain version's; then the
    ``--temp_pool mean`` wrap through the backbone at POOL_BATCH clips of
    POOL_WINDOW frames."""
    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader, eval_iter
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.inference import make_eval_step
    from tennis_torch.ops import dense_block as db

    step = make_eval_step(model, dev)

    def probs_fn(x):
        return torch.softmax(step(x), dim=-1)

    def run(ds, fn, batch):
        rows = {}
        for out, _, idxs in eval_iter(DataLoader(ds, batch, num_workers=8),
                                      fn, dev):
            rows.update(zip(idxs.tolist(), out))
        return np.stack([rows[i] for i in range(len(ds))])

    run(MemorySplit(frames, EXTRACT_BATCH, None, "warmup"), probs_fn,
        EXTRACT_BATCH)
    split = MemorySplit(frames, EXTRACT_FRAMES, None, "evaluate")
    reset_dense_counts(db)
    t0 = time.perf_counter()
    probs = run(split, probs_fn, EXTRACT_BATCH)
    wall = time.perf_counter() - t0
    launches = db.dense_layer.launches
    by_variant = dict(db.dense_layer.variant_launches)
    labels = np.arange(EXTRACT_FRAMES) % 11

    with torch.inference_mode():
        plain = np.concatenate([
            torch.softmax(model.head(plain_features(
                model, frames[i:i + EXTRACT_BATCH], dev)), -1).cpu().numpy()
            for i in range(0, EXTRACT_DISTINCT, EXTRACT_BATCH)])
    plain = plain[np.arange(EXTRACT_FRAMES) % EXTRACT_DISTINCT]
    disagree = int((probs.argmax(-1) != plain.argmax(-1)).sum())
    got_m, want_m = (driver._metric_set(DEFAULT_CLASSES) for _ in range(2))
    for m in got_m.values():
        m.update(labels, probs)
    for m in want_m.values():
        m.update(labels, plain)
    same_prf1 = got_m["prf1"].get() == want_m["prf1"].get()

    # the pooled wrap through the backbone: one forward over the folded clips
    clips = MemorySplit(frames, POOL_BATCH, None, "clips", window=POOL_WINDOW)
    pool_step = make_eval_step(model, dev, pool="mean")
    reset_dense_counts(db)
    pooled = run(clips, pool_step, POOL_BATCH)
    pool_launches = db.dense_layer.launches
    pool_by_variant = dict(db.dense_layer.variant_launches)
    clip_frames = np.stack([clips[i][0] for i in range(POOL_BATCH)])
    feats = plain_features(model, clip_frames.reshape(
        (-1,) + clip_frames.shape[2:]), dev)
    with torch.inference_mode():
        want_pooled = model.head(feats.reshape(POOL_BATCH, POOL_WINDOW, -1)
                                 .to(model.dtype).mean(1)).cpu().numpy()
    pool_rel = float(np.abs(pooled - want_pooled).max()
                     / np.abs(want_pooled).max())
    full, ragged = divmod(EXTRACT_FRAMES, EXTRACT_BATCH)
    want_counts = {v: full * n + routed_launches(db, ragged)[v]
                   for v, n in routed_launches(db, EXTRACT_BATCH).items()}
    pool_want = routed_launches(db, POOL_BATCH * POOL_WINDOW)
    ok = (bool(np.isfinite(probs).all()) and launches == 58 * (full + 1)
          and by_variant == want_counts and (disagree > 0 or same_prf1)
          and pool_launches == 58 and pool_by_variant == pool_want
          and pool_rel <= LOGIT_TOL
          and bool((pooled.argmax(-1) == want_pooled.argmax(-1)).all()))
    log("evaluate", frames=EXTRACT_FRAMES, batch=EXTRACT_BATCH, wall_s=wall,
        frames_per_s=EXTRACT_FRAMES / wall, launches=launches,
        launches_by_variant=by_variant, routed_launches_by_variant=want_counts,
        top1_disagreements=disagree, prf1_equals_plain=same_prf1,
        max_abs_prob_diff=float(np.abs(probs - plain).max()),
        AVG_NB_f1=got_m["prf1"].get_dict()["AVG_NB_f1"],
        pool={"clips": POOL_BATCH, "window": POOL_WINDOW, "pool": "mean",
              "launches": pool_launches, "launches_by_variant": pool_by_variant,
              "routed_launches_by_variant": pool_want,
              "logits_rel_err": pool_rel},
        tol=LOGIT_TOL, ok=ok)
    if not ok:
        raise SystemExit("evaluation failed its gates")
    total = {v: by_variant[v] + pool_by_variant[v] for v in by_variant}
    return total


def train_flops(batch, side=DATA_SHAPE, blocks=(6, 12, 24, 16), classes=11):
    """Model FLOPs of one DenseNet121 train step, counted from the layer
    shapes: every convolution and the head three times its forward
    (forward, input gradient, weight gradient), the stem's twice (its input
    needs no gradient); a remat's recomputation is not counted."""
    s = side // 2
    stem = 2 * batch * s * s * 64 * 3 * 49
    s //= 2
    rest, channels = 0, 64
    for i, n in enumerate(blocks):
        for j in range(n):
            rest += 2 * batch * s * s * ((channels + 32 * j) * 128 + 9 * 128 * 32)
        channels += 32 * n
        if i != len(blocks) - 1:
            rest += 2 * batch * s * s * channels * (channels // 2)
            channels //= 2
            s //= 2
    k = min(7, s)
    rest += 2 * batch * channels * (s // k) ** 2 * classes
    return 2 * stem + 3 * rest


def train_inputs(dev, frames, seed):
    """Seeded random weights (flax naming) of FrameModel(DenseNet121, 11) at
    512^2, ``frames`` on the device, and labels."""
    from tennis_torch.bridge import to_flax
    from tennis_torch.inference import build_frame_model

    rng = np.random.default_rng(seed)
    tree = random_flax_tree(to_flax(build_frame_model(
        "DenseNet121", 11, DATA_SHAPE)), rng)
    images = torch.from_numpy(frames).to(dev)
    labels = torch.from_numpy(rng.integers(0, 11, len(frames))).to(dev)
    return tree, images, labels


def train_state(dev, tree, remat=None, dtype=torch.bfloat16, lr=0.001):
    """A fresh train state of ``tree``'s weights on ``dev`` with the
    driver's default optimizer (at ``lr``), and its step (the device augment
    first)."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.data.transforms import device_augment
    from tennis_torch.inference import build_frame_model
    from tennis_torch.parallel.train_step import create_train_state, \
        make_train_step, sgd_with_schedule

    model = build_frame_model("DenseNet121", 11, DATA_SHAPE, dtype=dtype,
                              remat=remat)
    load_flax(model, tree).to(dev)
    tx, _ = sgd_with_schedule(lr, 0.9, 1e-4, (10, 20), 0.75,
                              DRIVER_TRAIN // TRAIN_BATCH)
    state = create_train_state(model, tx)
    step = make_train_step(state, lambda x, g: device_augment(x, g, dtype),
                           rng_seed=SEED + 123)
    return state, step


def train_phase(dev, frames):
    """The train step at full width: DenseNet121 at 512^2, batch 64, with
    remat none and block; its gates against f32 and between the modes."""
    tree, images, labels = train_inputs(dev, frames, SEED + 8)
    n_batches = len(frames) // TRAIN_BATCH

    def batch(i, size=TRAIN_BATCH):
        lo = i % n_batches * size
        return images[lo:lo + size], labels[lo:lo + size]

    flops = train_flops(TRAIN_BATCH)
    modes, all_finite = {}, True
    for remat in (None, "block"):
        state, step = train_state(dev, tree, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            t0 = time.perf_counter()
            loss, _ = step(*batch(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        walls = []

        def profiled():
            t = time.perf_counter()
            for i in range(TRAIN_PROFILED):
                step(*batch(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)

        by_name = device_profile(profiled)
        busy_ms = sum(v[0] for k, v in by_name.items()
                      if not k.startswith(("Memcpy", "Memset")))
        timed = times[TRAIN_WARMUP:]
        med = statistics.median(timed)
        finite = bool(np.isfinite(losses).all())
        all_finite = all_finite and finite
        modes[remat or "none"] = {
            "first_loss": losses[0], "peak_gib": peak_gib, "step_ms": med}
        log("train", remat=remat or "none", batch=TRAIN_BATCH,
            data_shape=DATA_SHAPE, steps=len(losses), timed_steps=len(timed),
            step_ms=med, step_ms_min=min(timed), step_ms_max=max(timed),
            step_ms_spread=(max(timed) - min(timed)) / med,
            samples_per_s=TRAIN_BATCH / med * 1e3,
            device_busy_ms_per_step=busy_ms / TRAIN_PROFILED,
            idle_share=1 - busy_ms / walls[-1],
            profiled_wall_ms_per_step=walls[-1] / TRAIN_PROFILED,
            device_launches_per_step=sum(v[1] for v in by_name.values())
            / TRAIN_PROFILED,
            top=[[k[:60], v[0] / TRAIN_PROFILED, v[1] // TRAIN_PROFILED]
                 for k, v in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]],
            peak_mem_gib=peak_gib, model_gflop_per_step=flops / 1e9,
            mfu=flops / (med / 1e3) / PEAK_BF16_FLOPS,
            first_losses=losses[:4], last_loss=losses[-1], losses_finite=finite)
        del state, step, by_name

    # 30 steps on one repeated batch (a new augment draw each step)
    state, step = train_state(dev, tree)
    overfit = [step(*batch(0))[0].item() for _ in range(OVERFIT_STEPS)]
    del state, step
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])

    # the first step in bf16 against the same step in f32, at F32_BATCH
    x, y = batch(0, F32_BATCH)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        state, step = train_state(dev, tree, dtype=dtype)
        names = [n for n, _ in state.model.named_parameters()]
        before = [p.detach().clone() for p in state.model.parameters()]
        loss, _ = step(x, y)
        runs[dtype] = (loss.item(), [p.detach() - b for p, b in zip(
            state.model.parameters(), before)],
            [b.clone() for b in state.model.buffers()])
        del state, step, before
    (loss_b, upd_b, stats_b), (loss_f, upd_f, stats_f) = \
        runs[torch.bfloat16], runs[torch.float32]
    loss_rel = abs(loss_b - loss_f) / abs(loss_f)
    stats_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(stats_b, stats_f))
    diff = torch.cat([(a - b).flatten() for a, b in zip(upd_b, upd_f)])
    update_rel = (diff.norm() / torch.cat(
        [b.flatten() for b in upd_f]).norm()).item()
    head = [(a - b).norm() / b.norm() for n, a, b in zip(names, upd_b, upd_f)
            if n.startswith("classes.")]
    remat_rel = abs(modes["block"]["first_loss"] - modes["none"]["first_loss"]) \
        / abs(modes["none"]["first_loss"])
    ok = (all_finite and lowered and loss_rel <= TRAIN_LOSS_TOL
          and stats_rel <= TRAIN_STATS_TOL and update_rel <= TRAIN_UPDATE_TOL
          and remat_rel <= REMAT_LOSS_TOL
          and modes["block"]["peak_gib"] < modes["none"]["peak_gib"])
    log("train_check", losses_finite=all_finite, overfit_losses=overfit,
        overfit_lowered=lowered, f32_batch=F32_BATCH, loss_bf16=loss_b,
        loss_f32=loss_f, loss_rel=loss_rel, loss_tol=TRAIN_LOSS_TOL,
        running_stats_rel=stats_rel, stats_tol=TRAIN_STATS_TOL,
        update_rel_l2=update_rel, update_tol=TRAIN_UPDATE_TOL,
        head_update_rel_l2=max(h.item() for h in head),
        remat_first_loss_rel=remat_rel, remat_tol=REMAT_LOSS_TOL,
        peak_gib={k: v["peak_gib"] for k, v in modes.items()}, ok=ok)
    if not ok:
        raise SystemExit("the train step failed its gates")


def train_driver_phase(dev, frames):
    """``train.fit`` over in-memory splits: 2 epochs of DRIVER_BATCHES
    steps, val after each, the best epoch reloaded and tested; the epoch
    files, each evaluation's kernel launches and logits, and a resumed step
    against the uninterrupted run. Returns the evaluations' dense launches
    by variant."""
    import tempfile
    from unittest import mock

    from tennis_torch import inference
    from tennis_torch import train as driver
    from tennis_torch.bridge import load_flax, state_from_flax
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import build_frame_model
    from tennis_torch.ops import dense_block as db
    from tennis_torch.parallel import train_step as ts
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec

    tree, _, _ = train_inputs(dev, frames[:1], SEED + 9)
    model = build_frame_model("DenseNet121", 11, DATA_SHAPE)
    load_flax(model, tree)
    # lr 0.01: the weights move between evaluations by more than the
    # kernels' distance to the plain version, so a stale fold would show
    args = driver.parse_args([
        "--backbone=DenseNet121", f"--batch_size={TRAIN_BATCH}", "--epochs=2",
        f"--max_batches={DRIVER_BATCHES}", "--log_interval=1", "--lr=0.01"])
    splits = {"train": MemorySplit(frames, DRIVER_TRAIN, None, "train"),
              "val": MemorySplit(frames[::-1], DRIVER_EVAL, None, "val"),
              "test": MemorySplit(frames[1:], DRIVER_EVAL, None, "test")}
    loaders = {k: DataLoader(ds, TRAIN_BATCH, shuffle=k == "train",
                             seed=args.seed, num_workers=8,
                             drop_last=k == "train")
               for k, ds in splits.items()}

    passes, saved, epoch1_first = [], [], {}
    make_eval_step, make_train_step = inference.make_eval_step, \
        ts.make_train_step
    save = ckpt.AsyncCheckpointer.save

    def plain_logits(weights, x):
        """The plain-version forward of a model loaded afresh with
        ``weights``: its BN folded from them, whatever any step cached."""
        from tennis_torch.data.transforms import device_prepare

        ref = build_frame_model("DenseNet121", 11, DATA_SHAPE)
        ref.load_state_dict(weights)
        ref.to(dev)
        with torch.inference_mode():
            return db.frame_model_apply(ref, device_prepare(x, ref.dtype),
                                        layer=db.dense_layer_reference)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    previous = {"weights": {k: v.clone() for k, v in
                            model.state_dict().items()}}

    def recording_eval_step(m, device, **kw):
        """The driver's eval step, recording each pass's launches, and its
        first batch's logits against the plain-version forward of the
        current weights and of the weights of the evaluation before (the
        initial ones for the first)."""
        step = make_eval_step(m, device, **kw)
        record = {"launches": dict.fromkeys(db.ROUTES, 0), "batches": []}
        passes.append(record)

        def wrapped(x):
            before = dict(db.dense_layer.variant_launches)
            out = step(x)
            for v, n in db.dense_layer.variant_launches.items():
                record["launches"][v] += n - before[v]
            record["batches"].append(len(x))
            if "rel_err" not in record:
                weights = {k: v.clone() for k, v in m.state_dict().items()}
                want = plain_logits(weights, x)
                record["rel_err"] = rel(out, want)
                record["previous_weights_rel_err"] = rel(
                    out, plain_logits(previous["weights"], x))
                record["top1_agrees"] = bool(
                    (out.argmax(-1) == want.argmax(-1)).all())
                previous["weights"] = weights
            return out

        return wrapped

    def recording_train_step(state, *a, **kw):
        step = make_train_step(state, *a, **kw)

        def wrapped(images, labels):
            out = step(images, labels)
            if state.step == DRIVER_BATCHES + 1:  # epoch 1's first step
                epoch1_first["params"] = [p.detach().clone() for p in
                                          state.model.parameters()]
                epoch1_first["batch"] = (images.clone(), np.asarray(labels))
            return out

        return wrapped

    def recording_save(self, path, tree):
        saved.append((path, tree))
        return save(self, path, tree)

    with tempfile.TemporaryDirectory() as exp_dir:
        with mock.patch.object(inference, "make_eval_step",
                               recording_eval_step), \
                mock.patch.object(ts, "make_train_step",
                                  recording_train_step), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save):
            reset_dense_counts(db)
            t0 = time.perf_counter()
            state, test_metrics = driver.fit(args, model, loaders, exp_dir,
                                             dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(db.dense_layer.variant_launches)
        files = sorted(f for f in os.listdir(exp_dir) if f != "tb")
        # the files read back as they were saved, momentum included
        identical = len(saved) == 2
        for path, snapshot in saved:
            identical = identical and msgpack_codec.serialize(
                ckpt.load_raw(path)) == msgpack_codec.serialize(snapshot)
        best = ckpt.best_epoch(exp_dir)
        want = driver_state_dict(ckpt.load_raw(ckpt.epoch_path(exp_dir,
                                                               best[0])))
        tested_best = all(np.array_equal(t.cpu().numpy(), want[k])
                          for k, t in state.model.state_dict().items())
        # resume from epoch 0, take epoch 1's first step
        resumed, step = train_state(dev, tree, lr=args.lr)
        state_from_flax(resumed, ckpt.load_raw(ckpt.epoch_path(exp_dir, 0)))
        prev = [p.detach().clone() for p in resumed.model.parameters()]
        step(*epoch1_first["batch"])
        num = sum(((p - q) ** 2).sum() for p, q in zip(
            resumed.model.parameters(), epoch1_first["params"]))
        den = sum(((q - r) ** 2).sum() for q, r in zip(
            epoch1_first["params"], prev))
        resume_rel = (num.sqrt() / den.sqrt()).item()

    full, ragged = divmod(DRIVER_EVAL, TRAIN_BATCH)
    want_pass = {v: full * n + routed_launches(db, ragged)[v]
                 for v, n in routed_launches(db, TRAIN_BATCH).items()}
    # the val passes (not the test, whose best-epoch weights may be the last
    # val's) are nearer their own epoch's weights than the previous ones
    passes_ok = len(passes) == 3 and all(
        r["launches"] == want_pass and r["rel_err"] <= LOGIT_TOL
        and r["top1_agrees"] for r in passes) and all(
        r["rel_err"] < r["previous_weights_rel_err"] for r in passes[:2])
    want_total = {v: 3 * n for v, n in want_pass.items()}
    ok = (files == ["0000.params", "0001.params", "scores.txt"]
          and identical and passes_ok and launches == want_total
          and tested_best and resume_rel <= RESUME_TOL
          and state.step in (DRIVER_BATCHES, 2 * DRIVER_BATCHES))
    log("train_driver", epochs=2, steps_per_epoch=DRIVER_BATCHES,
        batch=TRAIN_BATCH, files=files, saved_read_back_identical=identical,
        evaluations=[{k: r[k] for k in (
            "launches", "batches", "rel_err", "previous_weights_rel_err",
            "top1_agrees")} for r in passes],
        routed_launches_per_evaluation=want_pass, launches=launches,
        best_epoch=best[0], test_on_best_weights=tested_best,
        test_AVG_NB_f1=test_metrics["prf1"].get_dict()["AVG_NB_f1"],
        resume_first_step_rel=resume_rel, resume_tol=RESUME_TOL,
        logit_tol=LOGIT_TOL, wall_s=wall, ok=ok)
    if not ok:
        raise SystemExit("the training driver failed its gates")
    return launches


def driver_state_dict(tree):
    """A train-state tree's parameters and statistics as a torch state
    dict of numpy arrays."""
    from tennis_torch.bridge import from_flax

    return {k: v.numpy() for k, v in from_flax(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}


def _round_trip_us(launch):
    """Microseconds a round of ``launch(iters)`` takes, differenced over two
    loop lengths, so launch cost cancels."""
    short, long_ = 64, 4096
    t_short = time_ms(lambda: launch(short), reps=3)
    t_long = time_ms(lambda: launch(long_), reps=3)
    return (t_long - t_short) / (long_ - short) * 1e3


def cluster_round_trip_us():
    """What chains two steps of the barrier GRU kernel, in microseconds: one
    thread of each CTA of an 8-CTA cluster stores one float into every CTA
    through distributed shared memory, then one cluster barrier."""
    from tennis_torch.ops._build import load_library

    fn = load_library("gru_recurrence").cluster_sync_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.empty(8, device="cuda")

    def run(iters):
        err = fn(iters, 1, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"cluster probe launch failed: CUDA error {err}")

    return _round_trip_us(run)


def exchange_round_trip_us(cluster: int, floats: int):
    """What chains two steps of the async GRU kernel, in microseconds: each
    CTA of a cluster arms its mbarrier, sends ``floats`` floats (the kernel's
    rows x units) into every CTA as 16-byte st.async stores, and waits."""
    from tennis_torch.ops._build import load_library

    fn = load_library("gru_recurrence_async").gru_exchange_probe_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.empty(cluster, device="cuda")

    def run(iters):
        err = fn(iters, floats, cluster, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"exchange probe launch failed: CUDA error {err}")

    return _round_trip_us(run)


def gru_work(T, B, H, lengths):
    """(FLOP, bytes) of one recurrence on these valid lengths: the h.Wh
    product of every live row-step, gates read for live steps, ys written
    whole, Wh, bh, h0, h_final and the lengths once."""
    live = sum(lengths)
    flops = 2 * live * H * 3 * H
    nbytes = 4 * (live * 3 * H + T * B * H + H * 3 * H + 3 * H + 2 * B * H + B)
    return flops, nbytes


def gru_runs(gru, H, B):
    """(key, variant, cluster) of every GRU kernel configuration that takes
    (H, B): the barrier kernel where it fits, the async one at every
    cluster size whose plan exists."""
    runs = [("barrier", "barrier", None)] if gru.barrier_fits(H, B) else []
    return runs + [(f"async{c}", "async", c) for c in gru.ASYNC_CLUSTERS
                   if gru.gru_plan(H, B, c) is not None]


def gru_phase(dev):
    """Both GRU kernels against their plain version at every GRU_CASES
    shape, with their times beside the port's whole layer and cuDNN's
    nn.GRU over the same full-length layer from FEAT_DIM features. Returns
    the worst error of each variant and the per-case rows."""
    from tennis_torch.ops import gru

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    barrier_us = cluster_round_trip_us()
    rows, worst = {}, dict.fromkeys(gru.VARIANTS, 0.0)
    for name, T, B, H, lengths in GRU_CASES:
        def rand(*shape, std=1.0):
            return torch.empty(shape, device=dev).normal_(0.0, std, generator=gen)

        x = rand(T, B, FEAT_DIM)
        wx, bx = rand(FEAT_DIM, 3 * H, std=FEAT_DIM ** -0.5), rand(3 * H, std=0.1)
        wh, bh = rand(H, 3 * H, std=H ** -0.5), rand(3 * H, std=0.1)
        h0 = rand(B, H, std=0.5)
        vl = torch.tensor(lengths, dtype=torch.int32, device=dev)
        full = torch.full((B,), T, dtype=torch.int32, device=dev)
        gx = torch.matmul(x, wx) + bx
        routed = gru.gru_route(T, B, H)
        plan = gru.gru_plan(H, B)
        routed_key = f"async{plan.cluster}" if routed == "async" else routed
        t_live = max(min(max(n, 0), T) for n in lengths)
        by_key, ok = {}, True
        with torch.inference_mode():
            ys_ref, h_ref = gru.gru_recurrence_reference(gx, h0, wh, bh, vl)
            for key, variant, c in gru_runs(gru, H, B):
                def call(variant=variant, c=c):
                    return gru.gru_recurrence(gx, h0, wh, bh, vl, variant, c)

                ys, h = call()
                torch.cuda.synchronize()
                err = max((ys - ys_ref).abs().max().item(),
                          (h - h_ref).abs().max().item())
                finite = bool(torch.isfinite(ys).all() and torch.isfinite(h).all())
                frozen = all(not ys[n:, b].any() for b, n in enumerate(lengths))
                v_ok = finite and frozen and err <= GRU_TOL
                ok = ok and v_ok
                worst[variant] = max(worst[variant], err)
                device_ms = kernel_device(call, GRU_KERNELS[variant],
                                          launches=1)[0]
                steps = T if variant == "barrier" else t_live
                by_key[key] = {"max_abs_err": err, "finite": finite,
                               "zero_past_length": frozen, "ok": v_ok,
                               "ms": time_ms(call, reps=20),
                               "device_ms": device_ms, "steps": steps,
                               "us_per_step": device_ms / max(steps, 1) * 1e3}
            plain_ms = time_ms(
                lambda: gru.gru_recurrence_reference(gx, h0, wh, bh, vl),
                reps=1, rounds=3)
            layer_ms = time_ms(
                lambda: gru.gru_sequence(x, h0, wx, wh, bx, bh, full), reps=20)
            lib = torch.nn.GRU(FEAT_DIM, H).to(dev)
            for p, v in ((lib.weight_ih_l0, wx.t()), (lib.weight_hh_l0, wh.t()),
                         (lib.bias_ih_l0, bx), (lib.bias_hh_l0, bh)):
                p.copy_(v)
            ys_lib, _ = lib(x, h0[None])
            ys_layer, _ = gru.gru_sequence(x, h0, wx, wh, bx, bh, full)
            lib_err = (ys_lib - ys_layer).abs().max().item()
            library_ms = time_ms(lambda: lib(x, h0[None]), reps=20)
        exchange_us = exchange_round_trip_us(plan.cluster, plan.rows * plan.units)
        flops, nbytes = gru_work(T, B, H, lengths)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        fastest = min(by_key, key=lambda k: by_key[k]["device_ms"])
        row = {"ms": by_key[routed_key]["ms"],
               "device_ms": by_key[routed_key]["device_ms"],
               "plain_ms": plain_ms, "layer_ms": layer_ms,
               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "serial_floor_ms": t_live * exchange_us / 1e3,
               "barrier_serial_floor_ms": T * barrier_us / 1e3}
        log("gru_kernel", case=name, T=T, batch=B, hidden=H, lengths=lengths,
            live_steps=t_live, tol=GRU_TOL, routed=routed_key, fastest=fastest,
            routed_over_fastest=by_key[routed_key]["device_ms"]
            / by_key[fastest]["device_ms"], variants=by_key,
            plan=plan._asdict(), gflop=flops / 1e9, mbytes=nbytes / 1e6,
            cluster_round_trip_us=barrier_us, exchange_round_trip_us=exchange_us,
            library_vs_layer_full_length_err=lib_err, ok=ok, **row)
        if not ok:
            raise SystemExit(f"a gru_recurrence kernel disagrees with its plain "
                             f"version at {name}")
        rows[name] = {**row, "variants": by_key}
    return worst, rows


@contextlib.contextmanager
def plain_gru():
    """Route RNNLayer's GRU recurrences inside the decode context through
    the kernel's plain version (the yardstick of the caption-path gates;
    never on the served path)."""
    from tennis_torch.ops import gru, rnn

    rnn.gru_recurrence = gru.gru_recurrence_reference
    try:
        yield
    finally:
        rnn.gru_recurrence = gru.gru_recurrence


def rescore(model, enc, src_vl, samples, scores, lengths, info):
    """Largest |reported - rescored| over the batch's top beams: each top
    beam fed teacher-forced through the decoder from ``enc``, its log-prob
    summed over the tokens the search scored and length-penalized as the
    search does."""
    alpha, K, max_length = info["lp_alpha"], info["lp_k"], info["max_length"]
    top = samples[:, 0].long()
    # a beam cut at max_length carries one unscored trailing EOS
    n = torch.clamp(lengths[:, 0] - 1, max=max_length)
    states = model.init_decoder_state(enc, src_vl)
    out, _ = model.decoder(model.tgt_embed(top[:, :-1]), states)
    logp = torch.log_softmax(model.tgt_proj(out).float(), -1)
    logp = logp.gather(-1, top[:, 1:, None])[..., 0]
    scored = torch.arange(logp.shape[1], device=logp.device)[None] < n[:, None]
    cum = torch.where(scored, logp, torch.zeros_like(logp)).sum(1)
    rescored = cum / ((K + n.float()) / (K + 1)) ** alpha
    return (rescored - scores[:, 0]).abs().max().item()


def caption_phase(dev):
    """The 0102 captioner served over HTTP: POST /caption through the
    port's make_service, the encoder's three GRU recurrences per batch
    through the kernel."""
    import io
    from collections import Counter
    from http.server import ThreadingHTTPServer

    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.vocab import Vocab
    from tennis_torch.inference import make_captioner
    from tennis_torch.ops import gru, rnn
    from tennis_torch.ops.beam_search import beam_search
    from tennis_torch.serve import Captioner, make_service
    from tennis_torch.train_gnmt import build_model, parse_args

    rng = np.random.default_rng(SEED + 3)
    args = parse_args(CAPTION_ARGV)
    vocab = Vocab(Counter({f"w{i:03d}": VOCAB_WORDS - i
                           for i in range(VOCAB_WORDS)}))
    model = build_model(args, len(vocab), FEAT_DIM,
                        generator=torch.Generator().manual_seed(SEED))
    load_flax(model, random_flax_tree(to_flax(model), rng))
    info = {"feat_dim": FEAT_DIM, "src_max_len": SRC_MAX_LEN,
            "beam_size": args.beam_size, "lp_alpha": args.lp_alpha,
            "lp_k": args.lp_k, "max_length": args.tgt_max_len + 20}
    torch.cuda.reset_peak_memory_stats()
    translator, caption_batch = make_captioner(model, vocab, info, dev)
    handler, _ = make_service(None, None, BATCH, DATA_SHAPE, max_wait_ms=200,
                              captioner=Captioner(caption_batch, FEAT_DIM,
                                                  SRC_MAX_LEN, CAPTION_BATCH))
    batcher = handler.caption_batcher
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    lens = rng.integers(20, SRC_MAX_LEN + 1, N_CAPTIONS)
    feats = [rng.standard_normal((n, FEAT_DIM)).astype(np.float32) for n in lens]
    try:
        results = [None] * N_CAPTIONS

        def request(i):
            buf = io.BytesIO()
            np.save(buf, feats[i])
            req = urllib.request.Request(url + "/caption", data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())

        batches0 = batcher.batches
        gru.gru_recurrence.launches = 0
        gru.gru_recurrence.variant_launches = dict.fromkeys(gru.VARIANTS, 0)
        start = time.perf_counter()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(N_CAPTIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - start
        launches = gru.gru_recurrence.launches
        by_variant = dict(gru.gru_recurrence.variant_launches)
        batches = batcher.batches - batches0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    if any(r is None for r in results):
        raise SystemExit("not every caption request was answered")
    in_vocab = all(tok in vocab for r in results for tok in r["tokens"])
    used_ok = all(r["frames_used"] == n for r, n in zip(results, lens))
    if not (in_vocab and used_ok):
        raise SystemExit(f"bad captions: in_vocab={in_vocab} "
                         f"frames_used_ok={used_ok}")
    routed = gru.gru_route(SRC_MAX_LEN, CAPTION_BATCH, args.num_hidden)
    if batches < 1 or launches != 3 * batches or \
            by_variant[routed] != launches:
        raise SystemExit(f"{launches} GRU launches ({by_variant}) for "
                         f"{batches} caption batches, expected 3 per batch "
                         f"through the {routed} kernel")
    if health["status"] != "ok" or health["caption_requests"] < N_CAPTIONS:
        raise SystemExit(f"healthz: {health}")

    # one served batch, as the batcher hands it to caption_batch
    src_np = np.zeros((CAPTION_BATCH, SRC_MAX_LEN, FEAT_DIM), np.float32)
    for b in range(CAPTION_BATCH):
        src_np[b, :lens[b]] = feats[b]
    vl_np = lens[:CAPTION_BATCH].astype(np.int32)
    src = torch.from_numpy(src_np).to(dev)
    src_vl = torch.from_numpy(vl_np).to(dev)

    # gates (comparison runs, after the counts were read)
    with torch.inference_mode():
        with rnn.gru_decode():
            mem_k, st_k = model.encode(src, src_vl)
        with plain_gru(), rnn.gru_decode():
            enc_p = model.encode(src, src_vl)
        mem_p, st_p = enc_p
        enc_err = max([(mem_k - mem_p).abs().max().item()]
                      + [(a - b).abs().max().item() for a, b in zip(st_k, st_p)])
        samples, scores, lengths = translator.translate_tensors(src, src_vl)
        rescore_err = rescore(model, enc_p, src_vl, samples, scores, lengths,
                              info)
        with plain_gru():
            samples_p, _, _ = translator.translate_tensors(src, src_vl)
        same_top = [bool(torch.equal(samples[b, 0], samples_p[b, 0]))
                    for b in range(CAPTION_BATCH)]
        same_beams = [bool(torch.equal(samples[b], samples_p[b]))
                      for b in range(CAPTION_BATCH)]
        torch.cuda.synchronize()

    # latency of one batch through the entry point, and its split
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        caption_batch(src_np, vl_np)
        lat.append((time.perf_counter() - t0) * 1e3)
    latency_ms = statistics.median(lat)
    enc_ms, dec_ms, steps = [], [], []
    for _ in range(10):
        calls = [0]

        def step(tokens, states):
            calls[0] += 1
            return model.decode_step(tokens, states)

        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rnn.gru_decode():
                states = model.init_decoder_state(model.encode(src, src_vl),
                                                  src_vl)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            beam_search(step, states, CAPTION_BATCH, info["beam_size"],
                        vocab[vocab.bos_token], vocab[vocab.eos_token],
                        info["max_length"], info["lp_alpha"], info["lp_k"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        enc_ms.append((t1 - t0) * 1e3)
        dec_ms.append((t2 - t1) * 1e3)
        steps.append(calls[0])
    kernels = device_profile(lambda: caption_batch(src_np, vl_np))
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("caption_breakdown", batch=CAPTION_BATCH, lengths=vl_np.tolist(),
        latency_ms=latency_ms, encode_ms=statistics.median(enc_ms),
        decode_loop_ms=statistics.median(dec_ms), decode_steps=steps[0],
        decode_ms_per_step=statistics.median(dec_ms) / max(steps[0], 1),
        device_busy_ms=busy_ms, idle_share=1 - busy_ms / latency_ms,
        device_launches=sum(v[1] for v in kernels.values()),
        gru_kernel_ms=sum(v[0] for k, v in kernels.items()
                          if any(n in k for n in GRU_KERNELS.values())),
        top=[[k[:60], v[0], v[1]] for k, v in top])
    ok = enc_err <= GRU_TOL and rescore_err <= RESCORE_TOL
    log("caption_path", requests=N_CAPTIONS, frames=lens.tolist(),
        batches=batches, launches=launches, launches_by_variant=by_variant,
        launches_per_batch=launches / batches, wall_s=wall, healthz=health,
        vocab=len(vocab), tokens_per_caption=[len(r["tokens"]) for r in results],
        first_caption=results[0]["caption"][:80],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        encoder_max_abs_err=enc_err, encoder_tol=GRU_TOL,
        rescore_max_abs_err=rescore_err, rescore_tol=RESCORE_TOL,
        top_beam_equal_to_plain_encoder=same_top,
        all_beams_equal_to_plain_encoder=same_beams, ok=ok)
    if not ok:
        raise SystemExit("caption path disagrees with its plain-version "
                         "encoder")
    return by_variant


class MemoryCaptionSplit:
    """An in-memory captions-mode split with what ``train_gnmt`` and the
    bucketed loader read of a TennisSet: ``vocab``, ``(features, caption
    ids, frames, ids[, idx])`` items, ``get_captions``, ``get_data_lens``
    and ``stats``. Point i has CAP_SRC_LEN frames of f32 features drawn from
    (SEED, ``offset``, i) and a caption of CAP_IDS_LEN ids over the
    vocabulary's words, both lengths uniform."""

    def __init__(self, vocab, n, offset, inference):
        from concurrent.futures import ThreadPoolExecutor

        from tennis_torch.data.tennis_set import caption_ids

        rng = np.random.default_rng([SEED, offset])
        self.vocab, self.inference, self._split = vocab, inference, offset
        frames = rng.integers(CAP_SRC_LEN[0], CAP_SRC_LEN[1] + 1, n)
        words = rng.integers(CAP_IDS_LEN[0] - 2, CAP_IDS_LEN[1] - 1, n)
        self.captions = [" ".join(vocab.idx_to_token[4 + int(w)] for w in
                                  rng.integers(0, VOCAB_WORDS, k))
                         for k in words]
        self.ids = [caption_ids(vocab, c) for c in self.captions]

        def draw(i):
            return np.random.default_rng([SEED, offset, i]).standard_normal(
                (int(frames[i]), FEAT_DIM), dtype=np.float32)

        with ThreadPoolExecutor(8) as pool:
            self.feats = list(pool.map(draw, range(n)))

    def __len__(self):
        return len(self.feats)

    def __getitem__(self, i):
        item = (self.feats[i], self.ids[i], len(self.feats[i]),
                len(self.ids[i]))
        return item + (i,) if self.inference else item

    def get_captions(self, ids=False, split=False):
        if ids:
            return list(self.ids)
        return [c.split() if split else c for c in self.captions]

    def get_data_lens(self):
        return [(len(f), len(c)) for f, c in zip(self.feats, self.ids)]

    def stats(self):
        return (f"in-memory split {self._split}: {len(self)} points, "
                f"{sum(len(f) for f in self.feats)} frames")


def caption_train_inputs():
    """The vocabulary (4 specials + VOCAB_WORDS words), the three in-memory
    splits and seeded random weights (flax naming) of the 0102 captioner."""
    from collections import Counter

    from tennis_torch.bridge import to_flax
    from tennis_torch.data.vocab import Vocab
    from tennis_torch.train_gnmt import build_model, parse_args

    vocab = Vocab(Counter({f"w{i:03d}": VOCAB_WORDS - i
                           for i in range(VOCAB_WORDS)}))
    splits = {name: MemoryCaptionSplit(vocab, n, k, name != "train")
              for k, (name, n) in enumerate(CAP_POINTS.items())}
    model = build_model(parse_args(CAP_TRAIN_ARGV), len(vocab), FEAT_DIM)
    tree = random_flax_tree(to_flax(model), np.random.default_rng(SEED + 10))
    return vocab, splits, tree


def caption_model(args, vocab, tree, dev, dropout=None):
    """The captioner the flags describe with ``tree``'s weights, on
    ``dev``; ``dropout`` overrides ``--dropout``."""
    import argparse

    from tennis_torch.bridge import load_flax
    from tennis_torch.train_gnmt import build_model

    if dropout is not None:
        args = argparse.Namespace(**{**vars(args), "dropout": dropout})
    model = build_model(args, len(vocab), FEAT_DIM)
    return load_flax(model, tree).to(dev)


def caption_train_phase(dev, vocab, splits, tree):
    """The captioner's train step at --batch_size 128 through
    make_seq2seq_train_step over the bucketed batches of the train split:
    times, rates, the device's share, launches; gates: finite losses, a
    repeated batch learnt, the first step's loss and gradients on the card
    against the CPU at dropout 0, the differentiable recurrence against the
    GRU kernel, and no GRU kernel launch in a train step."""
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.ops import gru, rnn
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step
    from tennis_torch.train_gnmt import make_loader, parse_args

    args = parse_args(CAP_TRAIN_ARGV)

    def fresh():
        model = caption_model(args, vocab, tree, dev)
        state = create_seq2seq_state(
            model, adam_with_clip(args.clip, args.optimizer), args.lr)
        return state, make_seq2seq_train_step(state, masked_ce_loss)

    host = list(make_loader(args, splits["train"], "train"))
    batches = [tuple(torch.from_numpy(x).to(dev) for x in b) for b in host]
    shapes = [list(b[0].shape[:2]) + [b[1].shape[1]] for b in batches]
    seeds = np.random.default_rng(args.seed + 1)
    state, step = fresh()
    launches0 = gru.gru_recurrence.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, tokens, frames = [], [], [], []
    for i in range(CAP_WARMUP + CAP_TIMED):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        loss = step(*b, seeds.integers(2 ** 31))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        tokens.append(float(b[3].sum()))
        frames.append(float(b[2].sum()))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = []

    def profiled():
        t = time.perf_counter()
        for i in range(CAP_PROFILED):
            step(*batches[i], seeds.integers(2 ** 31))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    by_name = device_profile(profiled)
    gru_in_step = sum(v[1] for k, v in by_name.items()
                      if any(n in k for n in GRU_KERNELS.values()))
    step_launches = gru.gru_recurrence.launches - launches0
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    timed = times[CAP_WARMUP:]
    med = statistics.median(timed)
    finite = bool(np.isfinite(losses).all())
    log("caption_train", batch=args.batch_size, batches_per_epoch=len(batches),
        batch_shapes_B_T_L=shapes, steps=len(losses), timed_steps=len(timed),
        step_ms=med, step_ms_min=min(timed), step_ms_max=max(timed),
        step_ms_spread=(max(timed) - min(timed)) / med,
        target_tokens_per_s=sum(tokens[CAP_WARMUP:]) / sum(timed) * 1e3,
        source_frames_per_s=sum(frames[CAP_WARMUP:]) / sum(timed) * 1e3,
        profiled_shapes=shapes[:CAP_PROFILED],
        device_busy_ms_per_step=busy_ms / CAP_PROFILED,
        idle_share=1 - busy_ms / walls[-1],
        profiled_wall_ms_per_step=walls[-1] / CAP_PROFILED,
        device_launches_per_step=sum(v[1] for v in by_name.values())
        / CAP_PROFILED,
        top=[[k[:60], v[0] / CAP_PROFILED, v[1] // CAP_PROFILED]
             for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
        peak_mem_gib=peak_gib, first_losses=losses[:4], last_loss=losses[-1],
        losses_finite=finite, gru_kernel_launches_in_steps=step_launches,
        gru_kernel_launches_profiled=gru_in_step)
    del state, step, by_name

    # 30 steps on one repeated batch (the shortest), new dropout masks each
    short = min(range(len(batches)), key=lambda i: shapes[i][1])
    state, step = fresh()
    overfit = [step(*batches[short], seeds.integers(2 ** 31)).item()
               for _ in range(OVERFIT_STEPS)]
    del state, step
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])

    # the first step's loss and gradients, card against CPU, dropout 0
    sub = [x[:CAP_CPU_ROWS] for x in batches[short]]
    runs = []
    for device in (dev, torch.device("cpu")):
        model = caption_model(args, vocab, tree, device, dropout=0.0).train()
        src, tgt, svl, tvl = (x.to(device) for x in sub)
        loss = masked_ce_loss(model(src, tgt[:, :-1], svl, tvl - 1),
                              tgt[:, 1:], tvl - 1)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((loss.item(), [g.cpu() for g in grads]))
        del model
    (loss_c, g_c), (loss_h, g_h) = runs
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    grad_rel = (torch.cat([(a - b).flatten() for a, b in zip(g_c, g_h)]).norm()
                / torch.cat([b.flatten() for b in g_h]).norm()).item()

    # the differentiable recurrence against the kernel, the same operands
    layer = caption_model(args, vocab, tree, dev).encoder.rnn0.fwd
    x, _, x_vl, _ = batches[0]
    with torch.inference_mode():
        final_p, ys_p = layer(x, x_vl)
        with rnn.gru_decode():
            final_k, ys_k = layer(x, x_vl)
        torch.cuda.synchronize()
    rec_err = max((ys_p - ys_k).abs().max().item(),
                  (final_p - final_k).abs().max().item())
    del layer

    ok = (finite and lowered and loss_rel <= CAP_LOSS_TOL
          and grad_rel <= CAP_GRAD_TOL and rec_err <= GRU_TOL
          and step_launches == 0 and gru_in_step == 0)
    log("caption_train_check", losses_finite=finite, overfit_losses=overfit,
        overfit_lowered=lowered, cpu_rows=CAP_CPU_ROWS,
        cpu_shape=list(sub[0].shape[:2]), loss_card=loss_c, loss_cpu=loss_h,
        loss_rel=loss_rel, loss_tol=CAP_LOSS_TOL, grad_rel_l2=grad_rel,
        grad_tol=CAP_GRAD_TOL, recurrence_vs_kernel_max_abs=rec_err,
        recurrence_shape=list(x.shape[:2]), gru_tol=GRU_TOL,
        gru_kernel_launches_in_train_steps=step_launches + gru_in_step, ok=ok)
    if not ok:
        raise SystemExit("the captioner's train step failed its gates")


def caption_driver_phase(dev, vocab, splits, tree):
    """``train_gnmt.train`` for 2 epochs over the in-memory splits, then a
    resumed run to 3 epochs, then ``evaluate_gnmt.evaluate --force
    --metrics_out``, from ``tree`` with EOS biased by CAP_EOS_BIAS: every
    decode batch runs the translator's max length and makes 3 GRU kernel
    launches by the routed variant, the first evaluation's encoder outputs
    agree with the plain version, the epoch files read back as saved, the
    resumed run compounds the decay from the saved rate, the evaluator
    rewrites the trainer's best_test_out.txt byte for byte. Returns the
    decodes' GRU launches by variant."""
    import logging
    import tempfile
    from unittest import mock

    from tennis_torch import evaluate_gnmt, train_gnmt
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import NMTModel
    from tennis_torch.ops import gru, rnn
    from tennis_torch.translation import BeamSearchTranslator
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec

    argv = CAP_TRAIN_ARGV + ["--model_id=cap", "--log_interval=1"]
    build, translate = train_gnmt.build_model, \
        BeamSearchTranslator.translate_tokens
    save = ckpt.AsyncCheckpointer.save
    decode_step = NMTModel.decode_step
    flags = train_gnmt.parse_args(argv)
    H, max_steps = flags.num_hidden, flags.tgt_max_len + 20
    bias = tree["params"]["tgt_proj"]["bias"].copy()
    bias[vocab[vocab.eos_token]] = CAP_EOS_BIAS
    tree = {**tree, "params": {**tree["params"], "tgt_proj": {
        **tree["params"]["tgt_proj"], "bias": bias}}}
    decodes, saved, lines = [], [], []
    first_eval = {"batches": None}
    steps = [0]

    def seeded_build(args, vocab_size, feat_dim, generator=None):
        return load_flax(build(args, vocab_size, feat_dim, generator), tree)

    def counting_decode_step(self, *a, **kw):
        steps[0] += 1
        return decode_step(self, *a, **kw)

    def recording_translate(self, src, src_valid_length, vocab_):
        B, T = src.shape[:2]
        before = dict(gru.gru_recurrence.variant_launches)
        steps0 = steps[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = translate(self, src, src_valid_length, vocab_)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"T": T, "B": B, "ms": ms, "steps": steps[0] - steps0,
               "routed": gru.gru_route(T, B, H),
               "launches": {v: n - before[v] for v, n in
                            gru.gru_recurrence.variant_launches.items()}}
        if first_eval["batches"] is None or len(decodes) < first_eval["batches"]:
            # the first evaluation's batches (the first and the ragged ones)
            vl = torch.as_tensor(src_valid_length, device=dev).to(torch.int32)
            with torch.inference_mode():
                with rnn.gru_decode():
                    mem_k, st_k = self._model.encode(src, vl)
                with plain_gru(), rnn.gru_decode():
                    mem_p, st_p = self._model.encode(src, vl)
                torch.cuda.synchronize()
            rec["encoder_max_abs_err"] = max(
                [(mem_k - mem_p).abs().max().item()]
                + [(a - b).abs().max().item() for a, b in zip(st_k, st_p)])
            rec["profile"] = (self, src, src_valid_length)
        decodes.append(rec)
        return out

    def recording_save(self, path, tree_):
        saved.append((path, tree_))
        return save(self, path, tree_)

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logging.getLogger().addHandler(handler)
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as work, \
                mock.patch.object(train_gnmt, "build_model", seeded_build), \
                mock.patch.object(BeamSearchTranslator, "translate_tokens",
                                  recording_translate), \
                mock.patch.object(NMTModel, "decode_step",
                                  counting_decode_step), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save):
            os.chdir(work)
            datasets = (splits["train"], splits["val"], splits["test"])
            first_eval["batches"] = len(train_gnmt.make_loader(
                flags, splits["val"], "val"))
            t0 = time.perf_counter()
            train_gnmt.train(train_gnmt.parse_args(argv + ["--epochs=2"]),
                             datasets)
            wall_2 = time.perf_counter() - t0
            exp = os.path.join("models", "captioning", "experiments", "cap")
            identical = len(saved) >= 2 and all(
                msgpack_codec.serialize(ckpt.load_raw(p))
                == msgpack_codec.serialize(t) for p, t in saved)
            saved_lr = float(ckpt.load_raw(ckpt.epoch_path(exp, 1))[
                "opt_state"]["hyperparams"]["learning_rate"])
            n_first = len(lines)
            t0 = time.perf_counter()
            train_gnmt.train(train_gnmt.parse_args(argv + ["--epochs=3"]),
                             datasets)
            wall_3 = time.perf_counter() - t0
            resumed = lines[n_first:]
            with open(os.path.join(exp, "best_test_out.txt"), "rb") as f:
                best_out = f.read()
            metrics_path = os.path.join(work, "metrics.json")
            n_train_decodes = len(decodes)
            t0 = time.perf_counter()
            suite = evaluate_gnmt.evaluate(evaluate_gnmt.parse_args(
                argv + ["--force", f"--metrics_out={metrics_path}"]),
                datasets)
            wall_eval = time.perf_counter() - t0
            with open(os.path.join(exp, "best_test_out.txt"), "rb") as f:
                rewritten = f.read() == best_out
            with open(metrics_path) as f:
                dumped = json.load(f)
            files = sorted(os.listdir(exp))
            self_, src, src_vl = decodes[0]["profile"]
            wall = []

            def one_decode():
                t = time.perf_counter()
                translate(self_, src, src_vl, vocab)
                wall.append((time.perf_counter() - t) * 1e3)

            by_name = device_profile(one_decode)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(handler)

    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    launches = dict.fromkeys(gru.VARIANTS, 0)
    for r in decodes:
        for v, n in r["launches"].items():
            launches[v] += n
    per_batch_ok = all(r["launches"] == {**dict.fromkeys(gru.VARIANTS, 0),
                                         r["routed"]: 3} for r in decodes)
    enc = [r["encoder_max_abs_err"] for r in decodes
           if "encoder_max_abs_err" in r]
    resume_line = f"resumed from epoch 1 (lr {saved_lr:g})"
    after = [float(m.rsplit(" ", 1)[1]) for m in resumed
             if m.startswith("lr decayed to")]
    resume_ok = resume_line in resumed and len(after) == 1 and \
        abs(after[0] / (saved_lr * 0.5) - 1) < 1e-5
    want_keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                 "CIDEr"}
    metrics_ok = set(dumped) == want_keys and all(
        0.0 <= v <= (10.0 if k == "CIDEr" else 1.0)
        for k, v in dumped.items()) and dumped == suite
    want_files = {"0000.params", "0001.params", "0002.params", "scores.txt",
                  "valid_best.params", "best_test_out.txt", "val_gt.txt",
                  "test_gt.txt", "epoch2_test_out.txt"}
    full_length = all(r["steps"] == max_steps for r in decodes)
    ok = (per_batch_ok and full_length and enc and max(enc) <= GRU_TOL
          and identical
          and resume_ok and rewritten and metrics_ok
          and want_files <= set(files))
    dec_ms = [r["ms"] for r in decodes]
    step_ms = [r["ms"] / r["steps"] for r in decodes]
    log("caption_driver", epochs=[2, 3], train_points=CAP_POINTS["train"],
        eval_points=CAP_POINTS["val"],
        test_batch=flags.test_batch_size, eos_bias=CAP_EOS_BIAS,
        decodes=len(decodes), decodes_in_training=n_train_decodes,
        decode_shapes_B_T=[[r["B"], r["T"]] for r in decodes],
        launches=launches, launches_per_decode_ok=per_batch_ok,
        routed=sorted({r["routed"] for r in decodes}),
        encoder_max_abs_err=enc, gru_tol=GRU_TOL,
        decode_steps=sorted({r["steps"] for r in decodes}),
        max_steps=max_steps, full_length=full_length,
        decode_ms_median=statistics.median(dec_ms), decode_ms_min=min(dec_ms),
        decode_ms_max=max(dec_ms),
        decode_ms_per_step_median=statistics.median(step_ms),
        decode_profiled_B_T=[decodes[0]["B"], decodes[0]["T"]],
        decode_device_busy_ms=busy_ms, decode_wall_ms=wall[-1],
        decode_idle_share=1 - busy_ms / wall[-1],
        decode_device_launches=sum(v[1] for v in by_name.values()),
        wall_s_per_epoch=wall_2 / 2, resumed_epoch_wall_s=wall_3,
        evaluate_wall_s=wall_eval, saved_read_back_identical=identical,
        saved_files=len(saved), resumed_lr_line=resume_line,
        decays_after_resume=after, resume_ok=resume_ok,
        evaluate_rewrites_best_test_out=rewritten, metrics=dumped,
        metrics_ok=metrics_ok, files=files, ok=ok)
    if not ok:
        raise SystemExit("the captioning driver failed its gates")
    return launches


def densenet161_phase(dev):
    """FrameModel(DenseNet161) at 224^2 with seeded random weights: its
    batch-2 warm-up forward through make_service takes every dense layer
    through dense_layer_convs and no dense kernel, and its logits agree with
    the plain-version forward."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import build_frame_model, make_predict_probs
    from tennis_torch.ops import dense_block as db
    from tennis_torch.serve import make_service

    rng = np.random.default_rng(SEED + 5)
    classes = list(DEFAULT_CLASSES)
    model = build_frame_model("DenseNet161", len(classes), D161_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    predict_probs = make_predict_probs(model, dev)
    reset_dense_counts(db)
    t0 = time.perf_counter()
    make_service(classes, predict_probs, D161_BATCH, D161_SHAPE)  # warm-up
    warm_s = time.perf_counter() - t0
    launches = db.dense_layer.launches
    by_variant = dict(db.dense_layer.variant_launches)
    n_layers = sum(model.backbone.spec.block_config)
    want_counts = {**dict.fromkeys(db.ROUTES, 0), "convs": n_layers}
    if n_layers != 78 or launches != 0 or by_variant != want_counts:
        raise SystemExit(f"DenseNet161 warm-up: {launches} dense-kernel "
                         f"launches, {by_variant} by route; expected none and "
                         f"{n_layers} (78) through dense_layer_convs")
    frames = rng.integers(0, 256, (D161_BATCH, D161_SHAPE, D161_SHAPE, 3),
                          dtype=np.uint8)
    probs = predict_probs(frames)
    lat = []
    for _ in range(10):
        t1 = time.perf_counter()
        predict_probs(frames)
        lat.append((time.perf_counter() - t1) * 1e3)
    busy_ms = sum(v[0] for v in device_profile(
        lambda: predict_probs(frames)).values())
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames).to(dev))
        got = db.frame_model_apply(model, x)
        want = db.frame_model_apply(model, x, layer=db.dense_layer_reference)
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    finite = bool(np.isfinite(probs).all()) and probs.shape == (
        D161_BATCH, len(classes))
    ok = finite and rel <= LOGIT_TOL and top1
    log("densenet161", batch=D161_BATCH, data_shape=D161_SHAPE,
        dense_layers=n_layers, kernel_launches=launches,
        launches_by_route=by_variant, warm_up_s=warm_s,
        latency_ms=statistics.median(lat), device_busy_ms=busy_ms,
        logits_rel_err=rel, logit_tol=LOGIT_TOL, top1_agrees=top1,
        finite=finite, ok=ok)
    if not ok:
        raise SystemExit("DenseNet161 forward disagrees with its plain-version "
                         "forward")
    return by_variant


def build_phase():
    """nvcc of every kernel, all started together."""
    from tennis_torch.ops import _build

    errors = {}

    def go(name):
        try:
            _build.build(name)
        except Exception as e:  # reported below, the run fails
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(n,)) for n in KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise SystemExit(f"kernel build failed: {errors}")
    for name in KERNELS:
        seconds, report = _build.build_info[name]
        log("build", kernel=name, seconds=seconds, wall_s=wall,
            ptxas=[l.strip() for l in report.splitlines()
                   if "registers" in l or "spill" in l or "smem" in l])


def dense_entry(name, variant, stack, launches, max_abs):
    """The kernels-line entry of one dense-layer variant over the layers of
    the 58-layer stack that the route sends to it; for a kernel that the
    route sends nothing, over blocks 2 and 3 (the small maps) run through
    it alone."""
    rows, layer_rows, routed_device = stack
    mine = [r for r in layer_rows if r["variant"] == variant]
    if mine:
        ms = sum(r["ms"] for r in mine)
        device_ms = routed_device[variant]
        work = (f"the {len(mine)} dense layers of DenseNet121 at "
                f"{DATA_SHAPE}^2, batch {BATCH}, that the route sends to it")
    else:
        small = [r for r in rows if r["block"] >= 2]
        mine = [r for r in layer_rows if r["block"] >= 2]
        ms = sum(r[f"{variant}_ms"] for r in small)
        device_ms = sum(r[f"{variant}_device_ms"] for r in small)
        work = (f"not routed on the main path; blocks 2-3 ({len(mine)} dense "
                f"layers) of DenseNet121 at {DATA_SHAPE}^2, batch {BATCH}, "
                f"run through it alone")
    b_ms, b_by = bound(sum(r["flops"] for r in mine),
                       sum(r["bytes"] for r in mine))
    return {
        "name": name, "route": "cuda", "source": f"tennis_torch/csrc/{name}.cu",
        "replaces": "tennis_tpu/ops/pallas/dense_block.py:92",
        "launches": launches[variant], "max_abs_err": max_abs[variant],
        "ms": ms, "device_ms": device_ms,
        "plain_ms": sum(r["plain_ms"] for r in mine),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sum(r["library_ms"] for r in mine),
        "work": work + "; launches count the /predict batches served and the "
                       "[extract], [evaluate] and [train_driver] runs",
    }


def gru_entry(name, variant, rows, launches, max_abs):
    """The kernels-line entry of one GRU variant at the 0102 serving shape;
    the async one at the cluster size its plan takes there."""
    from tennis_torch.ops import gru

    _, T, B, H, lengths = GRU_CASES[0]
    row = rows["serve_0102"]
    key = "barrier" if variant == "barrier" else \
        f"async{gru.gru_plan(H, B).cluster}"
    mine = row["variants"][key]
    return {
        "name": name, "route": "cuda", "source": f"tennis_torch/csrc/{name}.cu",
        "replaces": "tennis_tpu/ops/pallas/gru.py:41",
        "launches": launches[variant], "max_abs_err": max_abs[variant],
        "ms": mine["ms"], "device_ms": mine["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "layer_ms": row["layer_ms"], "us_per_step": mine["us_per_step"],
        "serial_floor_ms": row["serial_floor_ms"] if variant == "async"
        else row["barrier_serial_floor_ms"],
        "work": f"one GRU recurrence of the 0102 encoder: T {T}, batch {B}, "
                f"H {H}, lengths {lengths} ({key}); launches count the "
                f"/caption batches served and the per-epoch and evaluate_gnmt "
                f"decodes of [caption_driver]; library_ms (cuDNN nn.GRU) and "
                f"layer_ms (the port) cover the whole layer from {FEAT_DIM} "
                f"features at full length",
    }


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

    build_phase()
    max_abs = kernel_phase()
    agree = route_phase()
    stack = stack_phase()
    stack64_phase()
    launches = main_path_phase(torch.device("cuda"))
    model, frames = extraction_inputs(torch.device("cuda"))
    for phase in (extract_phase, evaluate_phase):
        counts = phase(torch.device("cuda"), model, frames)
        launches = {v: launches[v] + counts[v] for v in launches}
    del model
    gru_abs, gru_rows = gru_phase(torch.device("cuda"))
    gru_launches = caption_phase(torch.device("cuda"))
    vocab, splits, tree = caption_train_inputs()
    caption_train_phase(torch.device("cuda"), vocab, splits, tree)
    counts = caption_driver_phase(torch.device("cuda"), vocab, splits, tree)
    gru_launches = {v: gru_launches[v] + counts[v] for v in gru_launches}
    del vocab, splits, tree
    densenet161_phase(torch.device("cuda"))
    # last: the train step's profile holds ~10,000 launches a step, and a
    # later profiler session once recorded no kernel six times in a row
    train_phase(torch.device("cuda"), frames)
    counts = train_driver_phase(torch.device("cuda"), frames)
    launches = {v: launches[v] + counts[v] for v in launches}
    del frames
    log("route_summary", routed_is_fastest_by_batch={
        b: {"fastest": a, "shapes": n} for b, (a, n) in agree.items()})

    print(json.dumps({"kernels": [
        dense_entry("dense_layer", "tile", stack, launches, max_abs),
        dense_entry("dense_layer_persistent", "persistent", stack, launches,
                    max_abs),
        dense_entry("dense_layer_cluster", "cluster", stack, launches,
                    max_abs),
        gru_entry("gru_recurrence", "barrier", gru_rows, gru_launches, gru_abs),
        gru_entry("gru_recurrence_async", "async", gru_rows, gru_launches,
                  gru_abs)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
