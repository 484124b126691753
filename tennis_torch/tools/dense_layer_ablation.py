"""Ablations of the persistent, cluster and f32 tensor-core dense-layer
kernels on one card.

Builds ``csrc/dense_layer_persistent.cu`` (or, with ``--kernel cluster``,
``csrc/dense_layer_cluster.cu``, with ``--kernel f32_tc``
``csrc/dense_layer_f32_tc.cu``) as it is and once per ablation with one
text edit (each named in ``ABLATIONS``), then times every build at
DenseNet121 layer shapes and prints one JSON line per shape. The persistent
kernel is timed with CUDA events at blocks 0 and 1 of DenseNet121-512 (batch
8), beside the tile kernel. The cluster kernel is timed by device time
(torch.profiler) at the small maps, at every cluster size, beside the tile
and persistent kernels; its ablations run in two profiler sessions, the
second in the reverse order. The f32 tensor-core kernel is timed with CUDA
events at one layer of each DenseNet121-512 block at batch 64 and at the
small maps at batch 2, and each build's output is
held against the layer in f64 (max |out - f64| / max |f64|). An ablation that
skips work computes a wrong layer: its time says what that work costs on the
kernel's critical path, and nothing else.

Run from the root of a checkout:
``python -m tennis_torch.tools.dense_layer_ablation [--kernel cluster |
f32_tc]``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading

import torch

# the f32 tensor-core kernel's three products of a conv1 and a conv2 K step
F32_CONV1_MMA = ("        mma_n128(part, lo[kk], dh, kk > 0);\n"
                 "        mma_n128(part, hi[kk], dl, 1);\n"
                 "        mma_n128(part, hi[kk], dh, 1);\n")
F32_CONV2_MMA = ("        mma_n32(part2[p], blo[tap & 1][kk], dh, kk % 4 != 0);\n"
                 "        mma_n32(part2[p], bhi[tap & 1][kk], dl, 1);\n"
                 "        mma_n32(part2[p], bhi[tap & 1][kk], dh, 1);\n")
# name -> [(text in the source, replacement)]
ABLATIONS = {"persistent": {
    "as_is": [],
    # producers copy and store each vector back, without BN1 + ReLU
    "no_bn1": [("bn_relu8(raw[e], inv, sh);", "raw[e];")],
    # 2 producer warps instead of 4
    "producers_64": [("constexpr int kProducers = 128;",
                      "constexpr int kProducers = 64;")],
    # 32-channel chunks in a 4-stage ring
    "chunk32_stages4": [("constexpr int kChunk = 64;", "constexpr int kChunk = 32;"),
                        ("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    # consumers skip conv1's ldmatrix + mma.sync (still take every stage)
    "no_conv1_mma": [("    for (int kk = 0; kk < kChunk; kk += 16) {\n      if (kk < kc) {",
                      "    for (int kk = 0; kk < kChunk; kk += 16) {\n      if (false) {")],
    # consumers skip conv2's nine taps
    "no_conv2_mma": [("    for (int t = 0; t < kTaps; ++t) {",
                      "    for (int t = 0; t < 0; ++t) {")],
}, "cluster": {
    "as_is": [],
    # every CTA returns at once: launch and cluster scheduling alone
    "launch_only": [("  const int rank = static_cast<int>(cluster_rank());\n",
                     "  const int rank = static_cast<int>(cluster_rank());\n"
                     "  if (a.H > 0) return;\n")],
    # both reduces read and write the CTA's own shared memory only
    "local": [("map_rank(part + c, q)", "map_rank(part + c, rank)"),
              ("                             p / kPx),", "                             rank),")],
    # and CTA barriers instead of cluster barriers
    "no_cluster": [("map_rank(part + c, q)", "map_rank(part + c, rank)"),
                   ("                             p / kPx),", "                             rank),"),
                   ("  cluster_sync();  // every partial", "  __syncthreads();  //"),
                   ("  // conv1 partial any more\n  cluster_sync();",
                    "  // conv1 partial any more\n  __syncthreads();")],
    # conv1 takes the first step only
    "one_step": [("  for (int j = 0; j < n_steps; ++j) {",
                  "  for (int j = 0; j < min(n_steps, 1); ++j) {")],
    # conv1 copies nothing (multiplies stale data)
    "no_copy": [("    if (seg * 8 >= k_end - k0) return;", "    return;")],
    # each thread stores its x vectors back without BN1 + ReLU
    "no_bn1": [("bn_relu8(raw[e], inv, sh);", "raw[e];")],
    "no_conv1_mma": [("    for (int kk = 0; kk < kChunk; kk += 16) {\n      if (kk < kc) {",
                      "    for (int kk = 0; kk < kChunk; kk += 16) {\n      if (false) {")],
    "no_conv2_mma": [("  for (int t = 0; t < kTaps; ++t) {",
                      "  for (int t = 0; t < 0; ++t) {")],
    # 32-channel steps, three stages (the conv1 partial needs 54,400 B)
    "chunk32": [("constexpr int kChunk = 64;", "constexpr int kChunk = 32;"),
                ("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # three stages of 64 channels: one CTA per SM at every cluster size
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # up to 255 registers a thread at every cluster size (one CTA per SM)
    "regs255": [("__launch_bounds__(kThreads, S == 2 ? 1 : 2)",
                 "__launch_bounds__(kThreads, 1)")],
    # mma.sync, or ldmatrix, as an asm statement the compiler may schedule
    # (ldmatrix may then move across a barrier: timing only)
    "mma_free": [("  asm volatile(\n      \"mma.sync", "  asm(\n      \"mma.sync")],
    "ldsm_free": [("  asm volatile(\"ldmatrix", "  asm(\"ldmatrix")],
}, "f32_tc": {
    "as_is": [],
    # conv1's or conv2's wgmmas skipped, or both (still take every stage)
    "no_conv1_mma": [(F32_CONV1_MMA, "")],
    "no_conv2_mma": [(F32_CONV2_MMA, "")],
    "no_mma": [(F32_CONV1_MMA, ""), (F32_CONV2_MMA, "")],
    # one TF32 product a pair (hi * hi) instead of three
    "one_product": [(F32_CONV1_MMA,
                     "        mma_n128(part, hi[kk], dh, kk > 0);\n"),
                    (F32_CONV2_MMA, "        mma_n32(part2[p], "
                     "bhi[tap & 1][kk], dh, kk % 4 != 0);\n")],
    # no promotion: each accumulator sums its whole share of K on the tensor
    # cores (conv2 keeps its two parts a warpgroup)
    "no_promotion": [("        mma_n128(part, lo[kk], dh, kk > 0);",
                      "        mma_n128(part, lo[kk], dh, 1);"),
                     ("      for (int j = 0; j < 64; ++j) acc[j] += part[j];",
                      "      for (int j = 0; j < 64; ++j) acc[j] = part[j];"),
                     ("blo[tap & 1][kk], dh, kk % 4 != 0);",
                      "blo[tap & 1][kk], dh, 1);"),
                     ("      for (int j = 0; j < 16; ++j) acc2[j] += part2[0][j];\n"
                      "#pragma unroll\n"
                      "      for (int j = 0; j < 16; ++j) acc2[j] += part2[1][j];",
                      "      for (int j = 0; j < 16; ++j)\n"
                      "        acc2[j] = part2[0][j] + part2[1][j];")],
    # the x chunks copied by one producer warp, or not copied (stale data)
    "x_by_one_warp": [("for (int v = pt; v < kHaloPx * 8; v += kProducerThreads)",
                       "for (int v = pt; v < kHaloPx * 8 && pt < 32; v += 32)")],
    "no_x_copy": [("          if (iy >= 0 && iy < H && ix >= 0 && ix < W)\n"
                   "            cp_async16(",
                   "          if (iy >= 0 && iy < H && ix >= 0 && ix < W && H < 0)\n"
                   "            cp_async16(")],
}}
# (batch, side, c_in, c_final)
CASES = {
    # first and last layer of DenseNet121-512 blocks 0 and 1
    "persistent": [(8, 128, 64, 256), (8, 128, 224, 256), (8, 64, 128, 512),
                   (8, 64, 480, 512)],
    # first and last layer of blocks 2 and 3, the ragged 7x7 map, batch 1
    "cluster": [(8, 32, 256, 288), (8, 32, 992, 1024), (8, 16, 512, 544),
                (8, 16, 992, 1024), (8, 7, 512, 544), (1, 16, 512, 544)],
    # a middle layer of each block at a decode batch's 64 frames; the small
    # maps at batch 2
    "f32_tc": [(64, 128, 160, 256), (64, 64, 320, 512), (64, 32, 640, 1024),
               (64, 16, 768, 1024), (2, 32, 640, 1024), (2, 16, 768, 1024)],
}


def build_all(kernel, out_dir):
    """Compile every ablation in parallel; returns {name: (library, ptxas)}."""
    from tennis_torch.ops._build import CSRC, NVCC_FLAGS, nvcc_path

    with open(os.path.join(CSRC, f"dense_layer_{kernel}.cu")) as f:
        source = f.read()
    os.makedirs(out_dir, exist_ok=True)
    built, errors = {}, {}

    def go(name, edits):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                errors[name] = f"edit not found once: {old!r}"
                return
            text = text.replace(old, new)
        cu, lib = (os.path.join(out_dir, f"{kernel}_{name}{ext}")
                   for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib, cu],
                              capture_output=True, text=True)
        if proc.returncode:
            errors[name] = proc.stderr[-2000:]
            return
        report = (proc.stdout + proc.stderr).splitlines()
        built[name] = (lib, [l.strip() for l in report
                             if "registers" in l or "spill" in l])

    threads = [threading.Thread(target=go, args=kv)
               for kv in ABLATIONS[kernel].items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"ablation builds failed: {errors}")
    return built


def time_ms(fn, reps=20, rounds=5):
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


def device_ms(runs, reps=10):
    """Mean device ms of each ``(key, fn)`` of ``runs``, every fn launching
    one kernel, ``reps`` times each, in one profiler session; the kernel
    records are matched to the launches in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, fn in runs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in runs:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    records = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "dense_layer" in e.name),
                     key=lambda e: e.time_range.start)
    if len(records) != reps * len(runs):
        raise SystemExit(f"{len(records)} kernel records for "
                         f"{reps * len(runs)} launches")
    return {key: sum(e.time_range.elapsed_us() for e in
                     records[i * reps:(i + 1) * reps]) / reps / 1e3
            for i, (key, _) in enumerate(runs)}


def f32_row(db, launch, gen, dev, batch, side, c_in, c_final):
    """One shape of the f32 tensor-core kernel's ablations: each build's ms
    (CUDA events, twice, in turns) and its max |out - f64| / max |f64|."""
    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=gen)

    state = rand(batch, side, side, c_final)
    ops = db.LayerOperands(
        rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
        rand(128, c_in, std=c_in ** -0.5), rand(128).abs() + 0.5,
        rand(128) * 0.5, rand(3, 3, 32, 128, std=1152 ** -0.5))
    w1, w2 = db._tf32_weights(ops)
    want = db.dense_layer_reference(state.double(), c_in,
                                    ops)[..., c_in:c_in + db.GROWTH]

    def run(name, st):
        err = launch[name](
            st.data_ptr(), ops.inv1.data_ptr(), ops.sh1.data_ptr(),
            w1.data_ptr(), ops.inv2.data_ptr(), ops.sh2.data_ptr(),
            w2.data_ptr(), batch, side, side, c_final, c_in,
            db.BOTTLENECK, db.GROWTH, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")

    row = {"case": [batch, side, side, c_final], "c_in": c_in}
    for name in launch:
        got = state.clone()
        run(name, got)
        torch.cuda.synchronize()
        part = got[..., c_in:c_in + db.GROWTH].double()
        row[f"{name}_rel_err_f64"] = ((part - want).abs().max()
                                      / want.abs().max()).item()
    order = list(launch)
    for name in order + order[::-1]:  # each ablation twice, in turns
        row.setdefault(f"{name}_ms", []).append(
            time_ms(lambda: run(name, state)))
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(ABLATIONS),
                        default="persistent")
    kernel = parser.parse_args(argv).kernel
    if not torch.cuda.is_available():
        print("dense_layer_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from tennis_torch.ops import dense_block as db
    from tennis_torch.ops._build import BUILD

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    built = build_all(kernel, os.path.join(BUILD, "ablation"))
    launch = {}
    n_int = 7 if kernel == "f32_tc" else 8  # ..., max_ctas or cluster size
    for name, (lib, ptxas) in built.items():
        fn = getattr(ctypes.CDLL(lib), f"dense_layer_{kernel}_launch")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[name] = fn
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "f32_tc":
        for case in CASES[kernel]:
            print(json.dumps(f32_row(db, launch, gen, dev, *case)), flush=True)
        return 0
    for batch, side, c_in, c_final in CASES[kernel]:
        def rand(*shape, std=1.0):
            return torch.empty(shape, device=dev).normal_(0, std, generator=gen)

        state = rand(batch, side, side, c_final).to(torch.bfloat16)
        ops = db.LayerOperands(
            rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
            rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
            rand(128).abs() + 0.5, rand(128) * 0.5,
            rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))
        args = [state.data_ptr(), *(t.data_ptr() for t in ops), batch, side, side,
                c_final, c_in, db.BOTTLENECK, db.GROWTH]

        def run(name, last_arg):
            err = launch[name](*args, last_arg,
                               torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        row = {"case": [batch, side, side, c_final], "c_in": c_in}
        if kernel == "persistent":
            row["tile_ms"] = time_ms(lambda: db.dense_layer(state, c_in, ops, "tile"))
            order = list(launch)
            for name in order + order[::-1]:  # each ablation twice, in turns
                row.setdefault(f"{name}_ms", []).append(
                    time_ms(lambda: run(name, sms)))
        else:
            runs = [(f"{v}_device_ms", lambda v=v: db.dense_layer(state, c_in, ops, v))
                    for v in ("tile", "persistent")]
            runs += [(f"{name}_s{s}_device_ms", lambda name=name, s=s: run(name, s))
                     for name in launch for s in db.CLUSTER_SIZES]
            for turn in (runs, runs[::-1]):
                for key, ms in device_ms(turn).items():
                    row.setdefault(key, []).append(ms)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
