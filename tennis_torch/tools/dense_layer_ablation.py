"""Ablations of the persistent dense-layer kernel on one CUDA card.

Builds ``csrc/dense_layer_persistent.cu`` as it is and once per ablation
with one text edit (each named in ``ABLATIONS``), then times every build and
the tile kernel (``csrc/dense_layer.cu``) at the DenseNet121-512 layer shapes
of blocks 0 and 1 (batch 8) with CUDA events, and prints one JSON line per
shape. An ablation that skips work computes a wrong layer: its time says
what that work costs on the kernel's critical path, and nothing else.

Run from the root of a checkout: ``python -m tennis_torch.tools.dense_layer_ablation``.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading

import torch

# name -> [(text in the source, replacement)]
ABLATIONS = {
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
}
# (batch, side, c_in, c_final): first and last layer of DenseNet121-512
# blocks 0 and 1
CASES = [(8, 128, 64, 256), (8, 128, 224, 256), (8, 64, 128, 512),
         (8, 64, 480, 512)]


def build_all(out_dir):
    """Compile every ablation in parallel; returns {name: (library, ptxas)}."""
    from tennis_torch.ops._build import CSRC, NVCC_FLAGS, nvcc_path

    with open(os.path.join(CSRC, "dense_layer_persistent.cu")) as f:
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
        cu, lib = (os.path.join(out_dir, f"{name}{ext}") for ext in (".cu", ".so"))
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

    threads = [threading.Thread(target=go, args=kv) for kv in ABLATIONS.items()]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_layer_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from tennis_torch.ops import dense_block as db
    from tennis_torch.ops._build import BUILD

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    built = build_all(os.path.join(BUILD, "ablation"))
    launch = {}
    for name, (lib, ptxas) in built.items():
        fn = ctypes.CDLL(lib).dense_layer_persistent_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[name] = fn
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    for batch, side, c_in, c_final in CASES:
        def rand(*shape, std=1.0):
            return torch.empty(shape, device=dev).normal_(0, std, generator=gen)

        state = rand(batch, side, side, c_final).to(torch.bfloat16)
        ops = db.LayerOperands(
            rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
            rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
            rand(128).abs() + 0.5, rand(128) * 0.5,
            rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))
        args = [state.data_ptr(), *(t.data_ptr() for t in ops), batch, side, side,
                c_final, c_in, db.BOTTLENECK, db.GROWTH, sms]

        def run(name):
            err = launch[name](*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        row = {"case": [batch, side, side, c_final], "c_in": c_in,
               "tile_ms": time_ms(lambda: db.dense_layer(state, c_in, ops, "tile"))}
        order = list(launch)
        for name in order + order[::-1]:  # each ablation twice, in turns
            row.setdefault(f"{name}_ms", []).append(time_ms(lambda: run(name)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
