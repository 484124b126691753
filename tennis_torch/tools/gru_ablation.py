"""Ablations of the GRU recurrence kernels on one card.

Builds ``csrc/gru_recurrence.cu`` (or, with ``--kernel async``,
``csrc/gru_recurrence_async.cu``; with ``--kernel general``,
``csrc/gru_recurrence_general.cu``; with ``--kernel grid``,
``csrc/gru_recurrence_grid.cu``) as it is and once per ablation with one
text edit (each named in ``ABLATIONS``), then times every build by device
time (torch.profiler) at the kernel's cases, in two profiler sessions, the
second in the reverse order, and prints one JSON line per shape: for the
barrier and async kernels the 0102 serving shape (T 128, batch 4, H 256,
lengths 128/100/37/1) and the evaluate batch (32 rows); for the general
one the 0102 encoder's shape at H 640 (Wh partly streamed) and 300 (ragged
runs of units, Wh resident), at the ``/caption`` lengths; for the grid one
that shape at H 640 and 737 (two clusters). ``--cluster 8|16`` sets the
async kernel's cluster size (by default ``gru_plan``'s). An ablation that
skips work computes a wrong recurrence: its time says what that work costs
on the kernel's critical path, and nothing else.

Run from the root of a checkout: ``python -m
tennis_torch.tools.gru_ablation [--kernel async [--cluster 16] | --kernel
general | --kernel grid]``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

import torch

SOURCES = {"barrier": "gru_recurrence", "async": "gru_recurrence_async",
           "general": "gru_recurrence_general", "grid": "gru_recurrence_grid"}
# name -> [(text in the source, replacement)]
ABLATIONS = {"barrier": {
    "as_is": [],
    # every CTA returns at once: launch and cluster scheduling alone
    "launch_only": [("  const int H = a.H, U = H / kCluster, J = 3 * U, S = a.S, R = a.R;\n",
                     "  const int H = a.H, U = H / kCluster, J = 3 * U, S = a.S, R = a.R;\n"
                     "  if (a.T >= 0) return;\n")],
    # each gate thread stores its new h into its own CTA only
    "local": [("cluster.map_shared_rank(hnext, q)[gb * H + unit] = h;",
               "cluster.map_shared_rank(hnext, rank)[gb * H + unit] = h;")],
    # a CTA barrier instead of the cluster barrier that ends each step (one
    # cluster barrier stays before exit: no CTA may exit while a peer still
    # stores into it)
    "no_cluster_sync": [("    cluster.sync();\n  }\n  if (gate) a.hfin",
                         "    __syncthreads();\n  }\n  cluster.sync();\n"
                         "  if (gate) a.hfin")],
    # the gate threads load no gates
    "no_gx_load": [("    if (gate) {  // issued before the product, consumed after it",
                    "    if (false) {  // issued before the product, consumed after it")],
    # four weights read once into registers instead of from shared memory
    "wh_registers": [
        ("  const float* wcol = w + s * seg * J + j;\n",
         "  const float* wcol = w + s * seg * J + j;\n"
         "  const float wk[4] = {wcol[0], wcol[J], wcol[2 * J], wcol[3 * J]};\n"),
        ("      const float w0 = wcol[i * J], w1 = wcol[(i + 1) * J];\n"
         "      const float w2 = wcol[(i + 2) * J], w3 = wcol[(i + 3) * J];\n",
         "      const float w0 = wk[0], w1 = wk[1], w2 = wk[2], w3 = wk[3];\n")],
    # no dot product: the gate math on zero partials
    "no_product": [("    for (int i = 0; i < seg; i += 4) {",
                    "    for (int i = 0; i < 0; i += 4) {")],
}, "async": {
    "as_is": [],
    # every CTA returns at once: launch and cluster scheduling alone
    "launch_only": [("  const int rank = static_cast<int>(cluster_rank());\n"
                     "  const int H = a.H,",
                     "  const int rank = static_cast<int>(cluster_rank());\n"
                     "  if (a.T >= 0) return;\n  const int H = a.H,")],
    # every CTA sends all C copies of its units to itself: the same bytes
    # on its own mbarrier, no distributed shared memory
    "local": [("    st_async<V>(map_rank(smem_addr(hnext + b * H + rank * U + e), q),\n"
               "                stage + b * U + e, map_rank(bar, q));",
               "    st_async<V>(map_rank(smem_addr(hnext + b * H + rank * U + e), rank),\n"
               "                stage + b * U + e, map_rank(bar, rank));")],
    # no dot product: the gate math on zero partials
    "no_product": [("    for (int i = 0; i < KR; i += 4) {", "    for (int i = 0; i < 0; i += 4) {"),
                   ("    for (int i = 0; i < LS; i += 4) {",
                    "    for (int i = 0; i < 0; i += 4) {")],
    # the gate threads load no gates
    "no_gx_load": [("  if (gate && t_end > 0) {", "  if (false) {"),
                   ("      if (send) {  // in flight across the exchange",
                    "      if (false) {  // in flight across the exchange")],
    # the gate threads read the first segment's partials only
    "no_reduce": [("      for (int q = 0; q < S; ++q) {", "      for (int q = 0; q < 1; ++q) {")],
    # no expf or tanhf: the gates' arguments in their place
    "no_gate_math": [("      const float r = 1.f / (1.f + expf(-(xr + hr)));\n"
                      "      const float z = 1.f / (1.f + expf(-(xz + hz)));\n"
                      "      const float n = tanhf(xn + r * hn);",
                      "      const float r = xr + hr;\n"
                      "      const float z = xz + hz;\n"
                      "      const float n = xn + r * hn;")],
    # no ys store inside the loop
    "no_ys_store": [("      a.ys[t * a.ys_st + (row0 + gb) * a.ys_sb + unit] = alive ? h_new : 0.f;\n",
                     "")],
    # every row runs all T steps (no dead-step cut)
    "all_steps": [("  for (int b = 0; b < nb; ++b) t_end = max(t_end, min(max(a.vl[row0 + b], 0), a.T));",
                   "  t_end = a.T;")],
}, "general": {
    "as_is": [],
    # every CTA returns at once: launch and cluster scheduling alone
    "launch_only": [("  const int rank = static_cast<int>(cluster_rank());\n"
                     "  const int H = a.H,",
                     "  const int rank = static_cast<int>(cluster_rank());\n"
                     "  if (a.T >= 0) return;\n  const int H = a.H,")],
    # the streamed rows skipped: registers and shared memory alone
    "no_stream": [("      for (int c = 0; c < n_chunks; ++c, ++used) {",
                   "      for (int c = 0; c < 0; ++c, ++used) {")],
    # 4-byte copies only, wherever Wh's layout allows 16-byte ones
    "no_vec_copy": [("  const bool vec = a.wh_sk == 1",
                     "  const bool vec = false && a.wh_sk == 1")],
    # no dot product: the gate math on zero partials (the ring still runs)
    "no_product": [("      for (int i = 0; i < kRegL; i += 4) {",
                    "      for (int i = 0; i < 0; i += 4) {"),
                   ("      for (int i = 0; i < LR; i += 4) {",
                    "      for (int i = 0; i < 0; i += 4) {")],
    # the gate threads load no gates
    "no_gx_load": [("  if (gate && t_end > 0) {", "  if (false) {"),
                   ("      if (send) {  // in flight across the exchange",
                    "      if (false) {  // in flight across the exchange")],
    # the gate threads read the first segment's partials only
    "no_reduce": [("      for (int q = 0; q < S; ++q) {", "      for (int q = 0; q < 1; ++q) {")],
    # every row runs all T steps (no dead-step cut)
    "all_steps": [("  for (int b = 0; b < nb; ++b) t_end = max(t_end, min(max(a.vl[row0 + b], 0), a.T));",
                   "  t_end = a.T;")],
}, "grid": {
    "as_is": [],
    # no wait for the other CTAs' h: each step copies whatever the exchange
    # buffer holds (the arrivals and the copy stay)
    "no_cross_exchange": [
        ("      if (tid == 0) wait_arrivals(counter, static_cast<unsigned int>(G * t));\n",
         "")],
    # no dot product: the gate math on zero partials (the exchange runs)
    "no_product": [("      for (int i = 0; i < kRegL; i += 4) {",
                    "      for (int i = 0; i < 0; i += 4) {"),
                   ("      for (int i = 0; i < LR; i += 4) {",
                    "      for (int i = 0; i < 0; i += 4) {")],
}}
# (name, T, batch, H, valid lengths)
CASES = {"barrier": [("serve_0102", 128, 4, 256, [128, 100, 37, 1]),
                     ("evaluate_b32", 128, 32, 256,
                      [128 * (31 - i) // 31 for i in range(32)])]}
CASES["async"] = CASES["barrier"]
CASES["general"] = [("wide_h640", 128, 4, 640, [21, 30, 104, 69]),
                    ("ragged_h300", 128, 4, 300, [21, 30, 104, 69])]
CASES["grid"] = [("wide_h640", 128, 4, 640, [21, 30, 104, 69]),
                 ("edge_h737", 128, 4, 737, [21, 30, 104, 69])]
# ints after T, B, H: the partition; the grid kernel also takes a workspace
N_INTS = {"barrier": 5, "async": 6, "general": 8, "grid": 7}


def build_all(kernel, out_dir):
    """Compile every ablation in parallel; returns {name: (library, ptxas)}."""
    from tennis_torch.ops._build import CSRC, NVCC_FLAGS, nvcc_path

    with open(os.path.join(CSRC, f"{SOURCES[kernel]}.cu")) as f:
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
                      and "gru_recurrence" in e.name),
                     key=lambda e: e.time_range.start)
    if len(records) != reps * len(runs):
        raise SystemExit(f"{len(records)} kernel records for "
                         f"{reps * len(runs)} launches")
    return {key: sum(e.time_range.elapsed_us() for e in
                     records[i * reps:(i + 1) * reps]) / reps / 1e3
            for i, (key, _) in enumerate(runs)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(ABLATIONS), default="barrier")
    parser.add_argument("--cluster", type=int, choices=(8, 16), default=None)
    opts = parser.parse_args(argv)
    kernel = opts.kernel
    if not torch.cuda.is_available():
        print("gru_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from tennis_torch.ops import gru
    from tennis_torch.ops._build import BUILD

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    built = build_all(kernel, os.path.join(BUILD, "gru_ablation"))
    launch = {}
    for name, (lib, ptxas) in built.items():
        fn = getattr(ctypes.CDLL(lib), f"{SOURCES[kernel]}_launch")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll, ll, p, p, ll, ll, p, p, p, ll, ll, p] + \
            [i] * N_INTS[kernel] + [p] * (2 if kernel == "grid" else 1)
        fn.restype = ctypes.c_int
        launch[name] = fn
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, T, B, H, lengths in CASES[kernel]:
        def rand(*shape, std=1.0):
            return torch.empty(shape, device=dev).normal_(0, std, generator=gen)

        gx, h0 = rand(T, B, 3 * H), rand(B, H, std=0.5)
        wh, bh = rand(H, 3 * H, std=H ** -0.5), rand(3 * H, std=0.1)
        vl = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ys = torch.empty((B, T, H), device=dev).transpose(0, 1)
        hfin = torch.empty((B, H), device=dev)
        if kernel == "barrier":
            partition = gru._split(H, B)
        elif kernel == "general":
            plan = gru.general_plan(H, B)
            partition = (plan.cluster, plan.segments, plan.seg_rows,
                         plan.rows, plan.smem_rows)
        elif kernel == "grid":
            plan = gru.grid_plan(H, B)
            partition = (plan.ctas, plan.segments, plan.seg_rows, plan.rows)
        else:
            plan = gru.gru_plan(H, B, opts.cluster)
            partition = (plan.cluster, plan.segments, plan.rows)
        args = [gx.data_ptr(), gx.stride(0), gx.stride(1), h0.data_ptr(),
                wh.data_ptr(), wh.stride(0), wh.stride(1), bh.data_ptr(),
                vl.data_ptr(), ys.data_ptr(), ys.stride(0), ys.stride(1),
                hfin.data_ptr(), T, B, H, *partition]

        # the grid kernel's counters and exchange buffer, zeroed before
        # every launch as the wrapper does
        workspace = torch.zeros(plan.workspace_words if kernel == "grid"
                                else 0, dtype=torch.int32, device=dev)
        extra = (workspace.data_ptr(),) if kernel == "grid" else ()

        def run(name):
            workspace.zero_()
            err = launch[name](*args, *extra,
                               torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")

        runs = [(f"{name}_device_ms", lambda name=name: run(name))
                for name in launch]
        row = {"case": case, "T": T, "batch": B, "hidden": H,
               "lengths": lengths, "partition": partition}
        for turn in (runs, runs[::-1]):
            for key, ms in device_ms(turn).items():
                row.setdefault(key, []).append(ms)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
