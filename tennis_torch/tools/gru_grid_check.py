"""A quick card check of the grid GRU kernel beside the general one.

Builds ``csrc/gru_recurrence_grid.cu`` and ``csrc/gru_recurrence_general.cu``
and prints, one JSON line each: the clusters of 16 CTAs the card holds at
once at several shared-memory sizes (what ``gru.GRID_MAX_CTAS`` must not
exceed); at each case, with Wh row-major and transposed, the grid kernel's
largest error against the plain version, whether two launches agree bit for
bit and whether the outputs are zero past each length, and the device time
(torch.profiler, mean of 5 launches, by kernel name) of the grid and
general kernels through ``gru_recurrence``; two grid launches on two
streams at once against the plain version; the grid kernel's L2 exchange
round trip (``gru_grid_exchange_probe_launch``) at several CTA counts; the
grid kernel's device time with a transposed Wh read in place against a
row-major Wh, beside the device time of the row-major copy the wrapper
makes; and whether a batch past the resident CTAs is refused before any
launch. Exits 1 if a check fails.

Run from the root of a checkout on a machine with a card: ``python -m
tennis_torch.tools.gru_grid_check`` (~30 s).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

LENGTHS = [21, 30, 104, 69]  # the measured /caption batch
# (T, B, H, lengths)
CASES = [(128, 4, 640, LENGTHS), (128, 4, 737, LENGTHS), (1, 4, 1020, [1] * 4),
         (16, 9, 1000, [16, 0, 3, 16, 9, 1, 16, 2, 5]), (20, 1, 640, [20]),
         (12, 8, 700, [12, 0, 5, 12, 1, 2, 3, 11]), (7, 3, 900, [7, 2, 0])]
# (rows, H, CTAs) of the exchange probe
PROBES = [(4, 640, 32), (4, 737, 32), (4, 1020, 48), (1, 640, 16)]
SMEM_SIZES = (32768, 91392, 150400, 214368, 224352)
TOL = 1e-4


def device_us(fn, reps=5, name=None):
    """{kernel name[:40]: mean device µs} over ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                (name is None or name in ev.name):
            by_name.setdefault(ev.name[:40], []).append(
                ev.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in by_name.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("gru_grid_check: CUDA is not available", file=sys.stderr)
        return 1
    from tennis_torch.ops import gru
    from tennis_torch.ops._build import load_library

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    lib = load_library("gru_recurrence_grid")
    resident = lib.gru_recurrence_grid_resident_clusters
    resident.argtypes = [ctypes.c_int, ctypes.c_longlong]
    resident.restype = ctypes.c_int
    print(json.dumps({"resident_clusters": {
        R: {s: resident(R, s) for s in SMEM_SIZES} for R in (1, 2, 4, 8)}}),
        flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=gen)

    def inputs(T, B, H, lengths):
        return (rand(T, B, 3 * H), rand(B, H, std=0.5),
                rand(H, 3 * H, std=H ** -0.5), rand(3 * H, std=0.1),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    ok = True
    with torch.inference_mode():
        for T, B, H, lengths in CASES:
            for layout in ("row", "col"):
                gx, h0, wh, bh, vl = inputs(T, B, H, lengths)
                if layout == "col":
                    wh = wh.t().contiguous().t()
                args = (gx, h0, wh, bh, vl)
                ys, h = gru.gru_recurrence(*args, variant="grid")
                ys2, h2 = gru.gru_recurrence(*args, variant="grid")
                ys_r, h_r = gru.gru_recurrence_reference(*args)
                torch.cuda.synchronize()
                err = max((ys - ys_r).abs().max().item(),
                          (h - h_r).abs().max().item())
                same = torch.equal(ys, ys2) and torch.equal(h, h2)
                frozen = all(not ys[n:, b].any() for b, n in enumerate(lengths))
                times = {v: device_us(lambda v=v: gru.gru_recurrence(
                    *args, variant=v)) for v in ("grid", "general")}
                c_ok = err <= TOL and same and frozen
                ok = ok and c_ok
                print(json.dumps({
                    "T": T, "B": B, "H": H, "layout": layout,
                    "route": gru.gru_route(T, B, H),
                    "plan": gru.grid_plan(H, B)._asdict(), "max_abs_err": err,
                    "bitwise_repeatable": same, "zero_past_length": frozen,
                    "device_us": times, "ok": c_ok}), flush=True)

        runs = [inputs(128, 4, 640, LENGTHS) for _ in range(2)]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream() for _ in runs]
        outs = []
        for stream, args in zip(streams, runs):
            with torch.cuda.stream(stream):
                outs.append(gru.gru_recurrence(*args, variant="grid"))
        torch.cuda.synchronize()
        errs = [max((ys - r[0]).abs().max().item(), (h - r[1]).abs().max().item())
                for (ys, h), r in zip(outs, (gru.gru_recurrence_reference(*a)
                                             for a in runs))]
        ok = ok and max(errs) <= TOL
        print(json.dumps({"two_streams_max_abs_err": errs}), flush=True)

        probe = lib.gru_grid_exchange_probe_launch
        probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        probe.restype = ctypes.c_int
        for nb, H, G in PROBES:
            ws = torch.zeros(gru.COUNTER_STRIDE + 2 * nb * (-(-H // 4) * 4),
                             dtype=torch.int32, device=dev)
            sink = torch.empty(G, device=dev)

            def run(iters):
                ws.zero_()
                err = probe(iters, nb, H, G, ws.data_ptr(), sink.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"exchange probe: CUDA error {err}")

            ms = {}
            for iters in (64, 4096):
                run(iters)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                start.record()
                for _ in range(3):
                    run(iters)
                end.record()
                end.synchronize()
                ms[iters] = start.elapsed_time(end) / 3
            print(json.dumps({"probe_rows": nb, "hidden": H, "ctas": G,
                              "round_trip_us": (ms[4096] - ms[64])
                              / (4096 - 64) * 1e3}), flush=True)

        # a transposed Wh read in place by the kernel, against row-major
        launch = gru._launcher("grid")
        for T, B, H, lengths in ((128, 4, 640, LENGTHS), (1, 4, 1020, [1] * 4)):
            plan = gru.grid_plan(H, B)
            gx, h0, wrow, bh, vl = inputs(T, B, H, lengths)
            wcol = wrow.t().contiguous().t()
            row = {"T": T, "B": B, "H": H}
            for name, wh in (("row_major", wrow), ("transposed", wcol)):
                out = torch.empty((B, T, H), device=dev).transpose(0, 1)
                hf = torch.empty((B, H), device=dev)
                ws = torch.zeros(plan.workspace_words, dtype=torch.int32,
                                 device=dev)

                def go(wh=wh, out=out, hf=hf, ws=ws):
                    ws.zero_()
                    err = launch(
                        gx.data_ptr(), gx.stride(0), gx.stride(1),
                        h0.data_ptr(), wh.data_ptr(), wh.stride(0),
                        wh.stride(1), bh.data_ptr(), vl.data_ptr(),
                        out.data_ptr(), out.stride(0), out.stride(1),
                        hf.data_ptr(), T, B, H, plan.ctas, plan.segments,
                        plan.seg_rows, plan.rows, ws.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"grid launch: CUDA error {err}")

                go()
                torch.cuda.synchronize()
                err = (out - gru.gru_recurrence_reference(
                    gx, h0, wrow, bh, vl)[0]).abs().max().item()
                ok = ok and err <= TOL
                row[f"{name}_kernel_us"] = sum(device_us(
                    go, name="grid_kernel").values())
                row[f"{name}_max_abs_err"] = err
            row["row_major_copy_us"] = sum(device_us(
                lambda: wcol.contiguous()).values())
            print(json.dumps(row), flush=True)

        refused = gru.grid_plan(640, 32) is None
        try:
            gru.gru_recurrence(*inputs(4, 32, 640, [4] * 32), variant="grid")
        except ValueError:
            pass
        else:
            refused = False
        ok = ok and refused
        print(json.dumps({"b32_h640_refused_before_launch": refused}),
              flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
