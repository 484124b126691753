"""Feature extraction: the classifier's backbone over batches of uint8
frames, as ``train --save_feats`` and ``evaluate`` run it, minus JPEG
decode and ``.npy`` writes.

Each unit is a batch: taken from ``prefetch_to_device`` (the host pool's
next slice, copied to the card on the loader's side stream), run through
``inference.make_extract_features`` (``prepare_input``, then the DenseNet
with every dense layer through the dense-layer kernels), and its f32
features copied back into pinned host memory, the copy of batch t-1
waited on only after batch t is enqueued. A frame counts once its features
are on the host. Features of every ``KEEP_EVERY``-th batch (from an offset
drawn from the seed) and of the last are kept; after the window, up to
``traffic["checked_batches"]`` of them, the last always among them, are
held against the reference's features of the same frames.

Traffic keys: ``batch``, ``pool`` (distinct frames, a multiple of
``batch``), ``prefetch_buffer``, ``warmup_batches``, ``traced_units``,
``checked_batches``.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import harness

RATE = "eval_frames_per_s"
KEEP_EVERY = 8
CHECK_ROWS = 16  # reference rows at a time


def _source(images: np.ndarray, batch: int):
    slots = len(images) // batch
    t = 0
    while True:
        k = t % slots
        yield images[k * batch:(k + 1) * batch]
        t += 1


def setup(run) -> None:
    from tennis_torch import inference
    from tennis_torch.data.loader import prefetch_to_device

    cfg, tr, st = run.cfg, run.traffic, run.state
    if tr["pool"] % tr["batch"]:
        raise ValueError("the pool must hold whole batches")
    images, _ = run.pool(tr["pool"])
    run.mark("pool")
    model = harness.build_program_model(
        run, lambda: inference.build_frame_model(
            cfg["backbone"], cfg["num_classes"], cfg["data_shape"],
            dtype=harness.dtype_of(cfg)))
    st["extract"] = inference.make_extract_features(model, run.device)
    run.mark("fold")
    st["images"] = images
    run.counters["prefetch"] = {}
    st["batches"] = prefetch_to_device(
        _source(images, tr["batch"]), run.device,
        buffer_size=tr["prefetch_buffer"], stats=run.counters["prefetch"])
    pinned = run.device.type == "cuda"
    st["ring"] = [None, None]
    st["pinned"] = pinned
    st["t"] = 0
    st["pending"] = None
    st["kept"] = []
    rng = np.random.default_rng(harness.stream_seed(run.seed, 4))
    st["keep_offset"] = int(rng.integers(KEEP_EVERY))
    harness.start_peak(run)
    for _ in range(tr["warmup_batches"]):
        unit(run)
    drain(run)
    st["kept"].clear()


def _flush(run) -> None:
    st = run.state
    t, host, event = st["pending"]
    st["pending"] = None
    if event is not None:
        event.synchronize()
    st["last"] = (t, host.numpy().copy())
    if t % KEEP_EVERY == st["keep_offset"]:
        st["kept"].append(st["last"])


def unit(run) -> None:
    st, spans = run.state, run.spans
    with spans("loader_wait"):
        images = next(st["batches"])
    with spans("step_enqueue"):
        feats = st["extract"](images)
    with spans("copy_back"):
        slot = st["t"] % 2
        if st["ring"][slot] is None:
            st["ring"][slot] = torch.empty(feats.shape, dtype=feats.dtype,
                                           pin_memory=st["pinned"])
        host = st["ring"][slot]
        host.copy_(feats, non_blocking=st["pinned"])
        event = None
        if st["pinned"]:
            event = torch.cuda.Event()
            event.record()
    if st["pending"] is not None:
        with spans("synchronize"):
            _flush(run)
    st["pending"] = (st["t"], host, event)
    st["t"] += 1


def drain(run) -> None:
    if run.state["pending"] is not None:
        with run.spans("synchronize"):
            _flush(run)


def flops_per_unit(run) -> int:
    return run.cell.counts().forward_flops(run.cfg, run.traffic["batch"])


def release(run) -> None:
    st = run.state
    st["batches"].close()  # stops the loader's threads
    keep = {k: st[k] for k in ("images", "kept", "last")}
    st.clear()
    st.update(keep)


def checked(run) -> list:
    """(batch index, host features) of the batches held against the
    reference: the last, and up to ``checked_batches - 1`` kept ones
    drawn from the seed."""
    st = run.state
    kept = [b for b in st["kept"] if b[0] != st["last"][0]]
    rng = np.random.default_rng(harness.stream_seed(run.seed, 5))
    n = min(len(kept), run.traffic["checked_batches"] - 1)
    picks = sorted(rng.choice(len(kept), n, replace=False)) if n else []
    return [kept[i] for i in picks] + [st["last"]]


def reference_features(run, t: int, precision: str = "f32") -> torch.Tensor:
    """The reference's features of batch ``t``'s frames, in blocks of
    rows."""
    from port_bench.reference.inputs import prepare
    from port_bench.reference.precision import strict_f32

    strict_f32()
    ref = run.cell.reference()
    if "ref_weights" not in run.state:
        run.state["ref_weights"] = harness.reference_weights(run)
    p = run.state["ref_weights"]
    b = run.traffic["batch"]
    k = t % (len(run.state["images"]) // b)
    frames = run.state["images"][k * b:(k + 1) * b]
    out = []
    with torch.no_grad():
        for i in range(0, b, CHECK_ROWS):
            x = torch.from_numpy(frames[i:i + CHECK_ROWS]).to(run.device)
            x = prepare(x).to(next(iter(p.values())).dtype)
            out.append(ref.features(p, x, run.cfg,
                                    precision=precision).double().cpu())
    return torch.cat(out)


def check(run, precision: str | None = None) -> dict:
    """``feature_gap``: the widest relative L2 gap of a frame's features
    over the checked batches, against the f32 reference. With
    ``precision``, the control: that precision's reference in the
    program's place."""
    worst = 0.0
    for t, feats in checked(run):
        want = reference_features(run, t)
        got = torch.from_numpy(feats) if precision is None else \
            reference_features(run, t, precision)
        worst = max(worst, harness.row_gap(got, want))
    return {"feature_gap": worst}
