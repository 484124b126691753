"""Streaming inference on a raw broadcast video (counterpart of
``tennis_tpu/predict.py``).

Point it at a video and a trained vision experiment: frames stream off the
decoder through the test geometry into batches of ``--batch_size`` (the
last one edge-padded to the same shape), the pinned prefetch and the
classifier (on a GPU every DenseNet dense layer in a dense-layer kernel),
then an events timeline is written. No dataset, annotations or splits are
needed; ``--root`` is read for ``classes.names`` only.

Outputs under ``--out_dir`` (default ``predictions/<video stem>``):

- ``probabilities.npy``: (N, num_classes) softmax per sampled frame
- ``frames.txt``: the source frame index of each row
- ``events.tsv``: maximal runs of one top-1 class: start/end frame, class,
  mean probability
- ``results.mp4``: with ``--vis``, the overlay video of
  ``utils.visualisation.visualise_events``

The decoder (:func:`video_frames`, cv2) is apart from the rest:
:func:`predict` takes any iterable of ``(frame index, RGB uint8 frame)`` in
its place, so frames made in memory go through the same geometry, batches,
prefetch, model and writers. Flags: the JAX driver's names and defaults,
plus ``--device`` (``cuda`` by default; asking for it without a GPU raises).

Run: ``python -m tennis_torch.predict --video match.mp4 --model_id 0006
--backbone DenseNet121 --every 5`` (``--device cpu`` off the GPU).
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    from tennis_torch.train import _add_bool

    p = argparse.ArgumentParser(description="Event labels for a raw video")
    add = p.add_argument
    add("--video", default=None, help="Input video file")
    add("--root", default="data",
        help="Dataset root (classes.names lookup only)")
    add("--model_id", default="0000",
        help="Experiment id holding the checkpoint")
    add("--backbone", default="DenseNet121", help="Backbone CNN name")
    add("--out_dir", default=None,
        help="Output directory (default predictions/<video stem>)")
    add("--every", type=int, default=1, help="Classify every nth frame")
    add("--batch_size", type=int, default=64, help="Inference batch size")
    add("--data_shape", type=int, default=512, help="Input crop side")
    add("--max_frames", type=int, default=-1,
        help="Stop after this many sampled frames")
    _add_bool(p, "vis", "Write the results.mp4 overlay video")
    add("--vis_fps", type=int, default=30, help="Overlay video frame rate")
    add("--device", default="cuda", choices=["cuda", "cpu"],
        help="Device the model runs on")
    args = p.parse_args(argv)
    if args.every < 1:
        p.error("--every must be at least 1")
    return args


def label_runs(labels: np.ndarray, frame_ids: np.ndarray,
               probs: np.ndarray | None = None):
    """Maximal runs of equal class label -> [(start, end, cls, mean_prob)]:
    consecutive equal labels merge, and a run spans the first to the last
    source frame of its members (the rule the dataset layer derives events
    by)."""
    events = []
    start = 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[start]:
            conf = float(probs[start:i, labels[start]].mean()) \
                if probs is not None else float("nan")
            events.append((int(frame_ids[start]), int(frame_ids[i - 1]),
                           int(labels[start]), conf))
            start = i
    return events


def sample_frames(frames, every: int = 1, max_frames: int = -1):
    """``(index, frame)`` of every ``every``-th item of ``frames`` from the
    first, stopping after ``max_frames`` of them (all when <= 0)."""
    n_seen = 0
    for idx, frame in enumerate(frames):
        if idx % every:
            continue
        yield idx, frame
        n_seen += 1
        if 0 < max_frames <= n_seen:
            return


def video_frames(video_path: str, every: int = 1, max_frames: int = -1):
    """``(frame index, RGB uint8)`` of the sampled frames of a video, off
    cv2's decoder (only the sampled frames are converted)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")

    def decoded():
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            yield bgr

    try:
        for idx, bgr in sample_frames(decoded(), every, max_frames):
            yield idx, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def saving_frames(frames, frames_dir: str):
    """``frames`` as they are, each also written full size to
    ``<frames_dir>/<index:010d>.jpg`` (the overlay reads them back)."""
    import cv2

    for idx, rgb in frames:
        cv2.imwrite(os.path.join(frames_dir, f"{idx:010d}.jpg"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        yield idx, rgb


def frame_batches(frames, batch: int, data_shape: int):
    """Yield ``(uint8 [batch, S, S, 3], frame ids, n_valid)`` from an
    iterable of ``(frame index, RGB uint8)``, each frame through the test
    geometry. The last batch is edge-padded (its last frame repeated) to the
    same shape and the consumer drops the pad rows by ``n_valid``; the ids
    stay a list, so the prefetch leaves them on the host."""
    from tennis_torch.data.transforms import test_geometry

    imgs, ids = [], []
    for idx, rgb in frames:
        imgs.append(test_geometry(rgb, data_shape))
        ids.append(idx)
        if len(imgs) == batch:
            yield np.stack(imgs), ids, batch
            imgs, ids = [], []
    if imgs:
        n = len(imgs)
        pad = batch - n
        imgs.extend([imgs[-1]] * pad)
        ids.extend([ids[-1]] * pad)
        yield np.stack(imgs), ids, n


def classify(frames, predict_probs, batch: int, data_shape: int, device,
             stats: dict | None = None):
    """``(probs (N, classes), frame ids (N,))`` of ``frames`` through
    :func:`frame_batches`, ``prefetch_to_device`` (the images only; ids and
    ``n_valid`` stay on the host) and ``predict_probs``."""
    from tennis_torch.data.loader import prefetch_to_device

    all_probs, all_ids = [], []
    for images, ids, n in prefetch_to_device(
            frame_batches(frames, batch, data_shape), device, stats=stats):
        all_probs.append(predict_probs(images)[:n])
        all_ids.append(np.asarray(ids[:n], np.int64))
    if not all_probs:
        raise ValueError("no frames to classify")
    return np.concatenate(all_probs), np.concatenate(all_ids)


def write_outputs(out_dir: str, probs: np.ndarray, frame_ids: np.ndarray,
                  classes) -> list:
    """``probabilities.npy``, ``frames.txt`` and ``events.tsv`` under
    ``out_dir``; returns the events."""
    np.save(os.path.join(out_dir, "probabilities.npy"), probs)
    with open(os.path.join(out_dir, "frames.txt"), "w") as f:
        f.write("\n".join(str(i) for i in frame_ids) + "\n")
    events = label_runs(probs.argmax(axis=-1), frame_ids, probs)
    with open(os.path.join(out_dir, "events.tsv"), "w") as f:
        f.write("start\tend\tclass\tmean_prob\n")
        for s, e, c, p in events:
            f.write(f"{s}\t{e}\t{classes[c]}\t{p:.4f}\n")
    return events


def predict(args: argparse.Namespace, frames=None, stats: dict | None = None):
    """Label ``args.video`` (or ``frames``: an iterable of ``(frame index,
    RGB uint8 frame)``, already sampled, in its place) with the best epoch
    of ``args.model_id`` and write the outputs. ``stats`` (optional dict)
    gathers the prefetch's counters and ``classify_s``, the seconds from
    the first frame to the last probabilities. Returns ``(probs, frame_ids,
    events)``."""
    from tennis_torch.inference import load_classifier, resolve_device

    if frames is None and not args.video:
        raise ValueError("--video is required")
    device = resolve_device(args.device)
    stem = os.path.splitext(os.path.basename(args.video or "frames"))[0]
    out_dir = args.out_dir or os.path.join("predictions", stem)
    os.makedirs(out_dir, exist_ok=True)
    classes, predict_probs, _ = load_classifier(
        args.backbone, args.model_id, args.data_shape, args.root, device)

    if frames is None:
        frames = video_frames(args.video, args.every, args.max_frames)
    frames_dir = None
    if args.vis:
        frames_dir = os.path.join(out_dir, "frames")
        os.makedirs(frames_dir, exist_ok=True)
        frames = saving_frames(frames, frames_dir)

    tic = time.perf_counter()
    probs, frame_ids = classify(frames, predict_probs, args.batch_size,
                                args.data_shape, device, stats)
    seconds = time.perf_counter() - tic
    if stats is not None:
        stats["classify_s"] = seconds
    log.info("%d frames classified, %.1f frames/sec end to end", len(probs),
             len(probs) / max(seconds, 1e-6))

    events = write_outputs(out_dir, probs, frame_ids, classes)
    log.info("wrote %d events to %s", len(events),
             os.path.join(out_dir, "events.tsv"))

    if args.vis:
        from types import SimpleNamespace

        from tennis_torch.utils.visualisation import visualise_events

        results = {
            os.path.join(frames_dir, f"{i:010d}.jpg"): probs[k]
            for k, i in enumerate(frame_ids)
        }
        shim = SimpleNamespace(classes=classes, _frames_dir=frames_dir)
        out = visualise_events(shim, results,
                               os.path.join(out_dir, "results.mp4"),
                               fps=args.vis_fps)
        log.info("wrote %s", out)
    return probs, frame_ids, events


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return predict(parse_args(argv))


if __name__ == "__main__":
    main()
