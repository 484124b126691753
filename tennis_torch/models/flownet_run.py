"""Optical-flow generation over frame directories (counterpart of
``tennis_tpu/models/flownet_run.py``).

Adjacent frame pairs -> centre crop to /64 -> mean-subtract normalise ->
FlowNetS -> Middlebury colour image -> 4x bilinear upscale -> a mirrored
directory tree. Pairs go to the device in batches (``batch_size``, 8 by
default) as uint8 and are normalised there (:meth:`FlowRunner.flow_batch`);
:func:`normalise_pair` is the same function in numpy, its plain version.
The pre- and post-processing helpers are the JAX package's, line for line.
cv2 is imported inside the functions that decode or encode.
"""
from __future__ import annotations

import glob
import os
import numpy as np
import torch

UNKNOWN_FLOW_THRESH = 1e7


# ------------------------------------------------------------------ pre/post


def crop_to_64(img: np.ndarray) -> np.ndarray:
    """Centre crop so both sides divide by 64."""
    h, w = img.shape[:2]
    th, tw = (h // 64) * 64, (w // 64) * 64
    if th == h and tw == w:
        return img
    return img[(h - th) // 2 : (h + th) // 2, (w - tw) // 2 : (w + tw) // 2]


def normalise_pair(imgs: np.ndarray) -> np.ndarray:
    """(2, H, W, 3) uint8 -> mean-subtracted /255 float32 (the mean is per
    channel over both frames)."""
    imgs = imgs.astype(np.float32)
    mean = imgs.mean(axis=(0, 1, 2), keepdims=True)
    return (imgs - mean) / 255.0


def normalise_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W, 3) uint8 pairs -> :func:`normalise_pair` of each, on
    their device: the mean of each pair and channel from an exact integer
    sum."""
    count = pairs.shape[1] * pairs.shape[2] * pairs.shape[3]
    mean = pairs.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.int64)
    mean = (mean.double() / count).float()
    return (pairs.float() - mean) / 255.0


# --------------------------------------------------------- middlebury colours


def make_color_wheel() -> np.ndarray:
    """Middlebury colour wheel (55 entries)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col : col + RY, 0] = 255
    wheel[col : col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Flow components -> RGB via the colour wheel; NaN flow is black."""
    ncols = _WHEEL.shape[0]

    nan_mask = np.isnan(u) | np.isnan(v)
    u, v = np.where(nan_mask, 0, u), np.where(nan_mask, 0, v)

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = np.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0 - 1, c] / 255.0
        col1 = _WHEEL[k1 - 1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col = np.where(idx, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.uint8(np.floor(255 * col * (1 - nan_mask)))
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> RGB visualisation; unknown flow (|u| or |v| over
    1e7) is black."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    idx_unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (
        np.abs(v) > UNKNOWN_FLOW_THRESH
    )
    u[idx_unknown] = 0
    v[idx_unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1.0, float(rad.max()) if rad.size else -1.0)
    eps = np.finfo(float).eps
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[idx_unknown] = 0
    return img


# --------------------------------------------------------------- .flo format


def write_flo(path: str, flow: np.ndarray) -> None:
    """Middlebury .flo writer."""
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        h, w = flow.shape[:2]
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if abs(magic - 202021.25) >= 1e-3:
            raise ValueError(f"bad .flo magic in {path}")
        w, h = np.fromfile(f, np.int32, 2)
        return np.fromfile(f, np.float32, int(w) * int(h) * 2).reshape(h, w, 2)


# ----------------------------------------------------------------- inference


class FlowRunner:
    """Batched FlowNetS inference over frame pairs on ``device`` ("cuda"
    unless the caller asks for "cpu").

    The weights come from ``params`` (a flax params tree of numpy arrays, as
    the JAX ``FlowRunner`` takes it), else from ``params_path`` (a
    checkpoint holding ``{"params": ...}``, read with the port's own codec),
    else from a fresh init drawn from ``seed`` by the port's generator (its
    values differ from the JAX package's). A ``.npz`` of converted torch
    weights needs the weight converter, not ported yet.
    """

    def __init__(self, params=None, params_path=None, batch_size: int = 8,
                 seed: int = 0, device: str = "cuda"):
        from tennis_torch.bridge import load_flax
        from tennis_torch.inference import resolve_device
        from tennis_torch.models.flownet import FlowNetS

        self.device = resolve_device(device)
        self.batch_size = batch_size
        if params is None and params_path:
            if params_path.endswith(".npz"):
                raise NotImplementedError(
                    "a converted FlowNet-S .npz needs the weight converter, "
                    "not ported yet (ROADMAP.md slice 10)")
            if not os.path.exists(params_path):
                raise FileNotFoundError(params_path)
            from tennis_torch.utils import checkpoint as ckpt

            params = ckpt.load_raw(params_path)["params"]
        generator = torch.Generator().manual_seed(seed)
        self.model = FlowNetS(generator=generator)
        if params is not None:
            load_flax(self.model, {"params": params})
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def flow_batch(self, pairs: np.ndarray) -> np.ndarray:
        """(N, 2, H, W, 3) uint8 pairs -> (N, H/4, W/4, 2) f32 flow."""
        x = torch.from_numpy(np.ascontiguousarray(pairs, np.uint8))
        x = normalise_pairs(x.to(self.device, non_blocking=True))
        return self.model(x).cpu().numpy()


def process_video(input_path: str, output_path=None, params_path=None,
                  batch_size: int = 8, fps: int = 30, device: str = "cuda"):
    """Video file -> flow-visualisation video: decode frames, run
    adjacent-pair flow in device batches, write an mp4 of the colour
    images."""
    import cv2

    cap = cv2.VideoCapture(input_path)
    frames = []
    while True:
        ret, img = cap.read()
        if not ret or img is None:
            if len(frames) and not ret:
                break
            if len(frames) > 500:
                break
            continue
        frames.append(crop_to_64(cv2.cvtColor(img, cv2.COLOR_BGR2RGB)))
    cap.release()
    if len(frames) < 2:
        print(f"{input_path}: not enough frames for flow")
        return None

    runner = FlowRunner(params_path=params_path, batch_size=batch_size,
                        device=device)
    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + "_flow.mp4"
    h, w = frames[0].shape[:2]
    video = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                            (w, h))
    pairs = [np.stack([frames[i - 1], frames[i]]) for i in range(1, len(frames))]
    for start in range(0, len(pairs), batch_size):
        flows = runner.flow_batch(np.stack(pairs[start : start + batch_size]))
        for flow in flows:
            img = flow_to_image(flow)
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
            video.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    video.release()
    return output_path


def generate_flows(image_dir: str, flow_dir: str = "flow", params_path=None,
                   batch_size: int = 8, device: str = "cuda") -> None:
    """Adjacent-pair flow over every image under ``image_dir`` (recursive,
    sorted), written as 4x-upscaled colour images into the same tree under
    ``flow_dir``; frame 0 of a video has no predecessor and is skipped."""
    import cv2

    files = []
    for ext in (".jpg", ".png", ".jpeg", ".JPG", ".PNG", ".JPEG"):
        files = glob.glob(image_dir + "/**/*" + ext, recursive=True)
        if files:
            break
    if not files:
        print(f"Couldn't find any files in {image_dir}")
        return None
    files.sort()

    runner = FlowRunner(params_path=params_path, batch_size=batch_size,
                        device=device)

    pending = []  # (pair_paths, out_path)
    for i in range(1, len(files)):
        d, name = os.path.split(files[i])
        if int(os.path.splitext(name)[0]) == 0:
            continue
        out_dir = d.replace(os.path.normpath(image_dir),
                            os.path.normpath(flow_dir))
        pending.append(((files[i - 1], files[i]), os.path.join(out_dir, name)))

    from tennis_torch.utils import Progress

    progress = Progress(len(pending), f"flow {image_dir}", unit="pairs")
    for start in range(0, len(pending), batch_size):
        chunk = pending[start : start + batch_size]
        imgs = []
        for (a, b), _ in chunk:
            pa = crop_to_64(cv2.cvtColor(cv2.imread(a), cv2.COLOR_BGR2RGB))
            pb = crop_to_64(cv2.cvtColor(cv2.imread(b), cv2.COLOR_BGR2RGB))
            imgs.append(np.stack([pa, pb]))
        flows = runner.flow_batch(np.stack(imgs))
        for flow, (_, out_path) in zip(flows, chunk):
            img = flow_to_image(flow)
            img = cv2.resize(img, (img.shape[1] * 4, img.shape[0] * 4),
                             interpolation=cv2.INTER_LINEAR)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            cv2.imwrite(out_path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        progress.update(len(chunk))
    progress.close()
