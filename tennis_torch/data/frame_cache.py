"""One-time pre-resized frame cache (counterpart of
``tennis_tpu/data/frame_cache.py``).

Every epoch decodes the full-resolution JPEG of each frame and throws most
of its pixels away at the first Resize. This tool resizes the frames tree
once to that resize target (short side ``data_shape + 32``), so later epochs
decode only the pixels they keep. It is an opt-in speed/fidelity trade (one
JPEG re-encode at ``quality``, the resample moved from load time to build
time; ``PARITY.md`` D16), read through ``TennisSet(frames_cache=S)`` /
``--frames_cache S``. Reads fall back to the original tree per file, so a
partial cache is safe.

Build (one process-pool task per chunk directory, as frame extraction;
the workers are spawned, so a script calling ``build_frame_cache`` needs a
``__main__`` guard):

    python -m tennis_torch.data.frame_cache --root data --short 544
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor, as_completed


def cache_dir(root: str, short: int) -> str:
    """``<root>/frames_s<short>``: the cache mirror of ``<root>/frames``."""
    return os.path.join(root, f"frames_s{short}")


def _source_short_side(src: str):
    """True (undecoded) short side of ``src``, by the native header-only
    parse; else by a cv2 decode; None when neither reads it."""
    from tennis_torch.native.jpeg import jpeg_dims_file

    dims = jpeg_dims_file(src)
    if dims is not None:
        return min(dims)
    import cv2  # no native decoder: a full decode still beats a re-encode

    img = cv2.imread(src)
    return None if img is None else min(img.shape[:2])


def resize_encode_one(src: str, dst: str, short: int, quality: int = 95) -> bool:
    """Write ``dst`` as ``src`` resized to short side ``short``; returns
    whether a write happened. Fresh destinations (mtime >= the source's) are
    skipped. A source whose short side is already at most the target is
    copied verbatim: no re-encode generation loss.

    Writes land through a temporary file and an atomic ``os.replace``: the
    freshness check trusts mtime, so a build killed mid-write must never
    leave a truncated but fresh ``dst``."""
    if os.path.exists(dst) and os.path.getmtime(dst) >= os.path.getmtime(src):
        return False
    import cv2

    from tennis_torch.data.tennis_set import _read_image_rgb
    from tennis_torch.data.transforms import resize_shorter
    from tennis_torch.native.jpeg import HAVE_NATIVE_JPEG

    img = _read_image_rgb(src, min_short=short)  # DCT prescale where >= 2x
    tmp = f"{dst}.tmp.{os.getpid()}.jpg"  # cv2 needs the extension
    try:
        # A prescaled decode's short side is >= `short` whenever a scale
        # engaged, so a decode below the target proves the source is small:
        # copy it. At the target is ambiguous (a source of exactly that size,
        # or a 1/2^k prescale of a larger one): the header of the source
        # decides, and a possibly full-size original is never copied. Without
        # the native decoder no prescale engages, so the decoded shape is the
        # source's.
        decoded_short = min(img.shape[:2])
        if decoded_short < short or (
                decoded_short == short and
                (not HAVE_NATIVE_JPEG or _source_short_side(src) == short)):
            shutil.copyfile(src, tmp)
        else:
            if decoded_short > short:
                img = resize_shorter(img, short)
            ok = cv2.imwrite(tmp, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                             [cv2.IMWRITE_JPEG_QUALITY, quality])
            if not ok:
                raise IOError(f"failed to write {dst}")
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def _build_chunk(src_chunk: str, dst_chunk: str, short: int, quality: int):
    os.makedirs(dst_chunk, exist_ok=True)
    written = skipped = 0
    for name in sorted(os.listdir(src_chunk)):
        if not name.endswith(".jpg"):
            continue
        if resize_encode_one(os.path.join(src_chunk, name),
                             os.path.join(dst_chunk, name), short, quality):
            written += 1
        else:
            skipped += 1
    return written, skipped


def build_frame_cache(root: str, short: int, quality: int = 95,
                      workers: int | None = None) -> tuple[int, int]:
    """Mirror ``<root>/frames`` into :func:`cache_dir` at short side
    ``short``, one process-pool task per chunk directory. Re-runs are
    incremental: only stale or missing destinations are written. Returns
    (written, skipped)."""
    from tennis_torch.utils import Progress

    src_root = os.path.join(root, "frames")
    dst_root = cache_dir(root, short)
    if not os.path.isdir(src_root):
        raise FileNotFoundError(f"no frames tree at {src_root}")
    chunks = []
    for video in sorted(os.listdir(src_root)):
        vdir = os.path.join(src_root, video)
        if not os.path.isdir(vdir):
            continue
        for chunk in sorted(os.listdir(vdir)):
            cdir = os.path.join(vdir, chunk)
            if os.path.isdir(cdir):
                chunks.append((cdir, os.path.join(dst_root, video, chunk)))

    written = skipped = 0
    progress = Progress(len(chunks), "frame cache chunks", unit="chunks")
    with ProcessPoolExecutor(max_workers=workers or os.cpu_count() or 8,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        futures = [pool.submit(_build_chunk, s, d, short, quality)
                   for s, d in chunks]
        for f in as_completed(futures):
            w, s = f.result()
            written += w
            skipped += s
            progress.update()
    progress.close()
    return written, skipped


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="data", help="dataset root")
    p.add_argument("--short", type=int, default=544,
                   help="cache short side (data_shape + 32)")
    p.add_argument("--quality", type=int, default=95,
                   help="JPEG re-encode quality")
    p.add_argument("--workers", type=int, default=0,
                   help="process-pool size (0 = all cores)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    written, skipped = build_frame_cache(args.root, args.short,
                                         quality=args.quality,
                                         workers=args.workers or None)
    print(f"frame cache {cache_dir(args.root, args.short)}: "
          f"{written} written, {skipped} up to date")


if __name__ == "__main__":
    main()
