"""Video <-> frame tooling (counterpart of ``tennis_tpu/data/video.py``).

Offline and on the host: chunked multi-process frame extraction with a
bounded skip of bad reads, and a recursive frames -> mp4 writer. Chunk
directories are named by the chunk's first frame (``{start:010d}``), the
dataset's path scheme (``tennis_set.get_image_path``). cv2 is imported
inside the functions that use it. ``video_to_frames`` spawns its workers
(forking a process that runs threads is unsafe), so a script that calls it
does so under ``if __name__ == "__main__":``.
"""
from __future__ import annotations

import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed

CHUNK_SIZE = 1000


def extract_frames(video_path, frames_dir, overwrite=False, start=-1, end=-1,
                   every=1, while_safety_limit=500):
    """Extract frames [start, end) of one chunk with OpenCV; returns the
    number saved. A failed read (OpenCV now and then returns None mid-video)
    is skipped, at most ``while_safety_limit`` times in a row."""
    import cv2

    video_path = os.path.normpath(video_path)
    frames_dir = os.path.normpath(frames_dir)
    _, video_filename = os.path.split(video_path)
    if not os.path.exists(video_path):
        raise FileNotFoundError(video_path)

    capture = cv2.VideoCapture(video_path)
    if start < 0:
        start = 0
    if end < 0:
        end = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))

    capture.set(cv2.CAP_PROP_POS_FRAMES, start)
    # cv2.imwrite fails silently into a missing directory
    os.makedirs(os.path.join(frames_dir, video_filename, f"{start:010d}"),
                exist_ok=True)
    frame = start
    while_safety = 0
    saved_count = 0
    while frame < end:
        ret, image = capture.read()
        if while_safety > while_safety_limit:
            break
        if not ret or image is None:
            while_safety += 1
            continue
        if frame % every == 0:
            while_safety = 0
            save_path = os.path.join(
                frames_dir, video_filename, f"{start:010d}", f"{frame:010d}.jpg"
            )
            if overwrite or not os.path.exists(save_path):
                cv2.imwrite(save_path, image)
                saved_count += 1
        frame += 1
    capture.release()
    return saved_count


def video_to_frames(video_path, frames_dir, overwrite=False, every=1,
                    chunk_size=CHUNK_SIZE, max_workers=None):
    """Extract a whole video in parallel chunks of ``chunk_size`` frames,
    one worker process a chunk. Returns the video's frames dir, or None for
    a video without frames."""
    import cv2

    video_path = os.path.normpath(video_path)
    frames_dir = os.path.normpath(frames_dir)
    _, video_filename = os.path.split(video_path)

    capture = cv2.VideoCapture(video_path)
    total = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    capture.release()
    if total < 1:
        print("Video has no frames; check the OpenCV/ffmpeg install.")
        return None

    chunks = [[i, i + chunk_size] for i in range(0, total, chunk_size)]
    chunks[-1][-1] = min(chunks[-1][-1], total - 1)
    for start, _ in chunks:
        os.makedirs(
            os.path.join(frames_dir, video_filename, f"{start:010d}"), exist_ok=True
        )

    workers = max_workers or multiprocessing.cpu_count()
    from tennis_torch.utils import Progress

    progress = Progress(total, f"extracting {video_filename}", unit="frames")
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as executor:
        futures = [
            executor.submit(extract_frames, video_path, frames_dir, overwrite,
                            c[0], c[1], every)
            for c in chunks
        ]
        for f in as_completed(futures):
            f.result()  # a worker's exception surfaces here
            progress.update(chunk_size)
    progress.close()
    return os.path.join(frames_dir, video_filename)


def frames_to_video(frames_dir, video_path, fps=30):
    """Write every frame under ``frames_dir`` (recursive, sorted; the first
    extension of .jpg, .png, .jpeg and their capitals that matches) to an
    mp4."""
    import cv2

    frames_dir = os.path.normpath(frames_dir)
    video_path = os.path.normpath(video_path)
    if not video_path.endswith(".mp4"):
        video_path += ".mp4"

    files = []
    for ext in (".jpg", ".png", ".jpeg", ".JPG", ".PNG", ".JPEG"):
        files = glob.glob(frames_dir + "/**/*" + ext, recursive=True)
        if files:
            break
    if not files:
        print(f"Couldn't find any files in {frames_dir}")
        return None
    files.sort()

    image = cv2.imread(files[0])
    height, width = image.shape[:2]
    video = cv2.VideoWriter(
        video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
    )
    for filename in files:
        video.write(cv2.imread(filename))
    video.release()
    return video_path
