"""Event-probability overlay video (counterpart of
``tennis_tpu/utils/visualisation.py``).

Renders, per frame: the frame itself, a scrolling per-frame confidence
history banner (bar height = max prob, coloured by predicted class, with a
GT strip when given), and a class legend row where the predicted class is
highlighted (green border if it matches GT, red otherwise). Output is an mp4
via OpenCV, imported when used. On the host, offline.
"""
from __future__ import annotations

import os

import numpy as np

COLOURS = (
    (148, 148, 148),
    (255, 176, 143), (214, 127, 235), (143, 195, 255), (142, 235, 164),
    (255, 243, 140), (255, 214, 148), (235, 131, 154), (162, 147, 255),
    (145, 235, 223), (208, 255, 145),
)

BANNER_HEIGHT = 75
CLS_BANNER_HEIGHT = 40
PRED_BORDER = 4


def visualise_events(dataset, results, video_path, gt=None, max_frames: int = -1,
                     fps: int = 30):
    """``results``: {frame_path: class-prob vector}; ``gt``: {frame_path:
    class idx}; ``dataset``: anything with ``classes`` and ``_frames_dir``.

    A frame path that does not exist as given is taken relative to the
    parent of the dataset's frames dir (results keyed on ``frames/...``).
    """
    import cv2

    classes = dataset.classes
    gt_height = 15 if gt is not None else 0
    order = sorted(results.keys())
    if max_frames > 0:
        order = order[:max_frames]
    if not order:
        raise ValueError("no results to visualise")

    def resolve(path):
        if os.path.exists(path):
            return path
        return os.path.join(os.path.dirname(dataset._frames_dir), path)

    first = cv2.imread(resolve(order[0]))
    if first is None:
        raise FileNotFoundError(resolve(order[0]))
    height, width = first.shape[:2]
    cls_width = width // len(classes)

    os.makedirs(os.path.dirname(os.path.abspath(video_path)), exist_ok=True)
    video = cv2.VideoWriter(
        video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
        (width, height + BANNER_HEIGHT + CLS_BANNER_HEIGHT),
    )
    canvas = np.zeros(
        (height + BANNER_HEIGHT + CLS_BANNER_HEIGHT, width, 3), dtype=np.uint8
    )

    for path in order:
        img = cv2.imread(resolve(path))
        if img is None:
            continue
        canvas[:height] = img
        # scroll the history banner left by one column
        banner = slice(height, height + BANNER_HEIGHT)
        canvas[banner, : width - 1] = canvas[banner, 1:]

        res = np.asarray(results[path])
        ind = int(np.argmax(res))
        bar = int((BANNER_HEIGHT - gt_height) * float(np.max(res)))
        canvas[banner, width - 1 :] = 0
        canvas[
            height + BANNER_HEIGHT - bar - gt_height : height + BANNER_HEIGHT
            - gt_height,
            width - 1 :,
        ] = COLOURS[ind]
        gtp = None
        if gt is not None:
            gtp = gt[path]
            canvas[
                height + BANNER_HEIGHT - int(gt_height * 0.9) : height
                + BANNER_HEIGHT - int(gt_height * 0.3),
                width - 1 :,
            ] = COLOURS[gtp]

        for c, cls in enumerate(classes):
            col = slice(c * cls_width, (c + 1) * cls_width)
            legend = slice(height + BANNER_HEIGHT + 2, None)
            if ind == c:
                border = (
                    (0, 255, 0) if (gtp is None or ind == gtp) else (0, 0, 255)
                )
                canvas[legend, col] = border if gtp is not None else (0, 0, 0)
                canvas[
                    height + BANNER_HEIGHT + 2 + PRED_BORDER : -PRED_BORDER,
                    c * cls_width + PRED_BORDER : (c + 1) * cls_width - PRED_BORDER,
                ] = COLOURS[c]
            else:
                canvas[legend, col] = COLOURS[c]
            canvas = cv2.putText(
                canvas, cls,
                (int((c + 0.5) * cls_width - 22),
                 height + BANNER_HEIGHT + CLS_BANNER_HEIGHT - 12),
                cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 1, cv2.LINE_AA,
            )
        video.write(canvas)

    video.release()
    return video_path
