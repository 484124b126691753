"""Dataset bootstrap: videos -> frames -> optical flow (counterpart of
``tennis_tpu/data/process.py``).

Run: ``python -m tennis_torch.data.process --root data`` (``<root>/videos``
in; ``<root>/frames`` and ``<root>/flow`` written). The flow runs FlowNet-S
on the GPU unless ``--device cpu``; ``--flownet_params`` takes a checkpoint
of ``{"params": ...}`` (a ``.npz`` of converted weights is not ported yet),
else the weights are a seeded random init.
"""
from __future__ import annotations

import argparse
import logging
import os

from tennis_torch.data.video import video_to_frames

DEFAULT_VIDEOS = ("V006", "V007", "V008", "V009", "V010")


def vid2img(videos=DEFAULT_VIDEOS, videos_dir="videos", frames_dir="frames"):
    for video in videos:
        video_to_frames(
            video_path=os.path.join(videos_dir, video + ".mp4"),
            frames_dir=frames_dir,
            chunk_size=1000,
        )


def img2flw(frames_dir="frames", flow_dir="flow", params_path=None,
            device="cuda"):
    from tennis_torch.models.flownet_run import generate_flows

    generate_flows(image_dir=frames_dir, flow_dir=flow_dir,
                   params_path=params_path, device=device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=".",
                   help="dataset root holding videos/ (frames/ and flow/ are "
                        "created under it)")
    p.add_argument("--videos", nargs="*", default=list(DEFAULT_VIDEOS),
                   help="video ids to process")
    p.add_argument("--skip_flow", action="store_true",
                   help="stop after frame extraction")
    p.add_argument("--flownet_params", default=None,
                   help="FlowNet-S checkpoint (default: random init)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device FlowNet-S runs on")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if not args.skip_flow:  # refuse before the extraction, not after it
        from tennis_torch.inference import resolve_device

        resolve_device(args.device)
        if (args.flownet_params or "").endswith(".npz"):
            raise NotImplementedError(
                "a converted FlowNet-S .npz needs the weight converter, not "
                "ported yet (ROADMAP.md slice 10)")
    print("Video to Images")
    vid2img(videos=args.videos,
            videos_dir=os.path.join(args.root, "videos"),
            frames_dir=os.path.join(args.root, "frames"))
    if not args.skip_flow:
        print("Images to Flow")
        img2flw(frames_dir=os.path.join(args.root, "frames"),
                flow_dir=os.path.join(args.root, "flow"),
                params_path=args.flownet_params, device=args.device)


if __name__ == "__main__":
    main()
