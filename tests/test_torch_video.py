"""The video tooling and the dataset bootstrap against the JAX package:
``extract_frames``, ``video_to_frames`` (chunk directories, worker
processes) and ``frames_to_video`` write the same files byte for byte, and
the ``process`` CLI gives the same frames tree, with ``--skip_flow`` and
with FlowNet-S (the same flax weights loaded into both) the same flow tree,
and ``process_video`` the same flow video.

Tolerance for the flow images: both packages run FlowNet-S in bf16, at
other rounding points, so a flow image may differ where the colour wheel
turns fast (by up to 45 grey levels at a pixel here); the decoded images of a
pair lie within ``FLOW_MEAN_TOL`` (2) grey levels of each other on average
(0.41-0.80 measured) and ``FLOW_P99_TOL`` (8) at the 99th percentile (3-4).
The flow video of ``process_video`` is mp4v-coded, whose predicted frames
carry the gap forward: ``VIDEO_MEAN_TOL`` (4; 0.94-2.34 measured) and
``VIDEO_P99_TOL`` (16; 5-9)."""
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tennis_tpu.data import process as jax_process
from tennis_tpu.data import video as jax_video
from tennis_tpu.models.flownet import FlowNetS as JaxFlowNetS
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch.data import process, video

FLOW_MEAN_TOL = 2.0
FLOW_P99_TOL = 8.0
VIDEO_MEAN_TOL = 4.0
VIDEO_P99_TOL = 16.0
FRAMES = {"V1": 12, "V2": 7}


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
            if os.path.isfile(p)}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """``<root>/videos/{V1,V2}.mp4``: 64x128 frames of a drifting pattern,
    written by the JAX package's ``frames_to_video``."""
    import cv2

    root = tmp_path_factory.mktemp("ds")
    os.makedirs(root / "videos")
    yy, xx = np.mgrid[0:64, 0:128].astype(np.float32)
    for name, n in FRAMES.items():
        src = root / "src" / name
        os.makedirs(src)
        for t in range(n):
            img = np.stack([
                128 + 100 * np.sin((xx + 3 * t) / 9.0 + k) * np.cos(
                    (yy - 2 * t) / 7.0) for k in range(3)], -1)
            cv2.imwrite(str(src / f"{t:04d}.png"), img.astype(np.uint8))
        jax_video.frames_to_video(str(src), str(root / "videos" / name),
                                  fps=10)
    return root


def test_extract_frames_equals_jax(videos, tmp_path):
    mp4 = str(videos / "videos" / "V1.mp4")
    for kwargs in ({}, {"start": 2, "end": 9, "every": 3}):
        ours, theirs = tmp_path / "ours", tmp_path / "theirs"
        got = video.extract_frames(mp4, str(ours), **kwargs)
        want = jax_video.extract_frames(mp4, str(theirs), **kwargs)
        assert got == want > 0
        assert tree(ours) == tree(theirs)
        assert got == video.extract_frames(mp4, str(ours), overwrite=True,
                                           **kwargs)
        assert video.extract_frames(mp4, str(ours), **kwargs) == 0
        shutil.rmtree(ours)
        shutil.rmtree(theirs)
    with pytest.raises(FileNotFoundError):
        video.extract_frames(str(videos / "none.mp4"), str(tmp_path))


def test_video_to_frames_writes_the_jax_chunks(videos, tmp_path):
    mp4 = str(videos / "videos" / "V1.mp4")
    got = video.video_to_frames(mp4, str(tmp_path / "ours"), chunk_size=5,
                                max_workers=2)
    want = jax_video.video_to_frames(mp4, str(tmp_path / "theirs"),
                                     chunk_size=5, max_workers=2)
    assert os.path.relpath(got, tmp_path / "ours") == \
        os.path.relpath(want, tmp_path / "theirs") == "V1.mp4"
    assert sorted(os.listdir(got)) == ["0000000000", "0000000005",
                                       "0000000010"]
    files = tree(tmp_path / "ours")
    assert files == tree(tmp_path / "theirs")
    assert len(files) == 11  # the last chunk stops one short, as the JAX one


def test_frames_to_video_equals_jax(videos, tmp_path):
    src = str(videos / "src" / "V2")
    got = video.frames_to_video(src, str(tmp_path / "ours"), fps=10)
    want = jax_video.frames_to_video(src, str(tmp_path / "theirs"), fps=10)
    assert got.endswith("ours.mp4") and want.endswith("theirs.mp4")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert video.frames_to_video(str(tmp_path / "empty"),
                                 str(tmp_path / "x")) is None


def _copy(videos, dst):
    os.makedirs(dst / "videos")
    for name in FRAMES:
        shutil.copy(videos / "videos" / f"{name}.mp4", dst / "videos")
    return dst


def test_process_skip_flow_writes_the_jax_frames(videos, tmp_path):
    ours, theirs = _copy(videos, tmp_path / "ours"), _copy(videos,
                                                           tmp_path / "theirs")
    argv = ["--videos", *FRAMES, "--skip_flow"]
    process.main([f"--root={ours}", *argv])
    jax_process.main([f"--root={theirs}", *argv])
    frames = tree(ours / "frames")
    assert frames == tree(theirs / "frames")
    assert len(frames) == sum(n - 1 for n in FRAMES.values())
    assert not os.path.exists(ours / "flow")


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """A FlowNet-S checkpoint of flax's init, ``{"params": ...}``, written
    by the JAX package."""
    variables = jax.jit(JaxFlowNetS().init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 2, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "flownet.params")
    jax_ckpt.save_state(path, variables)
    return path


def within_tolerance(a, b, where, mean_tol=FLOW_MEAN_TOL,
                     p99_tol=FLOW_P99_TOL):
    gap = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert gap.mean() <= mean_tol, where
    assert np.percentile(gap, 99) <= p99_tol, where


def test_process_with_flow_writes_the_jax_flow_tree(videos, params, tmp_path):
    """The same frames, the same flow files (frame 0 of each video
    skipped), each image within the tolerances of the JAX package's."""
    import cv2

    ours, theirs = _copy(videos, tmp_path / "ours"), _copy(videos,
                                                           tmp_path / "theirs")
    argv = ["--videos", *FRAMES, f"--flownet_params={params}"]
    process.main([f"--root={ours}", "--device=cpu", *argv])
    jax_process.main([f"--root={theirs}", *argv])
    assert tree(ours / "frames") == tree(theirs / "frames")
    got, want = tree(ours / "flow"), tree(theirs / "flow")
    assert set(got) == set(want)
    assert len(got) == sum(n - 2 for n in FRAMES.values())
    assert not any(p.endswith("0000000000.jpg") for p in got)
    for rel in sorted(got):
        a = cv2.imread(str(ours / "flow" / rel))
        b = cv2.imread(str(theirs / "flow" / rel))
        assert a.shape == b.shape == (64, 128, 3)
        within_tolerance(a, b, rel)


def test_process_video_writes_the_jax_flow_video(videos, params, tmp_path):
    """A video's adjacent-pair flow as an mp4 of its frames' size: one
    frame a pair, each within the tolerances of the JAX package's."""
    import cv2

    from tennis_tpu.models.flownet_run import \
        process_video as jax_process_video
    from tennis_torch.models.flownet_run import process_video

    mp4 = str(videos / "videos" / "V1.mp4")
    got = process_video(mp4, str(tmp_path / "ours.mp4"), params_path=params,
                        fps=10, device="cpu")
    want = jax_process_video(mp4, str(tmp_path / "theirs.mp4"),
                             params_path=params, fps=10)
    frames = {}
    for name, path in (("ours", got), ("theirs", want)):
        cap = cv2.VideoCapture(path)
        frames[name] = []
        while (read := cap.read())[0]:
            frames[name].append(read[1])
        cap.release()
    assert len(frames["ours"]) == len(frames["theirs"]) == FRAMES["V1"] - 1
    for i, (a, b) in enumerate(zip(frames["ours"], frames["theirs"])):
        assert a.shape == b.shape == (64, 128, 3)
        within_tolerance(a, b, i, VIDEO_MEAN_TOL, VIDEO_P99_TOL)


def test_process_refuses_npz_before_extracting(videos, tmp_path):
    root = _copy(videos, tmp_path / "ds")
    with pytest.raises(NotImplementedError, match="slice 10"):
        process.main([f"--root={root}", "--device=cpu",
                      "--flownet_params=w.npz"])
    assert not os.path.exists(root / "frames")
