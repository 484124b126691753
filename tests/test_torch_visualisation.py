"""The event overlay video against the JAX package: ``visualise_events`` of
both packages on the same seeded results and frames, with and without
ground truth and with ``max_frames``, decode to the same frames pixel for
pixel; the empty-results refusal and the resolution of relative frame
paths. (``evaluate --vis`` against the JAX evaluator is in
``test_torch_extract.py``, beside its shared JAX driver run.)"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from tennis_tpu.utils import visualisation as jax_vis
from tennis_torch.utils import visualisation as vis

CLASSES = ["OTH", "SFI", "SFF", "SFL", "SNI", "SNF", "SNL", "HFL", "HFR",
           "HNL", "HNR"]


def decoded(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return np.stack(frames)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """14 seeded 49x120 frames under ``<root>/frames/V1.mp4/0000000000/``
    (an overlay of 164 rows: the decoder drops an odd last row), results
    keyed by the dataset-relative ``frames/...`` path, and labels."""
    import cv2

    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    chunk = root / "frames" / "V1.mp4" / "0000000000"
    os.makedirs(chunk)
    results, gt = {}, {}
    for i in range(14):
        cv2.imwrite(str(chunk / f"{i:010d}.jpg"),
                    rng.integers(0, 256, (49, 120, 3), dtype=np.uint8))
        key = f"frames/V1.mp4/0000000000/{i:010d}.jpg"
        results[key] = rng.dirichlet(np.ones(len(CLASSES)) * 0.3)
        gt[key] = int(rng.integers(0, len(CLASSES)))
    dataset = SimpleNamespace(classes=CLASSES,
                              _frames_dir=str(root / "frames"))
    return dataset, results, gt


@pytest.mark.parametrize("kwargs,n", [({}, 14), ({"gt": True}, 14),
                                      ({"max_frames": 5, "fps": 10}, 5)])
def test_overlay_equals_jax_pixel_for_pixel(scene, kwargs, n, tmp_path,
                                            monkeypatch):
    dataset, results, gt = scene
    monkeypatch.chdir(tmp_path)  # the keys resolve under the dataset root
    if kwargs.get("gt"):
        kwargs = {**kwargs, "gt": gt}
    ours = vis.visualise_events(dataset, results, str(tmp_path / "a" /
                                                      "ours.mp4"), **kwargs)
    theirs = jax_vis.visualise_events(dataset, results,
                                      str(tmp_path / "b" / "theirs.mp4"),
                                      **kwargs)
    assert ours == str(tmp_path / "a" / "ours.mp4")
    got, want = decoded(ours), decoded(theirs)
    assert got.shape == want.shape == (n, 49 + vis.BANNER_HEIGHT
                                       + vis.CLS_BANNER_HEIGHT, 120, 3)
    np.testing.assert_array_equal(got, want)


def test_constants_equal_jax():
    assert vis.COLOURS == jax_vis.COLOURS
    assert (vis.BANNER_HEIGHT, vis.CLS_BANNER_HEIGHT, vis.PRED_BORDER) == (
        jax_vis.BANNER_HEIGHT, jax_vis.CLS_BANNER_HEIGHT, jax_vis.PRED_BORDER)


def test_paths_resolve_and_empty_results_raise(scene, tmp_path, monkeypatch):
    dataset, results, _ = scene
    monkeypatch.chdir(tmp_path)
    root = os.path.dirname(dataset._frames_dir)
    absolute = {os.path.join(root, k): v for k, v in list(results.items())[:3]}
    out = vis.visualise_events(dataset, absolute, "rel/abs.mp4")
    assert out == "rel/abs.mp4" and decoded(out).shape[0] == 3
    relative = dict(list(results.items())[:3])
    np.testing.assert_array_equal(
        decoded(vis.visualise_events(dataset, relative, "rel.mp4")),
        decoded(out))
    with pytest.raises(ValueError, match="no results"):
        vis.visualise_events(dataset, {}, "none.mp4")
    missing = {"frames/V9.mp4/0000000000/0000000000.jpg": np.ones(11)}
    with pytest.raises(FileNotFoundError):
        vis.visualise_events(dataset, missing, "missing.mp4")
