"""The port's ``TennisSet`` against the JAX package's on the synthetic
fixture: the same samples, events, class counts, video lengths, windows and
feature paths, and bit-identical images (uint8) from ``__getitem__``, for
each split with and without ``save_feats``, seeded balancing, windows with
a stride, ``every``, ``feats_model``, the frames cache (hits and the
per-file fallback) and the 6-channel flow concat."""
import os

import cv2
import numpy as np
import pytest

from fixtures import VIDEO_EVENTS, build_fixture, frame_label
from tennis_tpu.data.tennis_set import TennisSet as JaxTennisSet
from tennis_tpu.data.tennis_set import get_feature_path as jax_feature_path
from tennis_tpu.data.tennis_set import get_image_path as jax_image_path
from tennis_torch.data.frame_cache import cache_dir
from tennis_torch.data.tennis_set import TennisSet

CACHE_SHORT = 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The fixture with flow frames, a 12-d feature store ``f12`` for every
    frame, and a frames cache (short side 16) holding every other frame."""
    root = build_fixture(tmp_path_factory.mktemp("ds"), with_flow=True)
    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = jax_feature_path(os.path.join(root, "features", "f12"),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.normal(size=(12,)).astype(np.float32))
            if frame % 2:
                continue
            src = jax_image_path(os.path.join(root, "frames"), video, frame)
            dst = jax_image_path(cache_dir(root, CACHE_SHORT), video, frame)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            img = cv2.imread(src)
            h, w = img.shape[:2]
            cv2.imwrite(dst, cv2.resize(
                img, (round(w * CACHE_SHORT / h), CACHE_SHORT)))
    return str(root)


CONFIGS = {
    "plain": dict(),
    "save_feats": dict(save_feats=True),
    "balance": dict(balance=True, balance_seed=3),
    "balance_save_feats": dict(balance=True, balance_seed=5, save_feats=True),
    "window4_stride2": dict(window=4, stride=2),
    "window8_every3": dict(window=8, every=3),
    "window1_every2": dict(every=2, save_feats=True),
    "feats_model": dict(feats_model="f12", window=4),
    "frames_cache": dict(frames_cache=CACHE_SHORT),
    "frames_cache_window": dict(frames_cache=CACHE_SHORT, window=4),
    "flow": dict(flow=True),
    "decode_short": dict(decode_short=40, model_id="m7"),
}


def _pair(root, split, kw):
    kw = {"balance": False, **kw}
    return (JaxTennisSet(root=root, split=split, **kw),
            TennisSet(root=root, split=split, **kw))


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_index_equals_jax(root, split, config):
    want, got = _pair(root, split, CONFIGS[config])
    assert len(got) == len(want) > 0
    assert got._samples == want._samples
    assert got._videos == want._videos
    assert got._events == want._events
    assert got._video_lengths == want._video_lengths
    assert got.class_counts() == want.class_counts()
    assert got.classes == want.classes and got.num_class == want.num_class
    assert got.feat_dir == want.feat_dir
    assert str(got) == str(want)
    for i in range(len(want)):
        assert got.window_frames(i) == want.window_frames(i)
        assert got.save_feature_path(i) == want.save_feature_path(i)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_getitem_equals_jax(root, config):
    """Every sample of the test split (train under save_feats: the ±255
    extension reaches every frame), bit for bit."""
    split = "train" if CONFIGS[config].get("save_feats") else "test"
    want, got = _pair(root, split, CONFIGS[config])
    for i in range(len(want)):
        img_w, label_w, idx_w = want[i]
        img_g, label_g, idx_g = got[i]
        assert (label_g, idx_g) == (label_w, idx_w)
        assert img_g.dtype == img_w.dtype and img_g.shape == img_w.shape
        np.testing.assert_array_equal(img_g, img_w)


def test_save_feats_extends_every_video(root):
    """The ±255 extension runs before the existence filter: each split
    covers every frame on disk, each labelled from its label file (which
    overrides the extension's 'OTH')."""
    _, got = _pair(root, "val", {"save_feats": True})
    frames = {(v, f) for v, f, _ in got._samples}
    assert frames == {(v, f) for v, ev in VIDEO_EVENTS.items()
                      for f in range(ev[-1][1])}
    assert all(c == frame_label(v, f) for v, f, c in got._samples)


def test_transform_applies_per_frame(root):
    seen = []

    def transform(img):
        seen.append(img.shape)
        return img[:4, :4]

    ds = TennisSet(root=root, split="test", balance=False, window=4,
                   transform=transform)
    img, _, _ = ds[0]
    assert img.shape == (4, 4, 4, 3) and len(seen) == 4


def test_missing_split_file_raises(root):
    with pytest.raises(FileNotFoundError, match="Split file"):
        TennisSet(root=root, split="nosuch", balance=False)
