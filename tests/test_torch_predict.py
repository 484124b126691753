"""Raw-video labelling as a whole: the port's ``predict`` against the JAX
driver on one mp4 made from a fixture video, from one JAX-written
DenseNet121 experiment (data shape 32), at ``--every 2 --batch_size 8
--vis`` (30 sampled frames: a ragged last batch of 6, edge-padded); plus
``label_runs``, the flag surface, in-memory frames through the same
batches, and the refusal without a GPU.

Tolerances: probabilities within ``PROB_TOL`` (1e-2) absolute (both sides
run DenseNet121 in bf16 over 58 dense layers, summing in other orders);
``events.tsv`` equal where every top-1 agrees (the mean probabilities
printed to 4 decimals within 1e-2 otherwise)."""
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import build_fixture
from test_torch_extract import write_jax_experiment
from tennis_tpu import predict as jax_predict
from tennis_tpu.data.video import frames_to_video
from tennis_torch import predict

PROB_TOL = 1e-2
ARGV = ["--model_id=t1", "--backbone=DenseNet121", "--data_shape=32",
        "--batch_size=8", "--every=2", "--vis"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    return frames


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers over one mp4 (60 frames of a fixture video)."""
    work = tmp_path_factory.mktemp("work")
    root = build_fixture(tmp_path_factory.mktemp("ds"))
    old = os.getcwd()
    os.chdir(work)  # experiment dirs are cwd-relative
    try:
        write_jax_experiment(str(work))
        video_dir = os.path.join(root, "frames", sorted(
            os.listdir(os.path.join(root, "frames")))[0])
        mp4 = frames_to_video(video_dir, str(work / "clip.mp4"), fps=10)
        jax.devices()  # a live backend: the JAX driver skips its TPU probe
        out = {}
        for name, run in (("jax", lambda a: jax_predict.main(["predict"] + a)),
                          ("port", lambda a: predict.main(a + [
                              "--device=cpu"]))):
            out_dir = str(work / name)
            out[name] = dict(out_dir=out_dir, ret=run(
                [f"--video={mp4}", f"--root={root}", f"--out_dir={out_dir}",
                 *ARGV]))
        yield dict(work=work, root=root, mp4=mp4, **out)
    finally:
        os.chdir(old)


def test_label_runs_equals_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 17, 200):
        labels = rng.integers(0, 3, n)
        ids = np.cumsum(rng.integers(1, 4, n))
        probs = rng.dirichlet(np.ones(3), n)
        assert predict.label_runs(labels, ids, probs) == \
            jax_predict.label_runs(labels, ids, probs)
        got = predict.label_runs(labels, ids)
        want = jax_predict.label_runs(labels, ids)
        assert [e[:3] for e in got] == [e[:3] for e in want]
        assert all(np.isnan(e[3]) for e in got)
    assert predict.label_runs(np.array([1, 1, 2, 2, 2, 1]),
                              np.array([0, 2, 4, 6, 8, 10]),
                              np.eye(3)[[1, 1, 2, 2, 2, 1]]) == [
        (0, 2, 1, 1.0), (4, 8, 2, 1.0), (10, 10, 1, 1.0)]


def test_flags_equal_the_jax_driver():
    fl = jax_predict.FLAGS
    names = set(fl)
    got = vars(predict.parse_args([]))
    assert set(got) == names | {"device"}
    for name in names:
        assert got[name] == fl[name].default, name
    assert got["device"] == "cuda"
    assert predict.parse_args(["--vis"]).vis
    assert not predict.parse_args(["--novis"]).vis
    with pytest.raises(SystemExit):
        predict.parse_args(["--every=0"])


def test_predict_matches_the_jax_driver(runs):
    (p_w, ids_w, ev_w), (p_g, ids_g, ev_g) = runs["jax"]["ret"], \
        runs["port"]["ret"]
    assert p_g.shape == p_w.shape == (30, 11)
    np.testing.assert_allclose(p_g.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p_g, p_w, atol=PROB_TOL)
    np.testing.assert_array_equal(ids_g, np.arange(0, 60, 2))
    np.testing.assert_array_equal(ids_g, ids_w)
    files = {}
    for name in ("jax", "port"):
        d = runs[name]["out_dir"]
        files[name] = {f: open(os.path.join(d, f), "rb").read()
                       for f in ("frames.txt", "events.tsv")}
        np.testing.assert_array_equal(
            np.load(os.path.join(d, "probabilities.npy")),
            runs[name]["ret"][0])
    assert files["port"]["frames.txt"] == files["jax"]["frames.txt"]
    if (p_g.argmax(-1) == p_w.argmax(-1)).all():
        assert [e[:3] for e in ev_g] == [e[:3] for e in ev_w]
        np.testing.assert_allclose([e[3] for e in ev_g],
                                   [e[3] for e in ev_w], atol=PROB_TOL)
        if all(round(a[3], 4) == round(b[3], 4) for a, b in zip(ev_g, ev_w)):
            assert files["port"]["events.tsv"] == files["jax"]["events.tsv"]
    assert ev_g == predict.label_runs(p_g.argmax(-1), ids_g, p_g)
    assert ev_g[0][0] == 0 and ev_g[-1][1] == 58  # the runs tile [0, 58]
    assert all(a[1] + 2 == b[0] for a, b in zip(ev_g, ev_g[1:]))


def test_vis_writes_the_jax_overlay_and_frames(runs):
    jpgs = {}
    for name in ("jax", "port"):
        d = os.path.join(runs[name]["out_dir"], "frames")
        jpgs[name] = {f: open(os.path.join(d, f), "rb").read()
                      for f in sorted(os.listdir(d))}
    assert list(jpgs["port"]) == [f"{i:010d}.jpg" for i in range(0, 60, 2)]
    assert jpgs["port"] == jpgs["jax"]
    got = decoded(os.path.join(runs["port"]["out_dir"], "results.mp4"))
    want = decoded(os.path.join(runs["jax"]["out_dir"], "results.mp4"))
    assert len(got) == len(want) == 30
    assert got[0].shape == want[0].shape


def test_in_memory_frames_give_the_video_probabilities(runs):
    """The decoded mp4, sampled by ``sample_frames`` and fed to ``predict``
    past the decoder, gives the mp4 run's outputs exactly."""
    import cv2

    frames = (cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in decoded(runs["mp4"]))
    out_dir = str(runs["work"] / "memory")
    args = predict.parse_args([f"--root={runs['root']}",
                               f"--out_dir={out_dir}", "--device=cpu",
                               *ARGV[:-1]])
    old = os.getcwd()
    os.chdir(runs["work"])
    try:
        stats = {}
        probs, ids, events = predict.predict(
            args, predict.sample_frames(frames, every=2), stats)
    finally:
        os.chdir(old)
    want_probs, want_ids, want_events = runs["port"]["ret"]
    np.testing.assert_array_equal(probs, want_probs)
    np.testing.assert_array_equal(ids, want_ids)
    assert events == want_events
    assert stats["batches"] == 4 and stats["classify_s"] > 0
    assert not os.path.exists(os.path.join(out_dir, "results.mp4"))
    # the batcher: three full batches and an edge-padded one of 6
    batches = list(predict.frame_batches(
        ((i, np.full((24, 32, 3), i, np.uint8)) for i in range(0, 60, 2)), 8,
        32))
    assert [n for _, _, n in batches] == [8, 8, 8, 6]
    images, last_ids, _ = batches[-1]
    assert images.shape == (8, 32, 32, 3)
    assert last_ids == [48, 50, 52, 54, 56, 58, 58, 58]
    assert (images[6:] == 58).all()
    assert list(predict.sample_frames(range(10), 3, max_frames=3)) == [
        (0, 0), (3, 3), (6, 6)]


def test_predict_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        predict.main(["--video=clip.mp4"])
    with pytest.raises(ValueError, match="--video"):
        predict.main(["--device=cpu"])


def test_resize_shorter_passes_an_image_at_its_size():
    """At a short side of ``size`` already, ``resize_shorter`` returns the
    frame itself, bit for bit what cv2's resize to the same size gives (so
    ``test_geometry`` needs no cv2 for a 544x968 frame at 512); at other
    sizes it resizes as before, as the JAX package's does."""
    import cv2

    from tennis_tpu.data.transforms import resize_shorter as jax_resize
    from tennis_torch.data.transforms import resize_shorter, test_geometry

    rng = np.random.default_rng(1)
    for shape, size in (((544, 968, 3), 544), ((968, 544, 3), 544),
                        ((64, 64, 3), 64)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert resize_shorter(img, size) is img
        np.testing.assert_array_equal(
            cv2.resize(img, shape[1::-1], interpolation=cv2.INTER_LINEAR), img)
        np.testing.assert_array_equal(jax_resize(img, size), img)
    img = rng.integers(0, 256, (544, 968, 3), dtype=np.uint8)
    np.testing.assert_array_equal(test_geometry(img, 512),
                                  img[16:528, 228:740])
    for shape, size in (((720, 1280, 3), 544), ((24, 32, 3), 64),
                        ((545, 968, 3), 544)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = resize_shorter(img, size)
        assert min(got.shape[:2]) == size
        np.testing.assert_array_equal(got, jax_resize(img, size))
