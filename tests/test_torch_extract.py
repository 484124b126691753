"""The feature-dump and evaluation slice as a whole: the port's ``train
--save_feats`` and ``evaluate`` against the JAX drivers on two copies of
the synthetic fixture, from one JAX-written DenseNet121 experiment (data
shape 32) with two epochs and ``scores.txt``; plus the flag surfaces, the
refusals, ``--vis`` (the trainer accepts it and does nothing, as the JAX
one; the evaluator renders ``results.mp4``) and the resume scan.

Tolerances: features within ``LOGIT_TOL`` (5e-2) of max |JAX feature| per
file, probabilities within 1e-2 absolute (both sides run DenseNet121 in
bf16 over 58 dense layers, summing in other orders)."""
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from absl import app, flags

from fixtures import build_fixture
from tennis_tpu import evaluate as jax_evaluate
from tennis_tpu import train as jax_train
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch import evaluate, train
from tennis_torch.utils import checkpoint as ckpt

LOGIT_TOL = 5e-2
PROB_TOL = 1e-2
MODEL_ID = "t1"
COMMON = ["--backbone=DenseNet121", "--data_shape=32", "--batch_size=16",
          "--num_workers=2", f"--model_id={MODEL_ID}"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _abstract_state():
    from tennis_tpu.models import FrameModel, get_backbone
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    model = FrameModel(get_backbone("densenet121", dtype=jnp.bfloat16),
                       num_classes=11, dtype=jnp.bfloat16)
    tx, _ = sgd_with_schedule(0.001)
    return jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        tx, {"train": True}))


def _random_state(abstract, seed):
    """A TrainState of seeded numpy leaves: kernels with variance 1/fan_in,
    BN scales around 1 and statistics away from (0, 1), optimizer zeros."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        name, shape = keys[-1], leaf.shape
        if keys[0] == "params" and name == "kernel":
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif keys[0] == "params" and name == "scale":
            value = rng.uniform(0.5, 1.5, shape)
        elif keys[0] == "batch_stats" and name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif keys[0] in ("params", "batch_stats"):  # biases and means
            value = rng.standard_normal(shape) * 0.1
        else:  # step and optimizer state
            value = np.zeros(shape)
        return np.asarray(value, dtype=leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def write_jax_experiment(base, model_id=MODEL_ID):
    """``<base>/models/vision/experiments/<model_id>``, written by the JAX
    package: epoch 0 (score 0.7, the best) and epoch 1 (score 0.3, the
    newest), each of its own seeded weights. Returns the dir and the
    abstract state."""
    abstract = _abstract_state()
    exp = os.path.join(base, "models", "vision", "experiments", model_id)
    os.makedirs(exp, exist_ok=True)
    for epoch, score in ((0, 0.7), (1, 0.3)):
        jax_ckpt.save_state(jax_ckpt.epoch_path(exp, epoch),
                            _random_state(abstract, 10 + epoch))
        jax_ckpt.append_score(exp, epoch, score)
    return exp, abstract


def run_jax(main, argv):
    """One JAX driver run through absl, its flags reset before and after
    (absl keeps a parsed flag's value across runs in one process, and a
    later test file in the same worker parses only the flags it sets);
    returns what ``main`` returned."""
    flags.FLAGS.unparse_flags()
    out = {}

    def run(_argv):
        out["value"] = main()

    try:
        app.run(run, argv=["driver"] + argv)
    except SystemExit:
        pass
    finally:
        flags.FLAGS.unparse_flags()
    return out.get("value")


def feature_files(root, model_id=MODEL_ID):
    base = os.path.join(root, "features", model_id)
    return sorted(os.path.relpath(p, base) for p in
                  glob.glob(os.path.join(base, "**", "*.npy"), recursive=True))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Two copies of the fixture, the experiment, and both drivers'
    ``--save_feats`` dumps."""
    workdir = tmp_path_factory.mktemp("work")
    jax_root = build_fixture(tmp_path_factory.mktemp("jax_ds"))
    port_root = build_fixture(tmp_path_factory.mktemp("port_ds"))
    old = os.getcwd()
    os.chdir(workdir)  # experiment dirs are cwd-relative
    try:
        exp, abstract = write_jax_experiment(str(workdir))
        run_jax(jax_train.train_and_evaluate,
                [f"--root={jax_root}", "--num_devices=1", "--save_feats",
                 *COMMON])
        report = train.main([f"--root={port_root}", "--save_feats",
                             "--device=cpu", *COMMON])
        yield dict(workdir=str(workdir), exp=exp, abstract=abstract,
                   jax_root=jax_root, port_root=port_root, report=report)
    finally:
        os.chdir(old)


def test_save_feats_writes_the_jax_tree(env):
    """The same .npy paths (every frame of the fixture), each f32 of the
    same shape, values within LOGIT_TOL of max |JAX feature|."""
    want = feature_files(env["jax_root"])
    got = feature_files(env["port_root"])
    n_frames = len(glob.glob(os.path.join(env["port_root"], "frames", "**",
                                          "*.jpg"), recursive=True))
    assert got == want and len(got) == n_frames == 120
    for rel in got:
        w = np.load(os.path.join(env["jax_root"], "features", MODEL_ID, rel))
        g = np.load(os.path.join(env["port_root"], "features", MODEL_ID, rel))
        assert g.dtype == w.dtype == np.float32
        assert g.shape == w.shape == (1024,)
        assert np.abs(g - w).max() <= LOGIT_TOL * np.abs(w).max(), rel
    report = env["report"]
    assert list(report) == ["train", "val", "test"]
    assert all(r["files"] == 120 for r in report.values())


def test_save_feats_dumps_the_best_epoch(env):
    """The newest epoch (1) is read first, then the best (0) dumped: the
    dump equals epoch 0's features and is far from epoch 1's."""
    from tennis_torch.data import transforms as tf
    from tennis_torch.data.tennis_set import TennisSet
    from tennis_torch.inference import make_extract_features

    log = open(os.path.join(env["exp"], "log.txt")).read()
    assert "resumed from epoch 1" in log
    assert "dumping features from best epoch 0 (score=0.7000)" in log
    ds = TennisSet(root=env["port_root"], split="test", balance=False,
                   model_id=MODEL_ID, save_feats=True)
    idx = [0, 57, 119]
    images = np.stack([tf.test_geometry(ds[i][0], 32) for i in idx])
    dumped = np.stack([np.load(ds.save_feature_path(i)) for i in idx])
    for epoch, close in ((0, True), (1, False)):
        model = train.build_model(train.parse_args(COMMON), 11)
        train.load_epoch(model, env["exp"], epoch)
        feats = make_extract_features(model, torch.device("cpu"))(images)
        err = np.abs(feats.numpy() - dumped).max() / np.abs(dumped).max()
        assert (err <= LOGIT_TOL) == close, (epoch, err)


@pytest.fixture(scope="module")
def evaluated(env):
    """Both evaluators with ``--vis``; the JAX one's ``results.mp4`` is
    moved aside to ``<workdir>/jax_results.mp4`` before the port writes
    its own into the same experiment."""
    metrics = {k: os.path.join(env["workdir"], f"metrics_{k}.json")
               for k in ("jax", "port")}
    want = run_jax(jax_evaluate.evaluate_model,
                   [f"--root={env['jax_root']}", "--vis",
                    f"--metrics_out={metrics['jax']}", *COMMON])
    os.replace(os.path.join(env["exp"], "results.mp4"),
               os.path.join(env["workdir"], "jax_results.mp4"))
    got = evaluate.main([f"--root={env['port_root']}", "--device=cpu",
                         "--vis", f"--metrics_out={metrics['port']}",
                         *COMMON])
    return want, got, metrics


def test_evaluate_matches_jax(evaluated):
    (res_w, gts_w, _), (res_g, gts_g, m_g), paths = evaluated
    assert set(res_g) == set(res_w) and len(res_g) == 20
    assert gts_g == gts_w
    top1 = True
    for key, p in res_w.items():
        assert res_g[key].shape == p.shape == (11,)
        np.testing.assert_allclose(res_g[key].sum(), 1.0, atol=1e-5)
        np.testing.assert_allclose(res_g[key], p, atol=PROB_TOL, err_msg=key)
        top1 &= int(np.argmax(res_g[key])) == int(np.argmax(p))
    dumped_w = json.load(open(paths["jax"]))
    dumped_g = json.load(open(paths["port"]))
    assert set(dumped_g) == set(dumped_w)
    assert dumped_g == m_g["prf1"].get_dict()
    if top1:  # the same decisions give the same scores
        assert dumped_g == dumped_w


def test_evaluate_save_feats_dumps_its_split_only(env, monkeypatch):
    from tennis_torch.data.tennis_set import TennisSet

    val = TennisSet(root=env["port_root"], split="val", balance=False,
                    model_id=MODEL_ID, save_feats=True)
    paths = [val.save_feature_path(i) for i in range(len(val))]
    before = {p: np.load(p) for p in paths}
    for p in paths:
        os.remove(p)
    dumped = []
    real = train.save_features

    def spy(extract, datasets, loaders, device):
        dumped.extend(ds._split for ds in datasets)
        return real(extract, datasets, loaders, device)

    monkeypatch.setattr(train, "save_features", spy)
    monkeypatch.chdir(env["workdir"])
    assert evaluate.main([f"--root={env['port_root']}", "--device=cpu",
                          "--split=val", "--save_feats", *COMMON]) == ({}, {},
                                                                      {})
    assert dumped == ["val"]
    for p, want in before.items():
        got = np.load(p)
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_flags_equal_the_jax_drivers():
    """Every flag of the JAX train and evaluate drivers, by name and
    default, plus --device; --num_gpus is --num_devices; absl booleans."""
    fl = flags.FLAGS
    for jax_mod, parse, extra in (
            (jax_train, train.parse_args, set()),
            (jax_evaluate, evaluate.parse_args, {"split", "metrics_out"})):
        names = {f.name for f in fl.get_flags_for_module(jax_train.__name__)}
        names |= extra
        names.discard("num_gpus")  # an alias of num_devices
        got = vars(parse([]))
        assert set(got) == names | {"device"}, set(got) ^ names
        for name in names:
            assert got[name] == fl[name].default, name
        assert got["device"] == "cuda"
    assert train.parse_args(["--num_gpus=4"]).num_devices == 4
    for argv, want in ((["--save_feats"], True), (["--save_feats=false"], False),
                       (["--nosave_feats"], False), (["--vis=true"], True)):
        args = train.parse_args(argv)
        assert (args.save_feats or args.vis) == want, argv
    assert train.parse_args(["--every=2,3,4"]).every == ["2", "3", "4"]


@pytest.mark.parametrize("argv,error,match", [
    # multi-device runs are ported; what the JAX driver refuses of them
    # raises: --multihost without its coordinator, a global batch that does
    # not divide across the devices (tennis_tpu/train.py:286-288)
    pytest.param(["--save_feats", "--multihost"], ValueError, "coordinator",
                 id="argv1-multi-device"),
    pytest.param(["--save_feats", "--num_devices=2", "--batch_size=7"],
                 ValueError, "must divide across 2 devices",
                 id="argv2-multi-device"),
    pytest.param(["--save_feats", "--pretrained_npz=w.npz"],
                 NotImplementedError, "pretrained_npz",
                 id="argv3-pretrained_npz"),
])
def test_train_refuses_what_is_not_ported(argv, error, match, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        train.main(argv + ["--device=cpu"])


def test_train_vis_save_feats_dumps_as_without_vis(env, monkeypatch):
    """``--vis``, once refused, is accepted and does nothing, as in the JAX
    trainer: ``--vis --save_feats`` dumps the files of ``--save_feats``."""
    before = {rel: np.load(os.path.join(env["port_root"], "features",
                                        MODEL_ID, rel))
              for rel in feature_files(env["port_root"])}
    monkeypatch.chdir(env["workdir"])
    report = train.main([f"--root={env['port_root']}", "--save_feats",
                         "--vis", "--device=cpu", *COMMON])
    assert feature_files(env["port_root"]) == sorted(before)
    for rel, want in before.items():
        got = np.load(os.path.join(env["port_root"], "features", MODEL_ID,
                                   rel))
        np.testing.assert_array_equal(got, want, err_msg=rel)
    assert {k: r["files"] for k, r in report.items()} == \
        {k: r["files"] for k, r in env["report"].items()}


@pytest.mark.parametrize("argv", [[], ["--flow=twos"]])
def test_default_backbone_trains(argv, tmp_path, monkeypatch):
    """The default flags (``resnet18_v2``), framewise and as the two-stream
    net, once refused, train: one epoch of one batch on the fixture."""
    root = build_fixture(tmp_path / "ds", with_flow=True)
    monkeypatch.chdir(tmp_path)
    state = train.main(argv + [f"--root={root}", "--data_shape=32",
                               "--batch_size=8", "--epochs=1",
                               "--max_batches=1", "--every=1,8,8",
                               "--num_workers=1", "--model_id=d",
                               "--device=cpu"])
    tree = ckpt.load_raw(str(tmp_path / "models" / "vision" / "experiments"
                             / "d" / "0000.params"))
    assert int(tree["step"]) == state.step == 1
    stream = tree["params"]["model_flow"] if argv else \
        tree["params"]["backbone"]
    assert "stage3_block1" in stream


@pytest.mark.parametrize("argv", [
    ["--temp_pool=gru", "--window=4", "--backbone=rdnet"],
    ["--save_feats", "--backbone=rdnet"],
])
def test_rdnet_off_its_windows_raises_as_the_jax_driver(argv, env, tmp_path,
                                                       monkeypatch):
    """rdnet, once refused, runs at ``--window 8|32``; at another window
    both drivers raise (the JAX one an ``AssertionError``)."""
    monkeypatch.chdir(tmp_path)
    full = argv + [f"--root={env['port_root']}", "--data_shape=32",
                   "--num_workers=1"]
    with pytest.raises(ValueError, match="rdnet needs --window 8 or 32"):
        train.main(full + ["--device=cpu"])
    with pytest.raises(AssertionError, match="rdnet needs --window 8 or 32"):
        run_jax(jax_train.train_and_evaluate, full + ["--num_devices=1"])


def test_evaluate_vis_writes_results_mp4(env, evaluated):
    """``evaluate --vis``, once refused, writes ``<exp>/results.mp4``: the
    20 test frames with their overlay, as the JAX package's
    ``visualise_events`` renders the port's results; and, where every frame's
    top-1 and bar height agree with the JAX evaluator's, its video pixel
    for pixel."""
    from types import SimpleNamespace

    from tennis_tpu.utils.visualisation import BANNER_HEIGHT, \
        visualise_events
    from tennis_torch.data.tennis_set import load_classes

    def decoded(path):
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while (read := cap.read())[0]:
            frames.append(read[1])
        cap.release()
        return np.stack(frames)

    (res_w, _, _), (res_g, _, _), _ = evaluated
    got = decoded(os.path.join(env["exp"], "results.mp4"))
    want = decoded(os.path.join(env["workdir"], "jax_results.mp4"))
    assert got.shape == want.shape and len(got) == 20
    shim = SimpleNamespace(classes=load_classes(env["port_root"]),
                           _frames_dir=os.path.join(env["port_root"], "frames"))
    rendered = visualise_events(shim, res_g, os.path.join(env["workdir"],
                                                          "rendered.mp4"))
    np.testing.assert_array_equal(got, decoded(rendered))
    if all(np.argmax(res_g[k]) == np.argmax(p) and
           int(BANNER_HEIGHT * p.max()) == int(BANNER_HEIGHT * res_g[k].max())
           for k, p in res_w.items()):
        np.testing.assert_array_equal(got, want)


def test_entry_points_need_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--save_feats", "--backbone=DenseNet121"])
    with pytest.raises(RuntimeError, match="no GPU"):
        evaluate.main(["--backbone=DenseNet121"])


def test_resume_scan_skips_unreadable_epochs_as_jax(env, tmp_path):
    """A newest epoch file that does not parse is skipped, as the JAX
    resume scan skips it (which also renames it; the port leaves it)."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    for d in (mine, theirs):
        shutil.copytree(env["exp"], d)
        (d / "0002.params").write_bytes(b"\x93torn")
    epoch, tree = ckpt.latest_readable(str(mine))
    start, _ = jax_ckpt.resume_state(str(theirs), env["abstract"])
    assert epoch == start - 1 == 1
    assert set(tree) >= {"params", "batch_stats"}
    assert (mine / "0002.params").exists()
    assert ckpt.latest_readable(str(tmp_path / "none")) is None


def test_setup_logging_moves_the_file_log(tmp_path):
    """A second driver run in one process logs to its own log.txt only, with
    its flags first, and leaves one stream handler."""
    import logging

    from tennis_torch.utils.experiments import setup_logging

    first, second = tmp_path / "a", tmp_path / "b"
    first.mkdir()
    second.mkdir()
    root = logging.getLogger()
    setup_logging(str(first), {"model_id": "a"})
    logging.info("to a")
    n_handlers = len(root.handlers)
    setup_logging(str(second), {"model_id": "b", "batch_size": 64})
    logging.info("to b")
    assert len(root.handlers) == n_handlers
    a = (first / "log.txt").read_text()
    b = (second / "log.txt").read_text()
    assert "to a" in a and "to b" not in a
    assert "to b" in b and "to a" not in b
    assert b.index("--batch_size=64") < b.index("--model_id=b") < b.index("to b")
    setup_logging(str(first))  # let go of b's file
