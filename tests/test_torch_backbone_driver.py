"""The ResNet-v2 and R(2+1)D slice as a whole, on the synthetic fixture
(with flow frames) at ``--data_shape 32``: the port's ``train`` with the
default flags (``resnet18_v2``; ``--backbone rdnet --window 8`` in
``test_torch_rdnet_driver.py``, through the same tests) writes an epoch that
the JAX driver resumes, and resumes the epoch the JAX driver wrote; the
train states of every configuration over these backbones
carry both ways (the ``--freeze_backbone`` predicate the JAX one);
``--save_feats`` (512-d features, JAX's within 5e-2 of max |JAX feature|
for ResNet-18, as ``tests/test_torch_extract.py`` holds DenseNet121's),
``evaluate --metrics_out`` (the trainer's final test) and ``serve
--backbone resnet18_v2``; and the flag sets on which both drivers raise.
"""
import glob
import json
import os
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import build_fixture
from test_torch_bridge import _flat, _key_shapes
from test_torch_extract import run_jax
from tennis_tpu import train as jax_train
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch import evaluate, serve, train
from tennis_torch.utils import checkpoint as ckpt

FEAT_TOL = 5e-2
STEPS = 2
FAMILIES = {
    "resnet18_v2": ["--batch_size=8", "--data_shape=32"],
    # R(2+1)D's weights do not depend on the input side: 16^2 clips cost
    # a quarter of 32^2 ones on the CPU
    "rdnet": ["--backbone=rdnet", "--window=8", "--batch_size=4",
              "--data_shape=16"],
}
COMMON = ["--num_workers=2", "--every=1,8,8", f"--max_batches={STEPS}",
          "--log_interval=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_fixture(tmp_path_factory.mktemp("ds"), with_flow=True)


def _exp(workdir, model_id):
    return os.path.join(workdir, "models", "vision", "experiments", model_id)


def run_chain(family, root, workdir):
    """Epoch 0 by the port, epoch 1 by the JAX driver resuming it, epoch 2
    by the port resuming that, in one experiment under ``workdir``."""
    argv = [f"--root={root}", *COMMON, *FAMILIES[family], "--model_id=c"]
    old = os.getcwd()
    os.chdir(workdir)
    try:
        train.main(argv + ["--epochs=1", "--device=cpu"])
        exp = _exp(workdir, "c")
        first = open(ckpt.epoch_path(exp, 0), "rb").read()
        run_jax(jax_train.train_and_evaluate,
                argv + ["--epochs=2", "--num_devices=1"])
        jax_epoch = open(ckpt.epoch_path(exp, 1), "rb").read()
        train.main(argv + ["--epochs=3", "--device=cpu"])
    finally:
        os.chdir(old)
    return dict(family=family, workdir=workdir, exp=exp, argv=argv,
                first=first, jax_epoch=jax_epoch)


@pytest.fixture(scope="module")
def chain(root, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("work"))
    yield run_chain("resnet18_v2", root, workdir)
    shutil.rmtree(workdir)


def test_each_package_resumes_the_others_epoch(chain):
    """The JAX driver resumed the port's epoch 0 (left as the port wrote
    it) and went on at epoch 1; the port resumed the JAX epoch 1 (left as
    JAX wrote it) and went on at epoch 2: the steps count on."""
    exp = chain["exp"]
    assert sorted(f for f in os.listdir(exp) if f.endswith(".params")) == \
        ["0000.params", "0001.params", "0002.params"]
    assert open(ckpt.epoch_path(exp, 0), "rb").read() == chain["first"]
    assert open(ckpt.epoch_path(exp, 1), "rb").read() == chain["jax_epoch"]
    for epoch in range(3):
        tree = jax_ckpt.load_raw(jax_ckpt.epoch_path(exp, epoch))
        assert int(tree["step"]) == (epoch + 1) * STEPS
        assert int(tree["opt_state"]["1"]["1"]["count"]) == \
            (epoch + 1) * STEPS
    assert [r.split()[0] for r in open(os.path.join(exp, "scores.txt"))] \
        == ["0", "1", "2"]
    params = ckpt.load_raw(ckpt.epoch_path(exp, 2))["params"]["backbone"]
    want = "stage0_block0" if chain["family"] == "resnet18_v2" else "init_bn"
    assert want in params


def test_evaluate_scores_as_the_final_test(chain):
    """``evaluate --metrics_out`` on the experiment's best epoch gives the
    trainer's final test PRF1 (the same forward on the same weights)."""
    old = os.getcwd()
    os.chdir(chain["workdir"])
    try:
        out = os.path.join(chain["workdir"], "m.json")
        results, gts, metrics = evaluate.main(
            chain["argv"] + ["--device=cpu", f"--metrics_out={out}"])
    finally:
        os.chdir(old)
    probs = np.stack(list(results.values()))
    assert probs.shape == (len(gts), 11) and len(gts) > 0
    np.testing.assert_allclose(probs.sum(-1), 1, atol=1e-4)
    with open(out) as f:
        dumped = json.load(f)
    assert dumped == metrics["prf1"].get_dict()
    assert "AVG_NB_f1" in dumped


def _features(root, model_id):
    base = os.path.join(root, "features", model_id)
    return {os.path.relpath(p, base): np.load(p) for p in
            glob.glob(os.path.join(base, "**", "*.npy"), recursive=True)}


def test_save_feats_writes_what_the_jax_driver_writes(chain, root,
                                                      tmp_path):
    """``train --save_feats`` from the best epoch: 512-d f32 features of
    every sample of the three splits, at the JAX driver's paths; for
    ResNet-18 within 5e-2 of the JAX dump of the same epoch. ``evaluate
    --save_feats --split val`` rewrites the val split's."""
    family = chain["family"]
    port_root = str(tmp_path / "port")
    shutil.copytree(root, port_root)
    work = str(tmp_path / "work")
    shutil.copytree(chain["workdir"], work)
    argv = [a for a in chain["argv"] if not a.startswith((
        "--root", "--max_batches", "--every"))] + ["--every=8,8,8"]
    old = os.getcwd()
    os.chdir(work)
    try:
        report = train.main(argv + [f"--root={port_root}", "--save_feats",
                                    "--device=cpu"])
        got = _features(port_root, "c")
        assert set(report) == {"train", "val", "test"}
        # the splits' samples share frames, so files are rewritten
        assert 0 < len(got) <= sum(r["files"] for r in report.values())
        for feat in got.values():
            assert feat.shape == (512,) and feat.dtype == np.float32
        if family == "resnet18_v2":
            run_jax(jax_train.train_and_evaluate,
                    argv + [f"--root={root}", "--save_feats",
                            "--num_devices=1"])
            want = _features(root, "c")
            assert set(got) == set(want)
            for path, w in want.items():
                assert np.abs(got[path] - w).max() <= \
                    FEAT_TOL * np.abs(w).max(), path
        shutil.rmtree(os.path.join(port_root, "features", "c"))
        assert evaluate.main(argv + [f"--root={port_root}", "--save_feats",
                                     "--split=val", "--device=cpu"]) == \
            ({}, {}, {})
        val = _features(port_root, "c")
        assert len(val) == report["val"]["files"]
        for path, feat in val.items():
            np.testing.assert_allclose(feat, got[path], rtol=0, atol=1e-6)
    finally:
        os.chdir(old)
        shutil.rmtree(work)  # the copied epochs: 1.5 GB for R(2+1)D


def test_serve_predicts_with_a_resnet(chain, tmp_path, monkeypatch):
    """``serve --backbone resnet18_v2`` on the experiment: /predict over
    HTTP gives the eval step's softmax of the decoded frame, in the batch
    the server runs: the request edge-padded to ``--batch_size 4``. A bf16
    convolution's rounding depends on the batch (oneDNN takes another
    kernel for 128 -> 256 at stride 2 at batch 1 than at batch 4, as XLA
    does in the JAX server), so a batch-1 forward may lie a bf16 rounding
    away from the served row."""
    import cv2
    from http.server import ThreadingHTTPServer

    monkeypatch.chdir(chain["workdir"])
    args = serve.parse_args(["--model_id=c", "--backbone=resnet18_v2",
                             "--data_shape=32", "--batch_size=4",
                             "--max_wait_ms=30", "--device=cpu"])
    handler, batcher = serve.build_service(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d/predict" % httpd.server_address[1]
    try:
        frame = np.random.default_rng(0).integers(0, 255, (32, 32, 3),
                                                  dtype=np.uint8)
        ok, enc = cv2.imencode(".png", frame[..., ::-1])
        assert ok
        results = []
        for _ in range(3):
            req = urllib.request.Request(url, data=enc.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                results.append(json.loads(r.read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
    from tennis_torch.inference import load_classifier

    _, predict_probs, _ = load_classifier("resnet18_v2", "c", 32,
                                          device="cpu")
    frame = serve.decode_rgb(enc.tobytes(), 32)
    want = predict_probs(np.stack([frame] * 4))[0]
    for r in results:
        assert r["label"] in r["classes"] and len(r["probs"]) == 11
        np.testing.assert_allclose(r["probs"], want, atol=1e-5)
    assert batcher.batches >= 1


STATE_CONFIGS = {
    "resnet18": ["--backbone=resnet18_v2"],
    "resnet50_frozen": ["--backbone=resnet50_v2", "--freeze_backbone"],
    "rdnet": ["--backbone=rdnet", "--window=8"],
    "rdnet_frozen": ["--backbone=rdnet", "--window=32", "--remat=block",
                     "--freeze_backbone"],
    "twos": ["--backbone=resnet18_v2", "--flow=twos", "--freeze_backbone"],
    "sixc": ["--backbone=resnet18_v2", "--flow=sixc"],
    "cnnrnn_clips_frozen": ["--backbone=resnet18_v2", "--temp_pool=gru",
                            "--window=3", "--freeze_backbone"],
    "cnnrnn_feats": ["--backbone=resnet18_v2", "--feats_model=fs",
                     "--temp_pool=lstm", "--window=4"],
}


def _jax_abstract_state(argv, feats):
    """The JAX driver's ``TrainState`` of ``argv`` (its ``build_model``, its
    ``--freeze_backbone`` transform), abstract."""
    import optax
    from absl import flags

    from tennis_tpu.models import backbone_feature_dim
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    flags.FLAGS.unparse_flags()
    flags.FLAGS(["train", *argv])
    try:
        model = jax_train.build_model(11, feats)
        sample = jax_train._sample_shape(11, feats, backbone_feature_dim(
            flags.FLAGS.backbone, flags.FLAGS.data_shape))
        tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, [10, 20], 0.75, 5)
        labels = None
        if flags.FLAGS.freeze_backbone:
            labels = lambda params: jax.tree_util.tree_map_with_path(  # noqa
                lambda path, _: "frozen" if any(
                    getattr(k, "key", None) == "backbone" for k in path)
                else "train", params)
            tx = optax.multi_transform(
                {"train": tx, "frozen": optax.set_to_zero()}, labels)
        abstract = jax.eval_shape(lambda: create_train_state(
            model, jax.random.PRNGKey(0), jnp.zeros(sample, jnp.float32), tx,
            {"train": True}))
        frozen = set()
        if labels is not None:
            frozen = {k for k, v in _flat(labels(abstract.params)).items()
                      if str(v) == "frozen"}
    finally:
        flags.FLAGS.unparse_flags()
    return abstract, frozen


@pytest.mark.parametrize("config", list(STATE_CONFIGS))
def test_train_states_round_trip_and_freeze_as_jax(config):
    """The JAX driver's ``TrainState`` against the port's
    ``state_to_flax``: the same tree, key for key and shape for shape;
    seeded values of the JAX layout (momentum included) go into the port's
    state and come back out bit for bit; ``--freeze_backbone`` leaves out
    of ``TrainState.trained`` exactly the parameters the JAX path rule
    labels frozen."""
    from flax import serialization

    from tennis_torch.bridge import from_flax, state_from_flax, \
        state_to_flax
    from tennis_torch.parallel.train_step import create_train_state, \
        sgd_with_schedule

    argv = ["--data_shape=32", *STATE_CONFIGS[config]]
    feats = "--feats_model=fs" in argv
    abstract, frozen = _jax_abstract_state(argv, feats)
    want = serialization.to_state_dict(abstract)
    args = train.parse_args(argv)
    model = train.build_model(args, 11, feats)
    tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, [10, 20], 0.75, 5)
    state = create_train_state(model, tx, args.freeze_backbone)
    assert _key_shapes(state_to_flax(state)) == _key_shapes(want)

    frozen_names = {n for n, _ in model.named_parameters()
                    if n not in state.trained}
    want_frozen = set(from_flax({"params": _unflat(
        {k: np.zeros(_key_shapes(want["params"])[k], np.float32)
         for k in frozen})}))
    assert frozen_names == want_frozen
    assert bool(frozen) == (args.freeze_backbone
                            and not config.startswith("twos"))

    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(
            rng.integers(1, 100) if a.dtype == jnp.int32
            else rng.standard_normal(a.shape), a.dtype), want)
    state_from_flax(state, tree)
    back, flat = _flat(state_to_flax(state)), _flat(tree)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


RAISING = [
    (["--backbone=DenseNet121", "--window=4"], "--window 4 feeds clips"),
    (["--window=4"], "--window 4 feeds clips"),
    (["--flow=only", "--window=4"], "--window 4 feeds clips"),
    (["--flow=twos", "--window=4", "--temp_pool=gru"],
     "--window 4 feeds clips"),
    (["--backbone=rdnet"], "rdnet needs --window 8 or 32"),
    (["--backbone=rdnet", "--window=8", "--remat=hires"],
     "rdnet supports --remat block only"),
    (["--remat=block"], "--remat supports DenseNet and rdnet"),
]


@pytest.mark.parametrize("argv,match", RAISING)
def test_flag_sets_both_drivers_refuse(argv, match, root, tmp_path,
                                       monkeypatch):
    """Where the JAX driver raises for a flag set (building or initializing
    its model), the port's raises ``ValueError`` naming it."""
    monkeypatch.chdir(tmp_path)
    full = [f"--root={root}", "--data_shape=32", "--batch_size=4",
            "--epochs=1", "--num_workers=1", *argv]
    with pytest.raises(ValueError, match=match):
        train.main(full + ["--device=cpu"])
    with pytest.raises((ValueError, AssertionError)):
        run_jax(jax_train.train_and_evaluate, full + ["--num_devices=1"])
