"""The port's checkpoint reading, experiment conventions, transforms and
classifier loader against the JAX package, on CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tennis_tpu.data import transforms as jax_tf
from tennis_tpu.data.tennis_set import load_classes as jax_load_classes
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_tpu.utils.experiments import experiment_dir as jax_experiment_dir
from tennis_torch.data import transforms as tf
from tennis_torch.data.tennis_set import load_classes
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils.experiments import experiment_dir


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_tree(got, want, path="") -> int:
    """Equal structure and leaves; returns the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        return sum(_assert_same_tree(got[k], want[k], f"{path}/{k}")
                   for k in want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=path)
    assert np.asarray(got).dtype == np.asarray(want).dtype, path
    return 1


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A DenseNet121 vision experiment written by the JAX package: epoch 0
    scores 0.3, epoch 1 (perturbed BN statistics) scores 0.7."""
    from tennis_tpu.models import FrameModel, get_backbone
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    base = tmp_path_factory.mktemp("exp")
    model = FrameModel(get_backbone("densenet121", dtype=jnp.bfloat16),
                       num_classes=11, dtype=jnp.bfloat16)
    tx, _ = sgd_with_schedule(0.001)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3), jnp.float32),
                               tx, {"train": True})
    exp = os.path.join(base, "models", "vision", "experiments", "t1")
    os.makedirs(exp)
    jax_ckpt.save_state(jax_ckpt.epoch_path(exp, 0), state)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 2.0, v.shape)
                         if str(path[-1].key) == "var"
                         else rng.normal(size=v.shape) * 0.1).astype(np.float32),
        state.batch_stats)
    jax_ckpt.save_state(jax_ckpt.epoch_path(exp, 1),
                        state.replace(batch_stats=stats))
    jax_ckpt.append_score(exp, 0, 0.3)
    jax_ckpt.append_score(exp, 1, 0.7)
    return str(base), exp


def test_load_raw_matches_flax(experiment):
    _, exp = experiment
    path = ckpt.epoch_path(exp, 1)
    n = _assert_same_tree(ckpt.load_raw(path), jax_ckpt.load_raw(path))
    assert n > 700  # params, stats, momentum and step of every layer


def test_load_raw_bf16_scalars_and_chunks(tmp_path, monkeypatch):
    """bf16 leaves widen to f32; numpy scalars and complex numbers round-trip;
    arrays over flax's chunk size come back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"a": {"big": rng.normal(size=(7, 9)).astype(np.float32)},
            "half": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16),
            "i": np.arange(4, dtype=np.int32), "s": np.float32(2.5),
            "c": complex(1.0, -2.0)}
    path = tmp_path / "t.params"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = ckpt.load_raw(str(path))
    np.testing.assert_array_equal(got["a"]["big"], tree["a"]["big"])
    np.testing.assert_array_equal(got["half"],
                                  np.asarray(tree["half"], np.float32))
    assert got["half"].dtype == np.float32
    np.testing.assert_array_equal(got["i"], tree["i"])
    assert got["s"] == np.float32(2.5) and got["c"] == complex(1.0, -2.0)


def test_epoch_selection_matches_jax(tmp_path):
    d = str(tmp_path)
    for mod in (ckpt, jax_ckpt):
        assert mod.list_epochs(d) == [] and mod.latest_epoch(d) is None
        with pytest.raises(FileNotFoundError):
            mod.best_or_latest(d)
    for e in (0, 2, 5):
        (tmp_path / f"{e:04d}.params").write_bytes(b"")
    (tmp_path / "notes.params").write_bytes(b"")
    assert ckpt.best_or_latest(d)[0] == jax_ckpt.best_or_latest(d)[0] == 5
    # scores.txt: the row of a missing checkpoint (epoch 3) is skipped
    (tmp_path / "scores.txt").write_text("0\t0.2\n3\t0.9\n2\t0.5\n5\t0.4\n")
    for fn in ("list_epochs", "latest_epoch", "best_epoch", "best_or_latest"):
        assert getattr(ckpt, fn)(d) == getattr(jax_ckpt, fn)(d), fn
    assert ckpt.best_or_latest(d) == (2, 0.5)
    assert ckpt.epoch_path(d, 7) == jax_ckpt.epoch_path(d, 7)


def test_experiment_dir_and_classes_match_jax(tmp_path):
    base = str(tmp_path)
    assert experiment_dir("vision", "0006", base) == \
        jax_experiment_dir("vision", "0006", base)
    assert os.path.isdir(os.path.join(base, "models", "vision", "experiments",
                                      "0006"))
    with pytest.raises(ValueError):
        experiment_dir("audio", "x", base)
    assert load_classes(base) == jax_load_classes(base)
    assert len(load_classes(base)) == 11
    (tmp_path / "classes.names").write_text("A\n\nB\nC \n")
    assert load_classes(base) == jax_load_classes(base) == ["A", "B", "C"]


@pytest.mark.parametrize("channels", [3, 6])
def test_device_prepare_matches_jax(channels):
    batch = np.random.default_rng(2).integers(0, 256, (2, 5, 7, channels),
                                              dtype=np.uint8)
    want = np.asarray(jax_tf.device_prepare(batch, dtype=jnp.float32))
    got = tf.device_prepare(torch.from_numpy(batch), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want16 = np.asarray(jax_tf.device_prepare(batch).astype(jnp.float32))
    got16 = tf.device_prepare(torch.from_numpy(batch)).float().numpy()
    # the same f32 value rounds to the same bf16 except at a rounding tie
    np.testing.assert_allclose(got16, want16, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("h,w,size", [(48, 64, 32), (100, 60, 32), (20, 20, 32)])
def test_test_geometry_matches_jax(h, w, size):
    img = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tf.test_geometry(img, size),
                                  jax_tf.test_geometry(img, size))


def test_load_classifier_matches_jax(experiment, monkeypatch):
    """(f) Same best epoch, same softmax on a JAX-written checkpoint.

    Both sides compute in bf16 with random weights; the probabilities agree
    to 1e-2 absolute."""
    from tennis_tpu.inference import load_classifier as jax_load_classifier
    from tennis_torch.inference import load_classifier

    base, _ = experiment
    monkeypatch.chdir(base)
    images = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    classes_j, predict_j, info_j = jax_load_classifier("DenseNet121", "t1", 32)
    classes_t, predict_t, info_t = load_classifier("DenseNet121", "t1", 32,
                                                   device="cpu")
    assert classes_t == classes_j
    assert info_t["epoch"] == info_j["epoch"] == 1
    assert info_t["score"] == info_j["score"] == 0.7
    want, got = predict_j(images), predict_t(images)
    assert got.shape == want.shape == (4, 11)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-2)
