"""Weight bridge: a DenseNet121 FrameModel tree from the JAX package's own
``jax.jit(model.init)`` goes into the port and back out unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models import FrameModel as JaxFrameModel
from tennis_tpu.models import get_backbone as jax_backbone
from tennis_torch.bridge import from_flax, load_flax, to_flax
from tennis_torch.inference import build_frame_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def densenet121_tree():
    model = JaxFrameModel(jax_backbone("densenet121", dtype=jnp.float32),
                          num_classes=11, dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3), jnp.float32))
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": dict(variables["params"]),
        "batch_stats": dict(variables["batch_stats"])})
    # distinct statistics, so a swapped mean/var would show
    rng = np.random.default_rng(0)
    tree["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 2.0, v.shape).astype(np.float32),
        tree["batch_stats"])
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_round_trip_every_key(densenet121_tree):
    model = build_frame_model("DenseNet121", 11, 32, dtype=torch.float32)
    load_flax(model, densenet121_tree)
    back = to_flax(model)
    want, got = _flat(densenet121_tree), _flat(back)
    assert set(got) == set(want)
    assert len(want) == len(model.state_dict())  # every torch key is mapped
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_layouts(densenet121_tree):
    sd = from_flax(densenet121_tree)
    p, s = densenet121_tree["params"], densenet121_tree["batch_stats"]
    conv = p["backbone"]["block1_layer3"]["conv2"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        sd["backbone.block1_layer3.conv2.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["classes.weight"].numpy(),
                                  p["classes"]["kernel"].T)
    bn = "backbone.transition2.bn"
    np.testing.assert_array_equal(sd[f"{bn}.weight"].numpy(),
                                  p["backbone"]["transition2"]["bn"]["scale"])
    np.testing.assert_array_equal(sd[f"{bn}.running_var"].numpy(),
                                  s["backbone"]["transition2"]["bn"]["var"])


def test_missing_key_raises(densenet121_tree):
    tree = jax.tree_util.tree_map(lambda v: v, densenet121_tree)
    del tree["batch_stats"]["backbone"]["block3_layer15"]["bn2"]["mean"]
    model = build_frame_model("DenseNet121", 11, 32, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="block3_layer15.bn2.running_mean"):
        load_flax(model, tree)


@pytest.mark.parametrize("mutate", ["unknown_leaf", "unknown_stat",
                                    "unknown_collection", "extra_module"])
def test_unmatched_key_raises(densenet121_tree, mutate):
    tree = jax.tree_util.tree_map(lambda v: v, densenet121_tree)
    if mutate == "unknown_leaf":
        tree["params"]["backbone"]["conv0"]["embedding"] = np.zeros(3)
    elif mutate == "unknown_stat":
        tree["batch_stats"]["backbone"]["bn0"]["count"] = np.zeros(3)
    elif mutate == "unknown_collection":
        tree["cache"] = {}
    else:
        tree["params"]["backbone"]["block9_layer0"] = {"bias": np.zeros(3)}
    model = build_frame_model("DenseNet121", 11, 32, dtype=torch.float32)
    with pytest.raises((KeyError, RuntimeError)):
        load_flax(model, tree)


def _key_shapes(tree, prefix=""):
    """Path -> shape of every leaf; an empty dict (optax's masked node, an
    absent collection) is a leaf of its own."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_key_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = "{}" if isinstance(v, dict) else \
                tuple(np.shape(v))
    return out


TEMPORAL = {
    "cnnrnn_feats_gru": ["--feats_model=fs", "--temp_pool=gru",
                         "--window=4"],
    "cnnrnn_feats_lstm": ["--feats_model=fs", "--temp_pool=lstm",
                          "--window=4"],
    "cnnrnn_clips": ["--temp_pool=gru", "--window=3"],
    "cnnrnn_clips_frozen": ["--temp_pool=gru", "--window=3",
                            "--freeze_backbone"],
    "twos": ["--flow=twos"],
    "only": ["--flow=only", "--freeze_backbone"],
    "sixc": ["--flow=sixc"],
}


@pytest.mark.parametrize("config", list(TEMPORAL))
def test_temporal_and_two_stream_states_round_trip(config):
    """The JAX driver's ``build_model`` and ``TrainState`` (through its
    flags) against the port's ``train.build_model`` and
    ``state_to_flax``: the same tree, key for key and shape for shape (the
    feature CNN-RNN's ``batch_stats`` empty; under ``--freeze_backbone``
    the masked momentum leaves of every ``backbone``, none of a two-stream
    net); then seeded values of the JAX layout, momentum included, go into
    the port's state and come back out bit for bit."""
    import optax
    from absl import flags
    from flax import serialization

    from tennis_tpu import train as jax_train
    from tennis_tpu.parallel import create_train_state as jax_state
    from tennis_tpu.parallel import sgd_with_schedule as jax_sgd
    from tennis_torch import train
    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.parallel.train_step import create_train_state, \
        sgd_with_schedule

    argv = ["--backbone=DenseNet121", "--data_shape=32", *TEMPORAL[config]]
    feats = config.startswith("cnnrnn_feats")
    flags.FLAGS.unparse_flags()
    flags.FLAGS(["train", *argv])
    try:
        jax_model = jax_train.build_model(11, feats)
        sample = jax_train._sample_shape(11, feats, 1024)
        tx, _ = jax_sgd(0.001, 0.9, 1e-4, [10, 20], 0.75, 5)
        if flags.FLAGS.freeze_backbone:
            tx = optax.multi_transform(
                {"train": tx, "frozen": optax.set_to_zero()},
                lambda params: jax.tree_util.tree_map_with_path(
                    lambda path, _: "frozen" if any(
                        getattr(k, "key", None) == "backbone" for k in path)
                    else "train", params))
        abstract = jax.eval_shape(lambda: jax_state(
            jax_model, jax.random.PRNGKey(0), jnp.zeros(sample, jnp.float32),
            tx, {"train": True}))
    finally:
        flags.FLAGS.unparse_flags()
    want = serialization.to_state_dict(abstract)

    args = train.parse_args(argv)
    model = train.build_model(args, 11, feats)
    tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, [10, 20], 0.75, 5)
    state = create_train_state(model, tx, args.freeze_backbone)
    shapes = _key_shapes(want)
    assert _key_shapes(state_to_flax(state)) == shapes
    assert (want["batch_stats"] == {}) == feats

    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(
            rng.integers(1, 100) if a.dtype == jnp.int32
            else rng.standard_normal(a.shape), a.dtype), want)
    state_from_flax(state, tree)
    back = _flat(state_to_flax(state))
    flat = _flat(tree)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
