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
