"""The port's flax-msgpack codec (``tennis_torch.utils.msgpack_codec``)
against flax's own serialization: the same bytes for a real train-state
tree, a bf16 leaf, a chunked array and the scalar types a state dict may
hold; each side restores what the other wrote; malformed bytes raise
``DecodeError``. Everything compared is exact (bytes, and array values bit
for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec as codec


def _train_state():
    """A JAX TrainState of a small DenseNet FrameModel, with SGD momentum,
    at step 3 with non-zero traces."""
    from tennis_tpu.models import FrameModel
    from tennis_tpu.models.backbones.densenet import DenseNet, DenseNetSpec
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    model = FrameModel(DenseNet(DenseNetSpec((1, 1)), dtype=jnp.float32),
                       num_classes=5, dtype=jnp.float32)
    tx, _ = sgd_with_schedule(0.01, 0.9, 1e-4, [1, 2], 0.75, 2)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), tx, {"train": True})
    rng = np.random.default_rng(0)
    opt = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), a.dtype)
        if a.dtype == np.float32 else np.asarray(a + 3, a.dtype),
        jax.device_get(state.opt_state))
    return state.replace(step=jnp.asarray(3, jnp.int32), opt_state=opt)


def _np_tree(tree):
    """``tree`` with numpy leaves, every dict in its own key order (JAX's
    tree_map would sort the keys)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same_tree(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_train_state_bytes_equal_flax():
    """The file flax writes (``to_bytes``: field order, then jit's sorted
    keys) and ``msgpack_serialize`` (every key sorted) for the same tree."""
    state = _train_state()
    sd = _np_tree(serialization.to_state_dict(state))
    assert codec.serialize(sd) == serialization.to_bytes(state)
    sorted_sd = jax.tree_util.tree_map(lambda x: x, sd)  # JAX sorts keys
    assert codec.serialize(sorted_sd) == serialization.msgpack_serialize(sd)


def test_each_side_restores_the_other():
    state = _train_state()
    sd = _np_tree(serialization.to_state_dict(state))
    mine = codec.serialize(sd)
    _assert_same_tree(serialization.msgpack_restore(mine), sd)
    _assert_same_tree(codec.restore(serialization.to_bytes(state)), sd)
    restored = serialization.from_bytes(state, mine)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaf_bytes_and_widening():
    values = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    flax_bytes = serialization.msgpack_serialize(
        {"w": jnp.asarray(values, jnp.bfloat16)})
    mine = codec.serialize({"w": torch.from_numpy(values).to(torch.bfloat16)})
    assert mine == flax_bytes
    widened = codec.restore(flax_bytes)["w"]
    want = np.asarray(jnp.asarray(values, jnp.bfloat16).astype(jnp.float32))
    assert widened.dtype == np.float32
    np.testing.assert_array_equal(widened, want)
    back = serialization.msgpack_restore(mine)["w"]
    np.testing.assert_array_equal(np.asarray(back, np.float32), want)


def test_chunked_array(monkeypatch):
    """With the chunk limit lowered to 64 bytes on both sides, a 103-element
    f32 array is written as flax's chunked dict (7 chunks of 16) and read
    back whole by both."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    big = np.arange(103, dtype=np.float32).reshape(1, 103) * 0.5
    tree = {"a": {"big": big, "small": np.ones(4, np.float32)}, "b": big[0]}
    flax_bytes = serialization.msgpack_serialize(tree, in_place=False)
    assert codec.serialize(tree) == flax_bytes
    raw = serialization.msgpack.unpackb(flax_bytes, raw=False,
                                        ext_hook=lambda c, d: d)
    assert raw["a"]["big"][codec.CHUNKED] is True
    assert len(raw["a"]["big"]["chunks"]) == 7
    _assert_same_tree(codec.restore(flax_bytes), tree)
    _assert_same_tree(serialization.msgpack_restore(codec.serialize(tree)),
                      tree)


def test_scalar_types_as_msgpack_writes_them():
    """Every int width, floats, str/bin lengths across the fix, 8-, 16- and
    32-bit forms, bool, nil, numpy scalars, lists and 16+ keys; a complex,
    which flax writes, reads back."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    tree = {f"i{k}": v for k, v in enumerate(ints)}
    tree.update(f=1.5, nf=-0.0, t=True, no=False, none=None,
                s31="a" * 31, s32="a" * 32, s256="é" * 200, b=b"x" * 300,
                big_bin=b"y" * 70000, lst=[1, "two", np.ones(2, np.int64)],
                np32=np.float32(2.5), np64=np.int64(-7), empty={})
    flax_bytes = serialization.msgpack_serialize(tree, in_place=True)
    assert codec.serialize(tree) == flax_bytes
    assert codec.restore(serialization.msgpack_serialize(
        {"c": complex(1, -2)})) == {"c": complex(1, -2)}
    got = codec.restore(flax_bytes)
    for k, v in tree.items():
        if isinstance(v, list):
            assert got[k][:2] == v[:2]
            np.testing.assert_array_equal(got[k][2], v[2])
        else:
            assert got[k] == v and type(got[k]) is type(
                v if not isinstance(v, bytes) else b""), k


@pytest.mark.parametrize("cut", [1, 7, 100])
def test_truncated_bytes_raise_decode_error(cut):
    data = serialization.to_bytes(_train_state())
    with pytest.raises(codec.DecodeError):
        codec.restore(data[:-cut])
    with pytest.raises(codec.DecodeError):
        codec.restore(data + b"\x00")


def test_checkpoint_files_round_trip(tmp_path):
    """``save_state`` writes what flax's ``to_bytes`` writes, atomically
    (no temp file left), and ``load_raw`` reads a file JAX wrote."""
    from tennis_tpu.utils import checkpoint as jax_ckpt

    state = _train_state()
    ours, theirs = tmp_path / "ours.params", tmp_path / "theirs.params"
    ckpt.save_state(str(ours), _np_tree(serialization.to_state_dict(state)))
    jax_ckpt.save_state(str(theirs), state)
    assert ours.read_bytes() == theirs.read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ours.params",
                                                          "theirs.params"]
    _assert_same_tree(ckpt.load_raw(str(theirs)),
                      _np_tree(serialization.to_state_dict(state)))
