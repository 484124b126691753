"""The port's train step against the JAX package's, in f32 on the CPU:
``sgd_with_schedule`` against optax's chain over steps that cross two LR
boundaries; three steps of ``make_train_step`` against the JAX
``make_train_step`` from the same bridged weights (parameters, BN
statistics and momentum after each step); ``--freeze_backbone``;
``softmax_ce``; and the whole train state carried through the bridge in the
layout of a file the JAX package writes (the same bytes, both ways).

Tolerances: the SGD update against optax 1e-6 relative (the same f32 ops;
optax may contract a multiply-add), the schedule exact; after each train
step every leaf within 1e-4 of its largest magnitude (f32 forward and
backward through a small DenseNet, summed in other orders, then the
update)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tennis_torch.bridge import from_flax, load_flax, state_from_flax, \
    state_to_flax
from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel
from tennis_torch.parallel import train_step as ts
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec

BLOCKS, SIDE, BATCH, CLASSES = (1, 1), 32, 4, 5
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
STEP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_frame_model():
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
    from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec

    return JaxFrameModel(JaxDenseNet(JaxSpec(BLOCKS), dtype=jnp.float32),
                         num_classes=CLASSES, dtype=jnp.float32)


def _port_model():
    spec = DenseNetSpec(BLOCKS)
    return FrameModel(DenseNet(spec, dtype=torch.float32), CLASSES,
                      dtype=torch.float32, feature_dim=spec.final_channels)


def _jax_tx(freeze, steps_per_epoch=1, lr_steps=(1, 2)):
    from tennis_tpu.parallel import sgd_with_schedule

    tx, _ = sgd_with_schedule(LR, MOMENTUM, WD, lr_steps, 0.75,
                              steps_per_epoch)
    if freeze:
        tx = optax.multi_transform(
            {"train": tx, "frozen": optax.set_to_zero()},
            lambda params: jax.tree_util.tree_map_with_path(
                lambda path, _: "frozen" if any(
                    getattr(k, "key", None) == "backbone" for k in path)
                else "train", params))
    return tx


def _jax_state(freeze=False, seed=0):
    """A JAX TrainState with BN parameters and statistics drawn away from
    their init, and (at step 5) non-zero momentum."""
    from tennis_tpu.parallel import create_train_state

    state = create_train_state(
        _jax_frame_model(), jax.random.PRNGKey(seed),
        jnp.zeros((1, SIDE, SIDE, 3)), _jax_tx(freeze), {"train": True})
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        a = np.asarray(a)
        if a.dtype != np.float32:
            return np.asarray(5, a.dtype)  # step and update count
        if name == "scale" or name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean", "trace") or path[0].name == "opt_state":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    leaves = jax.tree_util.tree_map_with_path(
        draw, jax.device_get(state.replace(tx=None)))
    return state.replace(step=leaves.step, params=leaves.params,
                         batch_stats=leaves.batch_stats,
                         opt_state=leaves.opt_state)


def _port_state(freeze=False, steps_per_epoch=1):
    tx, _ = ts.sgd_with_schedule(LR, MOMENTUM, WD, (1, 2), 0.75,
                                 steps_per_epoch)
    return ts.create_train_state(_port_model(), tx, freeze)


# ------------------------------------------------------------- the optimizer


def test_schedule_equals_optax():
    _, schedule = ts.sgd_with_schedule(0.001, lr_steps=["10", "20"],
                                       lr_factor=0.75, steps_per_epoch=7)
    want = optax.piecewise_constant_schedule(0.001, {70: 0.75, 140: 0.75})
    for k in (0, 69, 70, 71, 139, 140, 10_000):
        assert schedule(k) == float(np.float32(want(k))), k


def test_sgd_matches_optax_across_two_boundaries():
    """Six updates of random gradients with boundaries at steps 2 and 4."""
    from tennis_tpu.parallel import sgd_with_schedule

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    tx, _ = sgd_with_schedule(0.1, 0.9, 1e-2, [1, 2], 0.5, 2)
    jp, jstate = dict(params), tx.init(params)
    mine_tx, _ = ts.sgd_with_schedule(0.1, 0.9, 1e-2, [1, 2], 0.5, 2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = mine_tx.init(tp)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        mine_tx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                       tstate)
        trace = jstate[1][0].trace
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(tstate.trace[k].numpy(), trace[k],
                                       rtol=1e-6, atol=1e-7)
    assert tstate.count == int(jstate[1][1].count) == 6


def test_softmax_ce_equals_optax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 7)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean()
    got = ts.softmax_ce(torch.from_numpy(logits).to(torch.bfloat16).float(),
                        torch.from_numpy(labels))
    want_bf = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(labels)).mean()
    assert abs(got.item() - float(want_bf)) <= 1e-6
    got32 = ts.softmax_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(got32.item() - float(want)) <= 1e-6


# ------------------------------------------------- the bridge of the state


@pytest.mark.parametrize("freeze", [False, True])
def test_state_layout_is_the_jax_file(tmp_path, freeze):
    """A JAX-written epoch file (step 5, non-zero momentum) loaded into the
    port's state and written back gives the same bytes; under
    ``--freeze_backbone`` the multi_transform state, the backbone's trace
    leaves empty. The momentum arrives through the kernel transposes."""
    from tennis_tpu.utils import checkpoint as jax_ckpt

    jstate = _jax_state(freeze)
    path = str(tmp_path / "0000.params")
    jax_ckpt.save_state(path, jstate)
    state = _port_state(freeze)
    state_from_flax(state, ckpt.load_raw(path))
    assert state.step == 5 and state.opt_state.count == 5
    assert msgpack_codec.serialize(state_to_flax(state)) == \
        open(path, "rb").read()
    trace = jax.tree_util.tree_map(np.asarray, (
        jstate.opt_state.inner_states["train"].inner_state
        if freeze else jstate.opt_state)[1][0].trace)
    if freeze:
        trace = {"classes": trace["classes"]}
    want = from_flax({"params": trace})
    assert set(want) == set(state.opt_state.trace)
    for name, t in want.items():
        assert torch.equal(state.opt_state.trace[name], t), name
    with pytest.raises(KeyError):  # the other freeze setting
        state_from_flax(_port_state(not freeze), ckpt.load_raw(path))


# ------------------------------------------------------- train steps vs JAX


def _compare(state, jstate):
    want = jax.device_get(serialization.to_state_dict(jstate))
    got = state_to_flax(state)
    assert int(got["step"]) == int(want["step"])
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(
                {k: want[k] for k in ("params", "batch_stats", "opt_state")})[0],
            jax.tree_util.tree_flatten_with_path(
                {k: got[k] for k in ("params", "batch_stats", "opt_state")})[0]):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, path
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(g - w).max() / scale
        assert err <= STEP_TOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("freeze", [False, True])
def test_three_train_steps_match_jax(freeze):
    """Three steps on three batches from the same state (step 5, non-zero
    momentum): after each, every parameter, BN statistic and momentum leaf
    and the update count agree. Under ``--freeze_backbone`` the backbone's
    parameters stay as they were while its BN statistics move."""
    from tennis_tpu.parallel import make_train_step

    jstate = _jax_state(freeze, seed=1)
    state = _port_state(freeze)
    state_from_flax(state, jax.device_get(serialization.to_state_dict(jstate)))
    jstep = make_train_step(_jax_frame_model(), compiler_options=None)
    step = ts.make_train_step(state)
    rng = np.random.default_rng(2)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in state.model.named_buffers()}
    for _ in range(3):
        x = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32)
        labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
        jstate, jloss, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(labels))
        loss, logits = step(torch.from_numpy(x), labels)
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
        assert logits.shape == (BATCH, CLASSES)
        _compare(state, jstate)
    for n, p in state.model.named_parameters():
        frozen = freeze and n.startswith("backbone.")
        assert torch.equal(p, before[n]) == frozen, n
    for n, b in state.model.named_buffers():
        assert not torch.equal(b, stats0[n]), n


def test_augment_stream_follows_the_step():
    """The augment generator is seeded from (seed, step): the same step
    draws the same, another step another, whatever ran before."""
    draws = [torch.rand(4, generator=ts.step_generator(123, k, "cpu"))
             for k in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1])
    seen = []

    def preprocess(images, generator):
        seen.append(torch.rand(1, generator=generator).item())
        return images

    state = _port_state()
    step = ts.make_train_step(state, preprocess, rng_seed=7)
    x = torch.zeros(2, SIDE, SIDE, 3)
    step(x, [0, 1])
    state.step = 0
    step(x, [0, 1])
    assert seen[0] == seen[1] and state.step == 1


def test_train_mode_load_flax_roundtrip():
    """The state bridge leaves parameters loadable by ``load_flax``."""
    state = _port_state()
    tree = state_to_flax(state)
    model = load_flax(_port_model(), {"params": tree["params"],
                                      "batch_stats": tree["batch_stats"]})
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              state.model.state_dict().items()):
        assert torch.equal(a, b), n
