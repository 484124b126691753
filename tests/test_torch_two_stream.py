"""The port's two-stream RGB + flow net (``--flow twos``), its flow stream
alone (``--flow only``) and the 6-channel DenseNet (``--flow sixc``)
against the JAX modules on the CPU, at the same numpy-seeded weights
(carried by the bridge) and inputs through small DenseNets (blocks
2-2-2-2): eval mode at (2, 32, 32, 6), train mode at (4, 64, 64, 6), the
train-mode DenseNet test's shape; the 6-channel ``device_prepare``
against the JAX one; and ``--freeze_backbone`` on these trees.

Tolerances as ``test_torch_cnnrnn.py``: f32 logits 1e-5 absolute; train
mode, the train-mode DenseNet's own (``test_torch_train_densenet.py``):
logits 1e-4 absolute, the head's gradients within 1e-4 of their largest
magnitude, and the backbones' within 2e-3: the JAX package's own f32
gradient of sixc's ``bn0`` scale lies 9.9e-4 off the same step in f64 (the
port's 1.1e-4; a cancellation, the sum of a BN scale's gradient); running
statistics within 1e-6; bf16 logits within 2e-2 of max |logit|; the
prepared input exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cnnrnn import _jax_step, seeded_variables
from tennis_torch.bridge import from_flax, load_flax
from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel, \
    TwoStreamModel
from tennis_torch.parallel.train_step import create_train_state, \
    sgd_with_schedule

BLOCKS, SIDE, CLASSES = (2, 2, 2, 2), 32, 5
LOGIT_TOL, GRAD_TOL, BACKBONE_GRAD_TOL = 1e-5, 1e-4, 2e-3
TRAIN_LOGIT_TOL = 1e-4
STAT_TOL, BF16_TOL = 1e-6, 2e-2
FLOWS = ["twos", "only", "sixc"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(flow, dtype):
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models import TwoStreamModel as JaxTwoStream
    from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
    from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec

    def net():
        return JaxDenseNet(JaxSpec(BLOCKS), dtype=dtype)

    if flow == "sixc":
        return JaxFrameModel(net(), CLASSES, dtype=dtype)
    return JaxTwoStream(None if flow == "only" else net(), net(), CLASSES,
                        dtype=dtype)


def _port_model(flow, dtype):
    spec = DenseNetSpec(BLOCKS)
    if flow == "sixc":
        return FrameModel(DenseNet(spec, dtype=dtype, in_channels=6), CLASSES,
                          dtype=dtype, feature_dim=spec.final_channels)
    rgb = None if flow == "only" else DenseNet(spec, dtype=dtype)
    return TwoStreamModel(rgb, DenseNet(spec, dtype=dtype), CLASSES,
                          dtype=dtype, feature_dim=spec.final_channels)


def _inputs(seed, batch=2, side=SIDE):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, side, side, 6)).astype(np.float32)


@pytest.mark.parametrize("flow", FLOWS)
def test_eval_logits_match_jax(flow):
    x = _inputs(1)
    jm = _jax_model(flow, jnp.float32)
    v = seeded_variables(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    model = load_flax(_port_model(flow, torch.float32), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("flow", FLOWS)
def test_train_logits_gradients_and_statistics_match_jax(flow):
    x = _inputs(2, batch=4, side=64)
    labels = np.array([1, 3, 0, 4])
    jm = _jax_model(flow, jnp.float32)
    v = seeded_variables(jm, x, seed=3)
    want, stats, grads = _jax_step(jm, v, x, labels)
    model = load_flax(_port_model(flow, torch.float32), v)
    logits = model(torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=TRAIN_LOGIT_TOL)
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, g in grads.items():
        err = (params[name].grad - g).abs().max() / g.abs().max()
        tol = GRAD_TOL if name.startswith("classes.") else BACKBONE_GRAD_TOL
        assert err <= tol, (name, err.item())
    want_stats = from_flax({"batch_stats": stats})
    got_stats = dict(model.named_buffers())
    assert set(got_stats) == set(want_stats) and want_stats
    for name, w in want_stats.items():
        assert (got_stats[name] - w).abs().max() <= STAT_TOL, name


@pytest.mark.parametrize("flow", FLOWS)
def test_bf16_logits_match_jax(flow):
    x = _inputs(4)
    jm = _jax_model(flow, jnp.bfloat16)
    v = seeded_variables(jm, x, seed=5)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False), np.float32)
    model = load_flax(_port_model(flow, torch.bfloat16), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", [(3, 8, 8, 6), (2, 3, 8, 8, 6)])
def test_six_channel_prepare_matches_jax(shape):
    """uint8 frames and clips of 6 channels: the JAX eval preprocess
    (``device_prepare`` of the flattened frames, the two-stream
    statistics) and the port's, bit for bit."""
    from tennis_tpu.data.transforms import device_prepare as jax_prepare
    from tennis_torch.inference import prepare_input

    x = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    flat = x.reshape((-1,) + shape[-3:])
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_prepare(jnp.asarray(flat), jdt), np.float32)
        got = prepare_input(torch.from_numpy(x), dtype)
        assert got.shape == shape and got.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy().reshape(flat.shape), want)


@pytest.mark.parametrize("flow", FLOWS)
def test_freeze_backbone_follows_the_jax_path_rule(flow):
    """The JAX rule freezes a parameter whose path has a ``backbone``
    component: sixc's ``backbone.*``; nothing of a two-stream net."""
    model = _port_model(flow, torch.float32)
    tx, _ = sgd_with_schedule(0.1)
    state = create_train_state(model, tx, freeze_backbone=True)
    names = {n for n, _ in model.named_parameters()}
    frozen = names - set(state.trained)
    if flow == "sixc":
        assert frozen == {n for n in names if n.startswith("backbone.")}
        assert set(state.trained) == {"classes.weight", "classes.bias"}
    else:
        assert not frozen
