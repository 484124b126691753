"""The port's ``CNNRNN`` against ``tennis_tpu.models.CNNRNN`` on the CPU, at
the same weights (numpy-seeded, carried by the bridge) and inputs: over
(B, T, F) features (T 7, F 32, hidden 16) and over (B, T, 32, 32, 3) clips
through a small DenseNet (blocks 2-2-2-2), GRU and LSTM, eval and train
mode; and the RNN's compute dtype.

Tolerances: f32 logits 1e-5 absolute; train mode, every parameter's
gradient against ``jax.grad`` within 1e-4 of its largest magnitude, but the
clip backbone's within 1e-3, the train-mode DenseNet's own tolerance
(``test_torch_train_densenet.py``: its first layers' gradients pass back
through every BN; 1.4e-4 seen at ``bn0``), and its running statistics
within 1e-6; bf16 logits within 2e-2 of max |logit| (both sides round at
the same points, in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tennis_torch.bridge import from_flax, load_flax
from tennis_torch.models import CNNRNN, DenseNet, DenseNetSpec, FrameModel
from tennis_torch.ops import rnn

B, T, F, H, CLASSES = 3, 7, 32, 16, 5
BLOCKS, SIDE, CLIP_T = (2, 2, 2, 2), 32, 3
LOGIT_TOL, GRAD_TOL, STAT_TOL, BF16_TOL = 1e-5, 1e-4, 1e-6, 2e-2
BACKBONE_GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(source, cell, dtype):
    from tennis_tpu.models import CNNRNN as JaxCNNRNN
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
    from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec

    base = None if source == "feats" else JaxFrameModel(
        JaxDenseNet(JaxSpec(BLOCKS), dtype=dtype), dtype=dtype)
    return JaxCNNRNN(model=base, num_classes=CLASSES, hidden_size=H,
                     cell_type=cell, dtype=dtype)


def _port_model(source, cell, dtype):
    spec = DenseNetSpec(BLOCKS)
    base = None if source == "feats" else FrameModel(
        DenseNet(spec, dtype=dtype), dtype=dtype)
    return CNNRNN(base, CLASSES, hidden_size=H, cell_type=cell, dtype=dtype,
                  feature_dim=F if source == "feats" else spec.final_channels)


def _inputs(source, seed=1):
    rng = np.random.default_rng(seed)
    if source == "feats":
        return rng.standard_normal((B, T, F)).astype(np.float32)
    return rng.standard_normal((2, CLIP_T, SIDE, SIDE, 3)).astype(np.float32)


def seeded_variables(model, x, seed=0):
    """The flax tree's shapes, every leaf drawn with numpy: kernels with
    variance 1/fan_in, biases N(0, 0.2), BN scales U(0.5, 1.5), running
    means N(0, 0.1) and variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True))

    def draw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name == "kernel":
            v = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, a.shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, a.shape)
        elif name == "mean":
            v = rng.standard_normal(a.shape) * 0.1
        else:
            v = rng.standard_normal(a.shape) * 0.2
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    tree.setdefault("batch_stats", {})
    return tree


def _jax_step(model, v, x, labels):
    """The flax module's train-mode logits, new batch statistics and
    parameter gradients (a torch state dict) of the mean cross-entropy."""
    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            out.astype(jnp.float32), labels).mean()
        return loss, (out, mutated.get("batch_stats", {}))

    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    return np.asarray(logits), to_np(stats), from_flax({"params": to_np(grads)})


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("source", ["feats", "clips"])
def test_eval_logits_match_jax(source, cell):
    x = _inputs(source)
    jm = _jax_model(source, cell, jnp.float32)
    v = seeded_variables(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    model = load_flax(_port_model(source, cell, torch.float32), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (len(x), CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("source", ["feats", "clips"])
def test_train_logits_gradients_and_statistics_match_jax(source, cell):
    x = _inputs(source, seed=2)
    labels = np.arange(len(x)) % CLASSES
    jm = _jax_model(source, cell, jnp.float32)
    v = seeded_variables(jm, x, seed=3)
    want, stats, grads = _jax_step(jm, v, x, labels)
    model = load_flax(_port_model(source, cell, torch.float32), v)
    logits = model(torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, g in grads.items():
        err = (params[name].grad - g).abs().max() / g.abs().max()
        tol = BACKBONE_GRAD_TOL if name.startswith("model.") else GRAD_TOL
        assert err <= tol, (name, err.item())
    want_stats = from_flax({"batch_stats": stats})
    got_stats = dict(model.named_buffers())
    assert set(got_stats) == set(want_stats)
    assert (len(want_stats) == 0) == (source == "feats")
    for name, w in want_stats.items():
        assert (got_stats[name] - w).abs().max() <= STAT_TOL, name


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("source", ["feats", "clips"])
def test_bf16_logits_match_jax(source, cell):
    x = _inputs(source, seed=4)
    jm = _jax_model(source, cell, jnp.bfloat16)
    v = seeded_variables(jm, x, seed=5)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False), np.float32)
    model = load_flax(_port_model(source, cell, torch.bfloat16), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_TOL * scale


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_computes_in_its_dtype(cell):
    """A bf16 BiRNN keeps f32 parameters, and its carry, gates and outputs
    in bf16; an f32 one is the GNMT's, unchanged."""
    layer = rnn.BiRNN(cell, F, H, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    x = torch.from_numpy(_inputs("feats"))
    (l_final, r_final), out = layer(x)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, 2 * H)
    finals = (l_final, r_final) if cell == "gru" else (*l_final, *r_final)
    assert all(f.dtype == torch.bfloat16 for f in finals)
    f32 = rnn.BiRNN(cell, F, H, generator=torch.Generator().manual_seed(0))
    assert f32(x)[1].dtype == torch.float32


def test_cnnrnn_needs_its_input_width():
    with pytest.raises(ValueError, match="feature_dim"):
        CNNRNN(None, CLASSES)
