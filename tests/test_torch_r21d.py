"""The port's R(2+1)D (``tennis_torch/models/r21d.py``) against the JAX
module on the CPU, at the same numpy-seeded weights (carried by the bridge,
5-d kernels included) and inputs, through the driver's ``FrameModel`` wrap
of 5 classes.

- R(2+1)D-34 at (2, 8, 16, 16, 3) and R(2+1)D-152 at (1, 8, 16, 16, 3),
  eval mode: f32 logits within 1e-4 of max |logit|; the
  ``R21DClassifier`` tree and head.
- Train mode at the same shape, both packages in f64: logits within 1e-4 of
  max |logit|, every gradient within 1e-4 of its largest magnitude, running
  statistics within 1e-5, ``init_bn``'s bit for bit unchanged. At this size
  the last stage's map is 1 x 1 x 1, and its BNs over 2 values make the f32
  step chaotic in either package (the port's and the reference's f32 logits
  differ by 10%; in f64 they agree exactly), so the f32 train step is held
  here only to itself with and without remat.
- bf16: eval logits within 2e-2 of the JAX package's bf16 logits. A whole
  bf16 train step is no test of the port at random weights: in train mode
  the network amplifies a relative perturbation about 1.5x per residual
  block (a rounding of 1e-6 in block 1 is 5e-4 after block 16; eval mode
  does not grow it), the ReLU masks then differ, and the backward grows
  the gradient about 500x from the head to the stem, so every leaf's bf16
  gradient, of every stage alike, lies about 1.4 off f64 in either
  package. So the bf16 step is held block by block, where it is not
  chaotic: the stem (``init`` and the frozen ``init_bn``), a basic block
  with and without ``down`` and a bottleneck, each against the same JAX
  block in bf16 and f64 (``test_torch_resnet._check_bf16_block``: output
  within 2e-2 of JAX's, statistics and gradients no farther from f64 than
  1.25x JAX's own, every gradient leaf within 0.25 of f64).
- The frozen stem (``tests/test_r21d_flownet.py``'s test, ported): a
  train-mode forward moves every BN's statistics but ``init_bn``'s, and
  ``init_bn``'s scale and bias still get gradients; ``remat=True`` gives the
  same features, loss and gradients; ``_mid_channels`` and the
  ``get_r21d`` asserts as in the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cnnrnn import seeded_variables
from test_torch_resnet import BF16_TOL, _bf16_block_gaps, _check_bf16_block, \
    _check_grads, _check_stats, _jax_step_f64, _port_step, _rel, \
    _torch_grads
from tennis_torch.bridge import load_flax, to_flax
from tennis_torch.models import FrameModel, R21D, R21DClassifier, get_r21d
from tennis_torch.models import r21d as port_r21d
from tennis_torch.models.r21d import _mid_channels

CLASSES = 5
LOGIT_TOL = 1e-4
SHAPE = (2, 8, 16, 16, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(dtype, layers=34):
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models.r21d import get_r21d as jax_r21d

    return JaxFrameModel(jax_r21d(layers, CLASSES, t=8, dtype=dtype),
                         CLASSES, dtype=dtype)


def _port_model(dtype, layers=34, remat=False):
    return FrameModel(get_r21d(layers, CLASSES, t=8, dtype=dtype,
                               remat=remat), CLASSES, dtype=dtype,
                      feature_dim=512 if layers == 34 else 2048)


def _clips(shape=SHAPE, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return seeded_variables(_jax_model(jnp.float32), _clips())


def test_mid_channels_formula():
    from tennis_tpu.models.r21d import _mid_channels as jax_mid

    for kernel in ((3, 3, 3), (3, 7, 7), (1, 3, 3)):
        for c_in, c_out in ((3, 64), (64, 64), (64, 128), (256, 512),
                            (512, 512)):
            assert _mid_channels(kernel, c_in, c_out) == jax_mid(
                kernel, c_in, c_out)
    assert _mid_channels((3, 3, 3), 64, 64) == int(
        (27 * 64 * 64) / (9 * 64 + 3 * 64))


def test_tree_is_the_flax_tree(weights):
    """Every key and shape of the flax tree, kernels 5-d in DHWIO."""
    got = to_flax(load_flax(_port_model(torch.float32), weights))
    flat = lambda t: {k: v.shape for k, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    want = flat({"params": weights["params"],
                 "batch_stats": weights["batch_stats"]})
    assert flat(got) == want
    kernel = got["params"]["backbone"]["stage2_block1"]["conv1"]["temporal"]
    assert kernel["kernel"].shape == (3, 1, 1, 230, 128)


def test_eval_logits_match_jax(weights):
    x = _clips()
    want = np.asarray(_jax_model(jnp.float32).apply(
        weights, jnp.asarray(x), train=False))
    model = load_flax(_port_model(torch.float32), weights)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES) and got.dtype == np.float32
    assert _rel(got, want) <= LOGIT_TOL


def test_bf16_eval_logits_match_jax(weights):
    x = _clips(seed=4)
    want = np.asarray(_jax_model(jnp.bfloat16).apply(
        weights, jnp.asarray(x), train=False), np.float32)
    model = load_flax(_port_model(torch.bfloat16), weights)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= BF16_TOL


_F64 = {}


def _f64_step(weights):
    """The JAX f64 train step on ``_clips(seed=2)``, once for the module."""
    if not _F64:
        x = _clips(seed=2)
        labels = np.arange(len(x)) % CLASSES
        _F64["step"] = (x, labels) + _jax_step_f64(
            _jax_model(jnp.float64), weights, x, labels)
    return _F64["step"]


def test_train_step_matches_jax_in_f64(weights):
    x, labels, want, stats, grads = _f64_step(weights)
    model = load_flax(_port_model(torch.float64), weights)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logits, got_grads, got_stats = _port_step(model, x, labels,
                                              torch.float64)
    assert _rel(logits, want) <= LOGIT_TOL
    _check_grads(got_grads, _torch_grads(grads))
    _check_stats(got_stats, stats)
    for leaf in ("running_mean", "running_var"):
        name = f"backbone.init_bn.{leaf}"
        assert torch.equal(got_stats[name], before[name].double())


class _PortStem(torch.nn.Module):
    """The port's stem alone: ``init`` and the frozen ``init_bn``."""

    def __init__(self):
        super().__init__()
        self.init = port_r21d.Conv21D(3, 64, (3, 7, 7), (1, 2, 2),
                                      mid_channels=45)
        self.init_bn = port_r21d._bn(64)

    def forward(self, x, train, dtype):
        stats = []
        x = self.init(x.to(dtype), train, stats, dtype)
        return self.init_bn.train_norm(x, stats, frozen=True), stats


def _jax_stem(dtype):
    """The JAX R21D's stem as a module of its own (the same layers and
    names as in ``R21D.__call__``)."""
    from flax import linen as nn
    from tennis_tpu.models.r21d import Conv21D

    class Stem(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = Conv21D(64, (3, 7, 7), (1, 2, 2), mid_channels=45,
                        dtype=dtype, name="init")(x.astype(dtype), train)
            x = nn.BatchNorm(use_running_average=True, epsilon=1e-3,
                             momentum=0.9, dtype=dtype, name="init_bn")(x)
            return nn.relu(x)

    return Stem()


@pytest.mark.parametrize("block", ["stem", "basic", "basic_down",
                                   "bottleneck_down"])
def test_bf16_gradients_no_farther_from_f64_than_jax(block):
    """One piece of the network in bf16 train mode, against the same JAX
    piece in bf16 and f64: the stem over clips, R(2+1)D-34's basic block
    (stage 1's, and stage 2's first with ``down`` and stride 2) and
    R(2+1)D-152's first bottleneck of stage 2, over post-ReLU inputs."""
    from tennis_tpu.models import r21d as jax_r21d

    jax_block, port_block, shape = {
        "stem": (_jax_stem, _PortStem(), (2, 8, 32, 32, 3)),
        "basic": (lambda dt: jax_r21d.BasicBlock21D(64, 1, False, dtype=dt),
                  port_r21d.BasicBlock21D(64, 64, 1, False),
                  (2, 8, 16, 16, 64)),
        "basic_down": (
            lambda dt: jax_r21d.BasicBlock21D(128, 2, True, dtype=dt),
            port_r21d.BasicBlock21D(64, 128, 2, True), (2, 8, 16, 16, 64)),
        "bottleneck_down": (
            lambda dt: jax_r21d.Bottleneck21D(512, 2, True, dtype=dt),
            port_r21d.Bottleneck21D(256, 512, 2, True), (2, 8, 8, 8, 256)),
    }[block]
    x = _clips(shape, seed=10)
    if block != "stem":
        x = np.maximum(x, 0)

    def run(module, x):
        return module(x.to(torch.bfloat16), True, torch.bfloat16)

    _check_bf16_block(_bf16_block_gaps(jax_block, port_block, run, x))


def test_stem_bn_is_frozen_and_the_rest_move(weights):
    """``tests/test_r21d_flownet.py``'s frozen-stem test, ported, in f32:
    after a train-mode forward ``init_bn``'s statistics are bit for bit as
    they were and every other BN's moved; its scale and bias still get
    gradients."""
    model = load_flax(_port_model(torch.float32), weights)
    before = {k: v.clone() for k, v in model.named_buffers()}
    out = model(torch.from_numpy(_clips(seed=3)), train=True)
    out.square().sum().backward()
    after = dict(model.named_buffers())
    for name, b in before.items():
        if name.startswith("backbone.init_bn."):
            assert torch.equal(after[name], b), name
        else:
            assert not torch.equal(after[name], b), name
    bn = model.backbone.init_bn
    assert bn.weight.grad.abs().max() > 0 and bn.bias.grad.abs().max() > 0


def test_remat_is_numerically_transparent(weights):
    """``remat=True`` (each residual block checkpointed): the same
    features, train-mode output, statistics and gradients."""
    x = torch.from_numpy(_clips(seed=5))
    runs = []
    for remat in (False, True):
        model = load_flax(_port_model(torch.float32, remat=remat), weights)
        assert model.backbone.remat == remat
        with torch.inference_mode():
            feats = model.features(x)
        out = model(x, train=True)
        out.square().sum().backward()
        runs.append((feats, out.detach(), dict(model.named_buffers()),
                     {n: p.grad for n, p in model.named_parameters()}))
    (f0, o0, s0, g0), (f1, o1, s1, g1) = runs
    assert torch.equal(f0, f1)
    np.testing.assert_allclose(o1.numpy(), o0.numpy(), rtol=1e-6, atol=0)
    for name in s0:
        assert torch.allclose(s1[name], s0[name], rtol=0, atol=1e-6), name
    for name in g0:
        assert torch.allclose(g1[name], g0[name], rtol=0, atol=1e-5), name


def test_r21d_152_eval_matches_jax():
    x = _clips((1, 8, 16, 16, 3), seed=6)
    jm = _jax_model(jnp.float32, layers=152)
    v = seeded_variables(jm, x, seed=7)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    model = load_flax(_port_model(torch.float32, layers=152), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= LOGIT_TOL


def test_classifier_head_is_the_flax_classifier():
    """``R21DClassifier``: the flax classifier's tree (``backbone``,
    ``dense``), the backbone's pooled features and the softmax of the
    ``dense`` head over them."""
    from tennis_tpu.models.r21d import R21D as JaxR21D
    from tennis_tpu.models.r21d import R21DClassifier as JaxClassifier

    x = _clips(seed=8)
    jm = JaxClassifier(JaxR21D(34, CLASSES, dtype=jnp.float32), CLASSES,
                       dtype=jnp.float32)
    v = seeded_variables(jm, x, seed=9)
    model = load_flax(R21DClassifier(R21D(34, CLASSES, dtype=torch.float32),
                                     CLASSES, dtype=torch.float32), v)
    with torch.inference_mode():
        avg, probs = model(torch.from_numpy(x))
        feats = model.backbone(torch.from_numpy(x))
        logits = model.dense(feats)
    assert avg.shape == (2, 512) and probs.shape == (2, CLASSES)
    assert torch.equal(avg, feats)
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=0,
                               atol=1e-6)


def test_get_r21d_asserts():
    with pytest.raises(AssertionError):
        get_r21d(num_layers=50)
    with pytest.raises(AssertionError):
        get_r21d(t=16)
    assert isinstance(get_r21d(34, 11, t=32), R21D)
