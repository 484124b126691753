"""The port's ResNet-v2 (``tennis_torch/models/backbones/resnet.py``) against
the JAX module on the CPU, at the same numpy-seeded weights (carried by the
bridge) and inputs, through ``FrameModel`` heads of 5 classes.

- eval mode, ResNet-18 and ResNet-50 at (2, 32, 32, 3): f32 logits within
  1e-4 of max |logit|, bf16 within 2e-2; a 6-channel (``--flow sixc``)
  stem; the head-less ``FrameModel``'s f32 features.
- train mode at (4, 64, 64, 3): at 32^2 and batch 2 the last stage's map is
  1 x 1, and a BN over 2 values gives +-1 whatever its input, so nothing
  before it has a gradient to compare. Both packages in f64: logits within
  1e-4 of max |logit|, every parameter's gradient within 1e-4 of its
  largest magnitude, running statistics within 1e-5. In f32 the reference
  is itself inexact there (ResNet-18: its gradients lie 1.6e-2 off its own
  f64 step, the port's 8.4e-6; ResNet-50: 0.24 and 0.088, a cancellation in
  the BN gradients of the deepest stages): ResNet-18's f32 step is held
  against the JAX f32 logits and statistics and against the JAX f64
  gradients at the tolerances above; the 6-channel stem's f32 logits and
  statistics against JAX f32, its gradients in f64.
- bf16 train mode (f32 parameters and statistics, as the driver keeps
  them), against the same step of the JAX package in bf16 and both against
  f64: ResNet-18's whole step at (4, 64, 64, 3), its loss within 1e-2 of
  JAX's, its statistics and gradients no farther from f64 than 1.25x JAX's
  own (gradients: 0.35 against 0.32); one residual block of each kind, its
  output within 2e-2 of JAX's, its statistics and gradients (parameters and
  input) no farther from f64 than 1.25x JAX's and every gradient leaf
  within 0.25 of f64. ResNet-50's whole bf16 step is chaotic at this size
  in the JAX package itself (its gradients 1.14 off f64), so its
  bottleneck is held block by block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cnnrnn import _jax_step, seeded_variables
from tennis_torch.bridge import from_flax, load_flax
from tennis_torch.models import FrameModel, RESNET_SPECS, ResNetV2, \
    backbone_feature_dim, get_backbone

CLASSES = 5
LOGIT_TOL, GRAD_TOL, STAT_TOL, BF16_TOL = 1e-4, 1e-4, 1e-5, 2e-2
# bf16 train steps: the port no farther from f64 than BF16_RATIO x the JAX
# package's own bf16 step, every gradient leaf of a block within
# BF16_LEAF_TOL of f64 (a zero gradient is 1.0 off), the loss within
# BF16_LOSS_TOL of JAX's
BF16_RATIO, BF16_LEAF_TOL, BF16_LOSS_TOL = 1.25, 0.25, 1e-2
EVAL_SHAPE, TRAIN_SHAPE = (2, 32, 32), (4, 64, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(depth, dtype, classes=CLASSES):
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models.backbones import get_backbone as jax_backbone

    return JaxFrameModel(jax_backbone(f"resnet{depth}_v2", dtype=dtype),
                         classes, dtype=dtype)


def _port_model(depth, dtype, in_channels=3, classes=CLASSES):
    return FrameModel(get_backbone(f"resnet{depth}_v2", in_channels,
                                   dtype=dtype), classes, dtype=dtype,
                      feature_dim=RESNET_SPECS[depth].final_channels)


def _inputs(shape, channels=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (channels,)).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _jax_step_f64(model, v, x, labels):
    """The flax module's train step with x64 on, every op in f64 (the
    loss too): logits, new statistics and a torch state dict of the
    gradients in f64."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params, stats = f64(v["params"]), f64(v["batch_stats"])

        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": stats},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                out, labels).mean()
            return loss, (out, mutated["batch_stats"])

        (_, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        return np.asarray(logits), to_np(new_stats), to_np(grads)


def _torch_grads(tree):
    """A flax gradient tree as a torch state dict, in f64."""
    names = from_flax({"params": jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), tree)})
    out, flat = {}, {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                flat[tuple(prefix + [k])] = v
    walk(tree, [])
    for (*mod, leaf), a in flat.items():
        if leaf == "kernel" and a.ndim == 4:
            a, leaf = a.transpose(3, 2, 0, 1), "weight"
        elif leaf == "kernel" and a.ndim == 5:
            a, leaf = a.transpose(4, 3, 0, 1, 2), "weight"
        elif leaf == "kernel":
            a, leaf = a.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mod + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(a, np.float64))
    assert set(out) == set(names)
    return out


def _port_step(model, x, labels, dtype):
    """The port's train step in ``dtype``: the model computes in its own
    dtype and keeps f32 parameters and statistics, as the driver's does,
    unless ``dtype`` is f64 (then every leaf is f64)."""
    if dtype == torch.float64:
        model = model.double()
    logits = model(torch.from_numpy(x).to(dtype), train=True)
    torch.nn.functional.cross_entropy(
        logits.to(dtype), torch.from_numpy(labels)).backward()
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    stats = {n: b.double() for n, b in model.named_buffers()}
    return logits.detach().double().numpy(), grads, stats


def _check_grads(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        err = ((got[name] - w).abs().max() / w.abs().max()).item()
        assert err <= tol, (name, err)


def _check_stats(got, want_tree, tol=STAT_TOL):
    want = {k: v.double() for k, v in from_flax({"batch_stats": jax.tree_util
            .tree_map(lambda a: np.asarray(a, np.float32),
                      want_tree)}).items()}
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert (got[name] - w).abs().max().item() <= tol, name


def _gap(got, want):
    """Global relative L2 of a dict of tensors against another."""
    return (torch.cat([(got[n].double() - w).flatten() for n, w in
                       want.items()]).norm()
            / torch.cat([w.flatten() for w in want.values()]).norm()).item()


def _stats_gap(got, want):
    return max((got[n].double() - w).abs().max().item()
               for n, w in want.items())


def _stat_dict(tree):
    """A flax batch_stats tree as a torch state dict, in f64."""
    return {k: t.double() for k, t in from_flax({
        "batch_stats": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), tree)}).items()}


def _bf16_block_gaps(jax_block, port_block, run, x, seed=0):
    """One block's train-mode step in bf16 in both packages and the JAX
    block's step in f64, at the same seeded weights, of the loss
    ``sum(out * r)`` over a seeded cotangent r. The JAX step is compiled
    without XLA's excess precision, so that it rounds to bf16 after every
    op, as the port does (with it, XLA skips some roundings and lands
    nearer f64). ``jax_block(dtype)`` builds
    the flax block; ``run(port_block, x)`` calls the port's in bf16 and
    returns ``(out, [(bn, mean, var), ...])``. Returns a dict: ``out``, the
    port's output's max |difference| to JAX's bf16 output over its max
    |value|; ``stats``, ``grads`` and ``worst_leaf``, each a (port, JAX)
    pair of gaps to f64: the statistics' largest difference, the gradients'
    (parameters and input) global relative L2 and the worst leaf's."""
    v = seeded_variables(jax_block(jnp.float32), x, seed=seed)
    out_shape = jax.eval_shape(lambda: jax_block(jnp.float32).apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"]))[0].shape
    r = np.random.default_rng(seed + 1).standard_normal(out_shape)
    runs = {}
    for key, dt in (("f64", jnp.float64), ("bf16", jnp.bfloat16)):
        with jax.enable_x64(key == "f64"):
            acc = jnp.float64 if key == "f64" else jnp.float32
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, acc), t)

            def loss_fn(params, xx):
                out, mutated = jax_block(dt).apply(
                    {"params": params, "batch_stats": cast(v["batch_stats"])},
                    xx, train=True, mutable=["batch_stats"])
                return (out.astype(acc) * jnp.asarray(r, acc)).sum(), (
                    out, mutated["batch_stats"])

            # the bf16 block reads a bf16 input, as inside the network,
            # and rounds where its ops round (no excess precision)
            args = (cast(v["params"]), jnp.asarray(
                x, acc if key == "f64" else dt))
            (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)).lower(*args).compile(
                    compiler_options={"xla_allow_excess_precision": False})(
                        *args)
            grads = _torch_grads(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), gp))
            grads["input"] = torch.from_numpy(np.asarray(gx, np.float64))
            runs[key] = (np.asarray(out, np.float64), grads,
                         _stat_dict(stats))
    block = load_flax(port_block, v)
    xt = torch.from_numpy(x).requires_grad_()
    out, stats = run(block, xt)
    for bn, mean, var in stats:
        bn.update_stats(mean, var)
    (out.double() * torch.from_numpy(r)).sum().backward()
    grads = {n: p.grad.double() for n, p in block.named_parameters()}
    grads["input"] = xt.grad.double()
    port = (out.detach().double().numpy(), grads,
            {n: b.double() for n, b in block.named_buffers()})
    want, ref = runs["f64"], runs["bf16"]

    def worst(g):
        return max(_gap({n: g[n]}, {n: w}) for n, w in want[1].items())

    return {"out": _rel(port[0], ref[0]),
            "stats": (_stats_gap(port[2], want[2]),
                      _stats_gap(ref[2], want[2])),
            "grads": (_gap(port[1], want[1]), _gap(ref[1], want[1])),
            "worst_leaf": (worst(port[1]), worst(ref[1]))}


def _check_bf16_block(gaps):
    assert gaps["out"] <= BF16_TOL, gaps
    for key in ("stats", "grads"):
        port, ref = gaps[key]
        assert port <= BF16_RATIO * ref, (key, gaps)
    assert gaps["worst_leaf"][0] <= BF16_LEAF_TOL, gaps


@pytest.fixture(scope="module", params=[18, 50])
def depth(request):
    return request.param


@pytest.fixture(scope="module")
def weights(depth):
    """The seeded flax tree of each depth (the shapes do not depend on the
    input side)."""
    return seeded_variables(_jax_model(depth, jnp.float32),
                            _inputs(EVAL_SHAPE))


_F64_STEPS = {}


def _f64_step(depth, channels, v):
    """The JAX f64 train step at TRAIN_SHAPE, once per (depth, channels)
    for the module."""
    key = (depth, channels)
    if key not in _F64_STEPS:
        x = _inputs(TRAIN_SHAPE, channels, seed=2)
        labels = np.arange(len(x)) % CLASSES
        _F64_STEPS[key] = (x, labels) + _jax_step_f64(
            _jax_model(depth, jnp.float64), v, x, labels)
    return _F64_STEPS[key]


def test_eval_logits_match_jax(depth, weights):
    x = _inputs(EVAL_SHAPE)
    want = np.asarray(_jax_model(depth, jnp.float32).apply(
        weights, jnp.asarray(x), train=False))
    model = load_flax(_port_model(depth, torch.float32), weights)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES) and got.dtype == np.float32
    assert _rel(got, want) <= LOGIT_TOL


def test_bf16_eval_logits_match_jax(depth, weights):
    x = _inputs(EVAL_SHAPE, seed=4)
    want = np.asarray(_jax_model(depth, jnp.bfloat16).apply(
        weights, jnp.asarray(x), train=False), np.float32)
    model = load_flax(_port_model(depth, torch.bfloat16), weights)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= BF16_TOL


def test_train_step_matches_jax_in_f64(depth, weights):
    """Train-mode logits, running statistics and every gradient, both
    packages in f64 (the same code as in f32 and bf16)."""
    x, labels, want, stats, grads = _f64_step(depth, 3, weights)
    model = load_flax(_port_model(depth, torch.float64), weights)
    logits, got_grads, got_stats = _port_step(model, x, labels,
                                              torch.float64)
    assert _rel(logits, want) <= LOGIT_TOL
    _check_grads(got_grads, _torch_grads(grads))
    _check_stats(got_stats, stats)


def test_f32_train_step_of_resnet18():
    """ResNet-18's f32 step: logits and statistics against the JAX f32
    step, gradients against the JAX f64 step."""
    v = seeded_variables(_jax_model(18, jnp.float32), _inputs(EVAL_SHAPE))
    x, labels, _, _, grads = _f64_step(18, 3, v)
    want, stats, _ = _jax_step(_jax_model(18, jnp.float32), v, x, labels)
    model = load_flax(_port_model(18, torch.float32), v)
    logits, got_grads, got_stats = _port_step(model, x, labels,
                                              torch.float32)
    assert _rel(logits, want) <= LOGIT_TOL
    _check_grads(got_grads, _torch_grads(grads))
    _check_stats(got_stats, stats)


def test_bf16_train_step_of_resnet18_matches_jax():
    """ResNet-18's bf16 step: the loss within 1e-2 of the JAX bf16 step's,
    the running statistics and the gradients no farther from the JAX f64
    step than 1.25x the JAX bf16 step's own."""
    v = seeded_variables(_jax_model(18, jnp.float32), _inputs(EVAL_SHAPE))
    x, labels, _, stats64, grads64 = _f64_step(18, 3, v)
    want, want_stats = _torch_grads(grads64), _stat_dict(stats64)
    ref_logits, ref_stats, ref_grads = _jax_step(
        _jax_model(18, jnp.bfloat16), v, x, labels)
    logits, grads, stats = _port_step(
        load_flax(_port_model(18, torch.bfloat16), v), x, labels,
        torch.bfloat16)

    def loss(out):
        return float(optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(out, jnp.float32), labels).mean())

    assert abs(loss(logits) - loss(ref_logits)) <= BF16_LOSS_TOL * loss(
        ref_logits)
    assert _stats_gap(stats, want_stats) <= BF16_RATIO * _stats_gap(
        _stat_dict(ref_stats), want_stats)
    assert _gap(grads, want) <= BF16_RATIO * _gap(ref_grads, want)


@pytest.mark.parametrize("kind,in_c,channels,strides", [
    ("basic", 64, 64, 1), ("basic", 64, 128, 2), ("bottleneck", 64, 256, 2)])
def test_bf16_block_train_step_matches_jax(kind, in_c, channels, strides):
    """One pre-activation block in bf16 train mode (ResNet-18's and
    ResNet-50's kinds, with and without the ``ds`` shortcut) against the
    same JAX block in bf16 and f64 (``_check_bf16_block``)."""
    from tennis_tpu.models.backbones import resnet as jax_resnet
    from tennis_torch.models.backbones import resnet as port_resnet

    jax_cls, port_cls = {
        "basic": (jax_resnet._BasicBlockV2, port_resnet._BasicBlockV2),
        "bottleneck": (jax_resnet._BottleneckV2,
                       port_resnet._BottleneckV2)}[kind]
    ds = in_c != channels or strides != 1

    def run(block, x):
        stats = []
        return block(x.to(torch.bfloat16), True, stats, torch.bfloat16), stats

    x = _inputs((2, 16, 16), in_c, seed=10)
    _check_bf16_block(_bf16_block_gaps(
        lambda dt: jax_cls(channels, strides, ds, dt),
        port_cls(in_c, channels, strides, ds, None), run, x))


def test_six_channel_train_step_matches_jax():
    """The 6-channel stem (``--flow sixc``): the f32 step's logits and
    statistics against JAX's f32 step, and the f64 step's gradients
    against JAX's f64 step (in f32 the stem BN's bias gradient, a sum over
    every stem pixel that nearly cancels, lies 9.3e-3 off f64)."""
    x = _inputs(TRAIN_SHAPE, 6, seed=2)
    jm = _jax_model(18, jnp.float32)
    v = seeded_variables(jm, x, seed=5)
    _, labels, want64, _, grads = _f64_step(18, 6, v)
    want, stats, _ = _jax_step(jm, v, x, labels)
    model = load_flax(_port_model(18, torch.float32, 6), v)
    assert model.backbone.conv0.weight.shape[1] == 6
    logits, _, got_stats = _port_step(model, x, labels, torch.float32)
    assert _rel(logits, want) <= LOGIT_TOL
    _check_stats(got_stats, stats)
    model = load_flax(_port_model(18, torch.float64, 6), v)
    logits, got_grads, _ = _port_step(model, x, labels, torch.float64)
    assert _rel(logits, want64) <= LOGIT_TOL
    _check_grads(got_grads, _torch_grads(grads))


def test_six_channel_eval_matches_jax():
    x = _inputs(EVAL_SHAPE, 6, seed=6)
    jm = _jax_model(18, jnp.float32)
    v = seeded_variables(jm, x, seed=7)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    model = load_flax(_port_model(18, torch.float32, 6), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("dtype,jdt", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)])
def test_headless_frame_model_features_match_jax(dtype, jdt):
    """``FrameModel(num_classes=-1)``: the pooled features (rounded to the
    compute dtype, as the flax module returns them) in f32."""
    x = _inputs(EVAL_SHAPE, seed=8)
    jm = _jax_model(18, jdt, classes=-1)
    v = seeded_variables(jm, x, seed=9)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False), np.float32)
    model = load_flax(_port_model(18, dtype, classes=-1), v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    tol = LOGIT_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(got.numpy(), want) <= tol


def test_registry_widths_and_remat_refusal():
    """``backbone_feature_dim`` of a ResNet is its final width at any input
    side, as in the JAX registry; ``remat`` raises for a ResNet."""
    from tennis_tpu.models.backbones import backbone_feature_dim as jax_dim

    for name in ("resnet18_v2", "resnet34_v2", "resnet50_v2",
                 "resnet101_v2", "resnet152_v2", "rdnet", "DenseNet121"):
        for side in (32, 224, 512):
            assert backbone_feature_dim(name, side) == jax_dim(name, side)
    assert isinstance(get_backbone("resnet101_v2"), ResNetV2)
    with pytest.raises(ValueError, match="remat"):
        get_backbone("resnet18_v2", remat="block")
    with pytest.raises(ValueError, match="unknown backbone"):
        get_backbone("resnet19_v2")
