"""The port's train-mode DenseNet FrameModel against the flax module's
``apply(train=True, mutable=["batch_stats"])`` and ``jax.value_and_grad``,
from the same bridged weights, in f32 on the CPU: logits, the updated
running statistics, and the gradient of every parameter; the remat modes
against each other; and what autograd keeps in bf16.

The spec is DenseNet-BC with blocks (2, 2, 2, 2), growth 32, bottleneck 4,
at 64^2 (maps 16, 8, 4 and 2) and batch 4, with BN scales, biases and
running statistics drawn away from their init (with zero biases a BN
scale's gradient is a cancellation near 0: the next BN normalizes its
channel, so only rounding is left of it). Tolerances: logits 1e-4 absolute
(f32 through 21 convolutions and 21 batch normalizations, summed in other
orders), running statistics 1e-6, each parameter's gradient within 1e-3 of
its largest magnitude (the first layers' gradients pass back through every
BN)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tennis_torch.bridge import from_flax, load_flax
from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel

BLOCKS = (2, 2, 2, 2)
SIDE, BATCH, CLASSES = 64, 4, 5
LOGIT_TOL, STAT_TOL, GRAD_TOL = 1e-4, 1e-6, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(dtype=jnp.float32):
    from tennis_tpu.models import FrameModel as JaxFrameModel
    from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
    from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec

    return JaxFrameModel(JaxDenseNet(JaxSpec(BLOCKS), dtype=dtype),
                         num_classes=CLASSES, dtype=dtype)


def _variables(model, x, seed=0):
    """flax init, then BN scales U(0.5, 1.5), biases N(0, 0.2), running
    means shifted and variances scaled away from (0, 1)."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=True))

    def draw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, dict(v))


@pytest.fixture(scope="module")
def reference():
    """Inputs, labels, variables, and the flax module's loss, logits, new
    batch statistics and gradients."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32)
    labels = np.array([0, 1, 3, 4])
    v = _variables(_jax_model(), x)
    loss, logits, stats, grads = _jax_step(v, x, labels)
    return dict(x=x, labels=labels, variables=v, loss=float(loss),
                logits=np.asarray(logits), stats=stats, grads=grads)


def _jax_step(v, x, labels, dtype=jnp.float32):
    """The flax module's loss, logits, new batch statistics and the
    gradients (as a torch state dict, f32) of one train step."""
    model = _jax_model(dtype)

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            out.astype(jnp.float32), labels).mean()
        return loss, (out, mutated["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    return loss, logits, to_np(stats), from_flax({"params": to_np(grads)})


def _port(variables, remat=None, dtype=torch.float32):
    spec = DenseNetSpec(BLOCKS)
    model = FrameModel(DenseNet(spec, dtype=dtype, remat=remat), CLASSES,
                       dtype=dtype, feature_dim=spec.final_channels)
    return load_flax(model, variables)


def _port_step(reference, remat=None, dtype=torch.float32):
    model = _port(reference["variables"], remat, dtype)
    logits = model(torch.from_numpy(reference["x"]), train=True)
    loss = torch.nn.functional.cross_entropy(
        logits.float(), torch.from_numpy(reference["labels"]))
    loss.backward()
    return model, logits.detach().float().numpy(), loss.item()


@pytest.fixture(scope="module")
def port_none(reference):
    return _port_step(reference)


def test_train_logits_and_loss_match_flax(reference, port_none):
    _, logits, loss = port_none
    assert np.abs(logits - reference["logits"]).max() <= LOGIT_TOL
    assert abs(loss - reference["loss"]) <= LOGIT_TOL


def test_running_statistics_match_flax(reference, port_none):
    """Every BN's running mean and (biased) variance after one train
    forward: 0.99 old + 0.01 batch."""
    model = port_none[0]
    want = from_flax({"batch_stats": reference["stats"]})
    got = dict(model.named_buffers())
    assert set(got) == set(want) and len(want) == 2 * 21
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= STAT_TOL, (name, err)
    before = from_flax({"batch_stats": reference["variables"]["batch_stats"]})
    assert all(not torch.equal(got[n], before[n]) for n in want)


def test_every_gradient_matches_flax(reference, port_none):
    model = port_none[0]
    grads = reference["grads"]
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, want in grads.items():
        got = params[name].grad
        scale = want.abs().max().item()
        assert scale > 0, name
        err = (got - want).abs().max().item() / scale
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("remat", ["block", "hires", "growth"])
def test_remat_modes_give_the_gradients_of_none(reference, port_none, remat):
    """``block`` and ``hires`` recompute the same ops in the same order: the
    same bits. ``growth`` concatenates the block's parts inside each layer,
    so the backward adds the state's gradient parts in another order:
    within 1e-4 of each parameter's largest gradient (2e-5 seen, at bn0's
    scale, the gradient that passes back through every BN). The running
    statistics are updated once either way."""
    base = port_none[0]
    model, logits, _ = _port_step(reference, remat)
    np.testing.assert_array_equal(logits, port_none[1])
    base_params = dict(base.named_parameters())
    for name, p in model.named_parameters():
        want = base_params[name].grad
        if remat == "growth":
            err = (p.grad - want).abs().max() / want.abs().max()
            assert err <= 1e-4, (name, err.item())
        else:
            assert torch.equal(p.grad, want), name
    base_bufs = dict(base.named_buffers())
    for name, b in model.named_buffers():
        assert torch.equal(b, base_bufs[name]), name


def _gap(got: dict, want: dict) -> float:
    """Global relative L2 distance of two gradient sets."""
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    return (num / sum((w ** 2).sum() for w in want.values())).sqrt().item()


def test_bf16_gradients_stray_from_f32_as_jax_does(reference, port_none):
    """The bf16 step's gradients differ from the f32 step's by O(1) in
    relative L2 here (every BN re-amplifies the rounding of the layers
    before it); the port's bf16 rounding points leave its gap within 25% of
    the JAX package's own (0.45 against 0.42 when written), and its loss
    within 1e-2."""
    jloss, _, _, jgrads = _jax_step(reference["variables"], reference["x"],
                                    reference["labels"], jnp.bfloat16)
    model, _, loss = _port_step(reference, dtype=torch.bfloat16)
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    f32 = {n: p.grad for n, p in port_none[0].named_parameters()}
    jax_gap = _gap(jgrads, reference["grads"])
    port_gap = _gap(grads, f32)
    assert 0.05 < jax_gap and port_gap <= 1.25 * jax_gap, (port_gap, jax_gap)
    assert abs(loss - float(jloss)) <= 1e-2


def test_remat_mode_is_checked():
    with pytest.raises(ValueError, match="remat"):
        DenseNet(DenseNetSpec(BLOCKS), remat="layer")


def test_autograd_keeps_no_f32_activation(reference):
    """In bf16 the train step's saved tensors are bf16 activations, f32
    per-channel vectors and the f32 logits: no f32 copy of an activation
    (each BN + ReLU keeps its input as it is and its output)."""
    model = _port(reference["variables"], dtype=torch.bfloat16)
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel(), tuple(t.shape)))
        return t

    x = torch.from_numpy(reference["x"])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = model(x, train=True)
        torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(reference["labels"]))
    big_f32 = [s for s in saved if s[0] == torch.float32
               and s[1] > BATCH * CLASSES and len(s[2]) > 1]
    assert not big_f32, big_f32
    assert any(s[0] == torch.bfloat16 and s[1] >= BATCH * 16 * 16 * 64
               for s in saved)


def test_eval_forward_after_training_uses_the_new_weights(reference):
    """A train forward drops the folded eval operands, so the next eval
    forward folds the updated running statistics."""
    model = _port(reference["variables"])
    x = torch.from_numpy(reference["x"])
    with torch.no_grad():
        before = model(x).numpy()
        model(x, train=True)
        after = model(x).numpy()
        fresh = _port(reference["variables"])
        fresh.load_state_dict(model.state_dict())
        want = fresh(x).numpy()
    assert not np.allclose(before, after)
    np.testing.assert_array_equal(after, want)
