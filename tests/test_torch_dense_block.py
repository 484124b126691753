"""The port's dense layer, DenseNet features and FrameModel against the JAX
package (``DenseNet.apply`` and the Pallas kernel in interpret mode), on CPU.

Inputs and weights come from a seeded numpy generator and go through both
packages. In f32 both sides do the same math in another order, so they agree
to 1e-4; in bf16 the two frameworks round at other places, which the looser
bf16 bound below allows for.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models import FrameModel as JaxFrameModel
from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec
from tennis_tpu.ops.pallas.dense_block import (
    _layer_operands, dense_layer_pallas, densenet_features_pallas,
    frame_model_apply_pallas)
from tennis_torch.bridge import load_flax
from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel
from tennis_torch.ops import dense_block as db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 keeps 8 bits of mantissa: features differ by a few bf16 ulps of their
# magnitude, so compare the max error relative to max |want|
BF16_REL = 3e-2


def random_variables(model, x_shape, seed):
    """The JAX model's variable tree with every leaf redrawn from a seeded
    numpy generator: kernels ~ N(0, 1/fan_in), BN scale/bias near (1, 0),
    statistics away from (0, 1) so the folded affine is non-trivial."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def torch_densenet(spec_t, variables, dtype=torch.float32):
    model = DenseNet(spec_t, dtype=dtype)
    return load_flax(model, variables).eval()


SPEC = ((2, 2), 32, 64, 4)  # block-final widths 128/128, bottleneck 128


def test_dense_layer_matches_pallas():
    """(a) One layer: plain version vs dense_layer_pallas(interpret=True)."""
    rng = np.random.default_rng(0)
    B, H, W, c_in, c_final = 2, 8, 8, 96, 128
    x = rng.normal(size=(B, H, W, c_in)).astype(np.float32)
    p = {"bn1": {"scale": rng.uniform(0.5, 1.5, c_in), "bias": rng.normal(size=c_in)},
         "conv1": {"kernel": rng.normal(0, c_in ** -0.5, (1, 1, c_in, 128))},
         "bn2": {"scale": rng.uniform(0.5, 1.5, 128), "bias": rng.normal(size=128)},
         "conv2": {"kernel": rng.normal(0, (9 * 128) ** -0.5, (3, 3, 128, 32))}}
    s = {"bn1": {"mean": rng.normal(size=c_in) * 0.1,
                 "var": rng.uniform(0.5, 2, c_in)},
         "bn2": {"mean": rng.normal(size=128) * 0.1,
                 "var": rng.uniform(0.5, 2, 128)}}
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    s = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), s)

    padded = np.zeros((B, H + 2, W + 16, c_final), np.float32)
    padded[:, 1:-1, 8:-8, :c_in] = x
    ops = _layer_operands(p, s, c_in, jnp.float32)
    want = np.asarray(dense_layer_pallas(jnp.asarray(padded), *ops, c_in=c_in,
                                         dtype=jnp.float32, interpret=True))
    want = want[:, 1:-1, 8:-8, :c_in + 32]

    t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in p.items()}
    st = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in s.items()}
    ops_t = db.layer_operands(
        (t["bn1"]["scale"], t["bn1"]["bias"], st["bn1"]["mean"], st["bn1"]["var"]),
        t["conv1"]["kernel"].permute(3, 2, 0, 1),
        (t["bn2"]["scale"], t["bn2"]["bias"], st["bn2"]["mean"], st["bn2"]["var"]),
        t["conv2"]["kernel"].permute(3, 2, 0, 1), torch.float32)
    state = torch.zeros((B, H, W, c_final))
    state[..., :c_in] = torch.from_numpy(x)
    launches = db.dense_layer.launches
    got = db.dense_layer(state, c_in, ops_t)
    assert got is state  # in place
    assert db.dense_layer.launches == launches  # CPU: the plain version ran
    np.testing.assert_allclose(got[..., :c_in + 32].numpy(), want, **F32_TOL)
    assert not got[..., c_in + 32:].any()  # nothing past the growth part


@pytest.mark.parametrize("batch,side", [(2, 32), (3, 40)])
def test_features_match_jax_f32(batch, side):
    """(b) Features vs DenseNet.apply and densenet_features_pallas (f32);
    side 40 gives ragged 5x5 and 2x2 block maps."""
    spec = JaxSpec(*SPEC)
    model = JaxDenseNet(spec, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(batch, side, side, 3)) \
        .astype(np.float32)
    variables = random_variables(model, x.shape, seed=2)

    want = np.asarray(model.apply(variables, x, train=False))
    ours = torch_densenet(DenseNetSpec(*SPEC), variables)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)
    if side % 8 == 0:  # the TPU kernel takes 8-aligned sides only
        pallas = np.asarray(densenet_features_pallas(
            spec, variables, x, dtype=jnp.float32, interpret=True))
        np.testing.assert_allclose(got, pallas, **F32_TOL)


def test_features_match_jax_bf16():
    """(b) bf16 compute on both sides, within BF16_REL of max |want|."""
    spec = JaxSpec(*SPEC)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(JaxDenseNet(spec, dtype=jnp.float32), x.shape,
                                 seed=4)
    want = np.asarray(JaxDenseNet(spec, dtype=jnp.bfloat16).apply(
        variables, x, train=False)).astype(np.float32)
    ours = torch_densenet(DenseNetSpec(*SPEC), variables, dtype=torch.bfloat16)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < BF16_REL, err


def test_unaligned_block_width_works():
    """(c) Block-final width 160, which the TPU kernel rejects."""
    spec = JaxSpec((3,), growth_rate=32, num_init_features=64)
    model = JaxDenseNet(spec, dtype=jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(model, x.shape, seed=6)
    with pytest.raises(AssertionError):
        densenet_features_pallas(spec, variables, x, dtype=jnp.float32,
                                 interpret=True)
    want = np.asarray(model.apply(variables, x, train=False))
    ours = torch_densenet(DenseNetSpec((3,), 32, 64), variables)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_frame_model_matches_jax():
    """(d) FrameModel with an 11-class head vs FrameModel.apply and
    frame_model_apply_pallas; the port's forward, its frame_model_apply and
    the plain-version frame_model_apply agree."""
    spec = JaxSpec(*SPEC)
    model = JaxFrameModel(JaxDenseNet(spec, dtype=jnp.float32), num_classes=11,
                          dtype=jnp.float32)
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(model, x.shape, seed=8)
    want = np.asarray(model.apply(variables, x, train=False))
    pallas = np.asarray(frame_model_apply_pallas(model, variables, x,
                                                 interpret=True))

    ours = FrameModel(DenseNet(DenseNetSpec(*SPEC), dtype=torch.float32),
                      num_classes=11, dtype=torch.float32, feature_dim=128)
    load_flax(ours, variables).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = ours(xt).numpy()
        applied = db.frame_model_apply(ours, xt).numpy()
        plain = db.frame_model_apply(ours, xt,
                                     layer=db.dense_layer_reference).numpy()
    assert got.shape == (2, 11) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_array_equal(applied, got)
    np.testing.assert_array_equal(plain, got)


def test_fold_caches_operands():
    """fold() snapshots the operands the forward reuses; folding again after
    a weight change picks the change up."""
    model = DenseNet(DenseNetSpec((2,), 32, 64), dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = model(x)
        model.fold()
        assert model.operands() is model.operands()
        torch.testing.assert_close(model(x), before, rtol=0, atol=0)
        model.bn_final.bias.add_(1.0)
        torch.testing.assert_close(model(x), before, rtol=0, atol=0)  # stale
        model.fold()
        assert not torch.equal(model(x), before)


def _kernel_operands(c_in=64, f=128, g=32, dtype=torch.bfloat16):
    return db.LayerOperands(
        torch.ones(c_in), torch.zeros(c_in), torch.zeros(f, c_in, dtype=dtype),
        torch.ones(f), torch.zeros(f), torch.zeros(3, 3, g, f, dtype=dtype))


@pytest.mark.parametrize("case,exc", [
    ("f32_state", TypeError),
    ("densenet161_widths", ValueError),
    ("c_in_not_multiple_of_32", ValueError),
    ("growth_past_buffer", ValueError),
    ("non_contiguous", ValueError),
    ("w1_f32", ValueError),
])
def test_kernel_argument_checks(case, exc):
    """What the kernel does not take raises before any launch."""
    state = torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16)
    c_in, ops = 64, _kernel_operands()
    if case == "f32_state":
        state = state.float()
    elif case == "densenet161_widths":
        ops = _kernel_operands(f=192, g=48)
    elif case == "c_in_not_multiple_of_32":
        c_in, ops = 48, _kernel_operands(c_in=48)
    elif case == "growth_past_buffer":
        c_in, ops = 112, _kernel_operands(c_in=112)
        state = torch.zeros(1, 4, 4, 136, dtype=torch.bfloat16)
    elif case == "non_contiguous":
        state = torch.zeros(1, 4, 4, 256, dtype=torch.bfloat16)[..., :128]
    elif case == "w1_f32":
        ops = ops._replace(w1=ops.w1.float())
    with pytest.raises(exc):
        db._check_kernel_args(state, c_in, ops)
    db._check_kernel_args(torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16), 64,
                          _kernel_operands())  # the well-formed case passes


def test_dense_layer_rejects_other_devices():
    state = torch.zeros(1, 4, 4, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        db.dense_layer(state, 64, _kernel_operands())
