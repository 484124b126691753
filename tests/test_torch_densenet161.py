"""DenseNet161's widths in the port, on CPU.

No TPU kernel computes bottleneck 192 and growth 48 (the Pallas dense layer
asserts F == 128), so the JAX package runs DenseNet161 through its flax
module. The port's route sends those layers to ``dense_layer_convs`` by
width alone and keeps every DenseNet121/169/201 layer on its kernel; the
reduced-depth DenseNet161 matches the flax module at the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec
from tennis_torch.bridge import load_flax
from tennis_torch.models import DenseNet, DenseNetSpec
from tennis_torch.models.backbones.densenet import DENSENET_SPECS
from tennis_torch.ops import dense_block as db

F32_TOL = dict(rtol=1e-4, atol=1e-4)  # as the other backbone tests
BF16_REL = 3e-2
SPEC_161 = ((2, 2, 2, 2), 48, 96, 4)  # DenseNet161's widths, cut in depth


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def layers(depth, data_shape):
    """(map side, c_in) of every dense layer of DenseNet-``depth``."""
    spec = DENSENET_SPECS[depth]
    side, channels, out = data_shape // 4, spec.num_init_features, []
    for n in spec.block_config:
        out += [(side, channels + j * spec.growth_rate) for j in range(n)]
        channels = (channels + n * spec.growth_rate) // 2
        side //= 2
    return out


@pytest.mark.parametrize("data_shape", [224, 512])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_route_by_width(data_shape, batch):
    """Every DenseNet161 layer goes to "convs"; no DenseNet121/169/201 layer
    does, and theirs keep the route they had without the widths."""
    spec = DENSENET_SPECS[161]
    bottleneck = spec.bn_size * spec.growth_rate
    routes = {db.dense_layer_route(batch, s, s, c, bottleneck, spec.growth_rate)
              for s, c in layers(161, data_shape)}
    assert routes == {("convs", None)}
    assert len(layers(161, data_shape)) == 78
    for depth in (121, 169, 201):
        spec = DENSENET_SPECS[depth]
        for s, c in layers(depth, data_shape):
            route = db.dense_layer_route(batch, s, s, c,
                                         spec.bn_size * spec.growth_rate,
                                         spec.growth_rate)
            assert route == db.dense_layer_route(batch, s, s, c)
            assert route[0] in db.VARIANTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,g,c_in", [(192, 48, 144), (192, 48, 96),
                                      (128, 32, 64)])
def test_convs_equal_the_plain_version(dtype, f, g, c_in):
    rng = np.random.default_rng(c_in + g)

    def rand(*shape, lo=None):
        a = rng.uniform(lo, lo + 1, shape) if lo is not None else \
            rng.normal(size=shape)
        return torch.from_numpy(a.astype(np.float32))

    state = rand(2, 7, 5, c_in + g + 48).to(dtype)
    ops = db.LayerOperands(rand(c_in, lo=0.5), rand(c_in),
                           (rand(f, c_in) * c_in ** -0.5).to(dtype),
                           rand(f, lo=0.5), rand(f),
                           (rand(3, 3, g, f) * (9 * f) ** -0.5).to(dtype))
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    got = db.dense_layer_convs(state.clone(), c_in, ops)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got[..., c_in + g:], state[..., c_in + g:])
    # on the CPU the wrapper runs the plain version and counts nothing
    before = (db.dense_layer.launches, dict(db.dense_layer.variant_launches))
    torch.testing.assert_close(db.dense_layer(state.clone(), c_in, ops), want,
                               rtol=0, atol=0)
    assert (db.dense_layer.launches, db.dense_layer.variant_launches) == before


def random_variables(model, x_shape, seed):
    """The flax variable tree with every leaf redrawn from a seeded numpy
    generator, BN statistics away from (0, 1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_densenet161_matches_flax(dtype):
    """Growth 48, bn_size 4, 96 initial features, two layers a block, at
    32^2: the port against the flax module at the same weights."""
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = random_variables(JaxDenseNet(JaxSpec(*SPEC_161),
                                             dtype=jnp.float32), x.shape, 10)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(JaxDenseNet(JaxSpec(*SPEC_161), dtype=jdt).apply(
        variables, x, train=False)).astype(np.float32)
    model = load_flax(DenseNet(DenseNetSpec(*SPEC_161), dtype=tdt),
                      variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).float().numpy()
        convs = db.densenet_features(model.spec, model.operands(),
                                     torch.from_numpy(x), tdt,
                                     layer=db.dense_layer_convs).float().numpy()
    assert got.shape == want.shape == (2, model.spec.final_channels)
    np.testing.assert_array_equal(convs, got)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < BF16_REL
