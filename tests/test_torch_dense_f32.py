"""The f32 dense layer (the pixels-path captioner's DenseNet ``src_embed``):
the route sends an f32 state to the f32 kernel at every DenseNet121/169/201
layer shape and leaves every bf16 route as it was; the CPU plain version
at f32 against the JAX package's ``dense_layer_pallas(interpret=True,
dtype=float32)`` at two shapes (1e-4, the two sum in another order); the
wrapper's checks of the f32 variant. Marked ``cuda`` and skipped without a
card: the f32 kernel against its plain version at small, ragged and real
layer shapes, and an f32 DenseNet's eval forward through it. On a machine
with a card: ``python -m pytest tests/test_torch_dense_f32.py -m cuda
--noconftest -q``."""
import numpy as np
import pytest
import torch

from tennis_torch.models import DENSENET_SPECS, DenseNet, DenseNetSpec
from tennis_torch.ops import dense_block as db

F32_TOL = dict(rtol=1e-4, atol=1e-4)
# max |kernel - plain| / max |plain| over the growth channels: f32 sums in
# another order
KERNEL_REL_TOL = 1e-4


def _layer_shapes(spec, side=512):
    """(batch, side, c_in) of every dense layer of ``spec`` at ``side``^2."""
    side, channels = side // 4, spec.num_init_features
    for num_layers in spec.block_config:
        for j in range(num_layers):
            yield side, channels + spec.growth_rate * j
        channels = (channels + spec.growth_rate * num_layers) // 2
        side //= 2


@pytest.mark.parametrize("depth", [121, 169, 201])
def test_f32_state_routes_to_the_f32_kernel(depth):
    spec = DENSENET_SPECS[depth]
    for batch in (1, 8, 64):
        for side, c_in in _layer_shapes(spec):
            assert db.dense_layer_route(batch, side, side, c_in,
                                        dtype=torch.float32) == ("f32", None)
            bf16 = db.dense_layer_route(batch, side, side, c_in)
            assert bf16 == db.dense_layer_route(batch, side, side, c_in,
                                                dtype=torch.bfloat16)
            assert bf16[0] in db.VARIANTS
    # DenseNet161's widths go to the convolutions at f32 as at bf16
    assert db.dense_layer_route(8, 56, 56, 96, 192, 48,
                                torch.float32) == ("convs", None)
    assert "f32" in db.ROUTES and "f32" not in db.VARIANTS


def _numpy_layer(rng, c_in):
    p = {"bn1": {"scale": rng.uniform(0.5, 1.5, c_in),
                 "bias": rng.normal(size=c_in)},
         "conv1": {"kernel": rng.normal(0, c_in ** -0.5, (1, 1, c_in, 128))},
         "bn2": {"scale": rng.uniform(0.5, 1.5, 128),
                 "bias": rng.normal(size=128)},
         "conv2": {"kernel": rng.normal(0, (9 * 128) ** -0.5,
                                        (3, 3, 128, 32))}}
    s = {"bn1": {"mean": rng.normal(size=c_in) * 0.1,
                 "var": rng.uniform(0.5, 2, c_in)},
         "bn2": {"mean": rng.normal(size=128) * 0.1,
                 "var": rng.uniform(0.5, 2, 128)}}
    cast = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
            for k, d in p.items()}
    return cast, {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                  for k, d in s.items()}


def _torch_operands(p, s, dtype=torch.float32):
    t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in {**p, **{f"{k}_s": v for k, v in s.items()}}.items()}
    return db.layer_operands(
        (t["bn1"]["scale"], t["bn1"]["bias"], t["bn1_s"]["mean"],
         t["bn1_s"]["var"]),
        t["conv1"]["kernel"].permute(3, 2, 0, 1),
        (t["bn2"]["scale"], t["bn2"]["bias"], t["bn2_s"]["mean"],
         t["bn2_s"]["var"]),
        t["conv2"]["kernel"].permute(3, 2, 0, 1), dtype)


@pytest.mark.parametrize("B,H,W,c_in,c_final", [
    (2, 7, 7, 128, 256),    # a ragged map (7 is no multiple of 8)
    (1, 16, 16, 224, 256),  # the last c_in of a 256-channel block
])
def test_f32_plain_version_matches_pallas(B, H, W, c_in, c_final):
    import jax.numpy as jnp

    from tennis_tpu.ops.pallas.dense_block import _layer_operands, \
        dense_layer_pallas

    rng = np.random.default_rng(c_in + H)
    x = rng.normal(size=(B, H, W, c_in)).astype(np.float32)
    p, s = _numpy_layer(rng, c_in)
    padded = np.zeros((B, H + 2, W + 16, c_final), np.float32)
    padded[:, 1:-1, 8:-8, :c_in] = x
    want = np.asarray(dense_layer_pallas(
        jnp.asarray(padded), *_layer_operands(p, s, c_in, jnp.float32),
        c_in=c_in, dtype=jnp.float32, interpret=True))
    want = want[:, 1:-1, 8:-8, :c_in + 32]

    ops = _torch_operands(p, s)
    assert ops.w1.dtype == ops.w2.dtype == torch.float32
    state = torch.zeros(B, H, W, c_final)
    state[..., :c_in] = torch.from_numpy(x)
    launches = db.dense_layer.launches
    got = db.dense_layer(state, c_in, ops)  # the CPU: the plain version
    assert db.dense_layer.launches == launches
    np.testing.assert_allclose(got[..., :c_in + 32].numpy(), want, **F32_TOL)
    assert not got[..., c_in + 32:].any()


@pytest.mark.parametrize("case", ["bf16_state", "bf16_w1", "bf16_w2"])
def test_f32_kernel_argument_checks(case):
    p, s = _numpy_layer(np.random.default_rng(0), 64)
    ops = _torch_operands(p, s)
    state = torch.zeros(1, 4, 4, 128)
    if case == "bf16_state":
        state = state.to(torch.bfloat16)
    elif case == "bf16_w1":
        ops = ops._replace(w1=ops.w1.to(torch.bfloat16))
    else:
        ops = ops._replace(w2=ops.w2.to(torch.bfloat16))
    with pytest.raises((TypeError, ValueError)):
        db._check_kernel_args(state, 64, ops, "f32")
    db._check_kernel_args(torch.zeros(1, 4, 4, 128), 64,
                          _torch_operands(p, s), "f32")  # well-formed


# ------------------------------------------------------------------ the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_layer(dev, batch, h, w, c_in, c_final, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=g)

    state = rand(batch, h, w, c_final)
    ops = db.LayerOperands(
        rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
        rand(128, c_in, std=c_in ** -0.5), rand(128).abs() + 0.5,
        rand(128) * 0.5, rand(3, 3, 32, 128, std=1152 ** -0.5))
    return state, ops


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,c_in,c_final", [
    (2, 8, 8, 64, 128), (2, 7, 7, 96, 128), (1, 4, 4, 128, 160),
    (3, 13, 9, 32, 64), (1, 1, 1, 64, 96), (2, 24, 17, 224, 256),
    (2, 128, 128, 64, 256), (2, 16, 16, 992, 1024),
    (1, 16, 16, 1888, 1920)])
def test_f32_kernel_matches_plain(dev, batch, h, w, c_in, c_final):
    state, ops = _card_layer(dev, batch, h, w, c_in, c_final, seed=c_in + h)
    before = dict(db.dense_layer.variant_launches)
    got = db.dense_layer(state.clone(), c_in, ops)
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.variant_launches == {**before,
                                              "f32": before["f32"] + 1}
    part_g, part_w = got[..., c_in:c_in + 32], want[..., c_in:c_in + 32]
    err = (part_g - part_w).abs().max() / part_w.abs().max()
    assert err <= KERNEL_REL_TOL, err.item()
    assert torch.equal(got[..., :c_in], state[..., :c_in])
    assert torch.equal(got[..., c_in + 32:], state[..., c_in + 32:])


@pytest.mark.cuda
def test_f32_kernel_refuses_bf16_operands(dev):
    state, ops = _card_layer(dev, 1, 8, 8, 64, 128)
    with pytest.raises(TypeError):
        db.dense_layer(state.to(torch.bfloat16), 64, ops, "f32")
    with pytest.raises(ValueError):
        db.dense_layer(state, 64, ops._replace(w1=ops.w1.to(torch.bfloat16)))


@pytest.mark.cuda
def test_f32_densenet_eval_forward_through_the_kernel(dev):
    """An f32 DenseNet's eval forward on the card: every dense layer through
    the f32 kernel, features against the plain-version forward."""
    spec = DenseNetSpec((2, 3), growth_rate=32, num_init_features=64)
    g = torch.Generator().manual_seed(0)
    model = DenseNet(spec, dtype=torch.float32, generator=g).eval().to(dev)
    x = torch.randn(3, 64, 64, 3, device=dev)
    before = dict(db.dense_layer.variant_launches)
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        assert db.dense_layer.variant_launches == {
            **before, "f32": before["f32"] + 5}
        with db.plain_dense_layers(model):
            want = model(x)
    err = (got - want).abs().max() / want.abs().max()
    assert err <= KERNEL_REL_TOL, err.item()
