"""The f32 dense layer on the tensor cores (``csrc/dense_layer_f32_tc.cu``,
variant ``"f32"``): 3xTF32 ``wgmma`` over weights split on the host.

On the CPU: ``tf32_split`` bit for bit against a numpy emulation of
``cvt.rna.tf32.f32`` (signs, zeros, ties); the kernel's weight image
(``tf32_image``), built by the wrapper once per set of weights and only for
the kernel (``layer_operands`` stays plain); a numpy emulation of the kernel's 3xTF32 arithmetic (each K step of 8
three tensor-core products, small terms first, summed per 32-channel block
rounding toward zero as the tensor cores add, each block's sum then added
to f32 sums rounding to nearest) over
the JAX package's ``dense_layer_pallas(interpret=True, dtype=float32)``
layer within 1e-5 of the f64 evaluation, where one TF32 product a pair
misses that bound (the card's gate has teeth); the route and the wrapper's
checks of the f32 kernel. Marked ``cuda`` and skipped without a card:
the kernel against its plain version and f64 at the card shapes of
``test_torch_dense_f32.py``, and its refusal of operands it does not take.
On a machine with a card: ``python -m pytest tests/test_torch_dense_tf32x3.py
-m cuda --noconftest -q``. On the CPU: ``python -m pytest
tests/test_torch_dense_tf32x3.py -q`` (seconds).
"""
import numpy as np
import pytest
import torch
from test_torch_dense_f32 import _card_layer, _layer_shapes, _numpy_layer
from test_torch_dense_f32 import _torch_operands as _operands

from tennis_torch.models import DENSENET_SPECS
from tennis_torch.ops import dense_block as db

# max |x - f64| / max |f64| over the growth part: 3xTF32 and f32 FMA both
# lie ~1e-7..1e-6 off f64 at these widths; one TF32 product ~3e-4
F64_REL_TOL = 1e-5
# max |kernel - plain| / max |plain|: f32 sums in another order
KERNEL_REL_TOL = 1e-4


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` in numpy: the magnitude rounded to 10 mantissa
    bits, to nearest, ties away from zero; the sign kept."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = bits & np.uint32(0x7FFFFFFF)
    mag = (mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return (sign | mag).view(np.float32)


def np_split(x):
    x = np.asarray(x, np.float32)
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def _values(case):
    rng = np.random.default_rng(7)
    if case == "normal":
        return rng.normal(size=4096).astype(np.float32)
    if case == "wide":  # magnitudes over 2^-60 .. 2^60, both signs
        return (rng.choice([-1, 1], 4096) * 2.0 ** rng.uniform(-60, 60, 4096)
                ).astype(np.float32)
    if case == "zeros":
        return np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, -(2.0 ** -130)],
                        np.float32)
    # ties and their neighbours: the 13 dropped bits exactly 0x1000, one
    # below, one above, on even and odd kept mantissas, both signs
    mant = rng.integers(0, 1 << 10, 64).astype(np.uint32) << np.uint32(13)
    exp = rng.integers(100, 150, 64).astype(np.uint32) << np.uint32(23)
    out = []
    for low in (0x1000, 0x0FFF, 0x1001, 0x1FFF, 0x0001):
        for sign in (0, 0x80000000):
            out.append((np.uint32(sign) | exp | mant | np.uint32(low))
                       .view(np.float32))
    return np.concatenate(out)


@pytest.mark.parametrize("case", ["normal", "wide", "zeros", "ties"])
def test_tf32_split_matches_cvt_rna(case):
    x = _values(case)
    hi, lo = db.tf32_split(torch.from_numpy(x))
    want_hi, want_lo = np_split(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  want_lo.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    # hi + lo within 2^-21 of x, relative; signs of zeros kept
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    np.testing.assert_array_equal(np.signbit(hi.numpy()), np.signbit(x))
    if case == "ties":  # ties round away from zero: |hi| >= |x| at 0x1000
        tie = (x.view(np.uint32) & 0x1FFF) == 0x1000
        assert (np.abs(hi.numpy()[tie]) > np.abs(x[tie])).all()


def test_tf32_image_layout():
    """Piece c of row n of each (hi, lo) block lies at c ^ (n % 8): the
    128-byte swizzle of a wgmma operand; leading dimensions kept."""
    m = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 40, 96))
                         .astype(np.float32))
    image = db.tf32_image(m).numpy()
    assert image.shape == (3, 3, 2, 40, 32)
    halves = np_split(m.numpy())
    for hl in range(2):
        for n in range(40):
            for p in range(8):
                c = p ^ (n % 8)
                np.testing.assert_array_equal(
                    image[:, :, hl, n, 4 * p:4 * p + 4],
                    halves[hl][:, n].reshape(3, 3, 8, 4)[:, :, c])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_operands_carry_no_split(dtype):
    """The split is the kernel's own: operands hold the exact weights, six
    tensors, at any dtype."""
    p, s = _numpy_layer(np.random.default_rng(0), 96)
    ops = _operands(p, s, dtype)
    assert len(ops) == 6 and db.LayerOperands._fields[-1] == "w2"
    assert ops.w1.dtype == ops.w2.dtype == dtype
    assert ops.w1.shape == (128, 96) and ops.w2.shape == (3, 3, 32, 128)


@pytest.mark.parametrize("change", ["none", "w1_in_place", "w2_in_place",
                                    "new_w2", "inference"])
def test_tf32_weights_built_once_per_set_of_weights(change):
    """The wrapper's images of ``w1`` and of each tap of ``w2``: built at the
    first call, the same tensors at the next, built anew after the weights
    change in place or ``w2`` is another tensor; operands made in
    inference mode (a decode's) too."""
    p, s = _numpy_layer(np.random.default_rng(4), 96)
    if change == "inference":
        with torch.inference_mode():
            ops = _operands(p, s)
    else:
        ops = _operands(p, s)
    w1_img, w2_img = db._tf32_weights(ops)
    assert w1_img.shape == (3, 2, 128, 32)
    assert w2_img.shape == (9, 4, 2, 32, 32)
    assert torch.equal(w1_img, db.tf32_image(ops.w1))
    assert torch.equal(w2_img, db.tf32_image(ops.w2.reshape(9, 32, 128)))
    if change == "w1_in_place":
        ops.w1.mul_(2)
    elif change == "w2_in_place":
        ops.w2.mul_(2)
    elif change == "new_w2":
        ops = ops._replace(w2=ops.w2 * 2)
    again = db._tf32_weights(ops)
    if change in ("none", "inference"):
        assert again[0] is w1_img and again[1] is w2_img
        return
    assert again[0] is not w1_img
    assert torch.equal(again[0], db.tf32_image(ops.w1))
    assert torch.equal(again[1], db.tf32_image(ops.w2.reshape(9, 32, 128)))


def _round_toward_zero(x64):
    """f64 -> f32, rounded toward zero (how the tensor cores add)."""
    y = x64.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x64)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _matmul_tf32(a, b, products):
    """(P, K) @ (K, N) as the kernel takes it: each 32-wide K block summed
    from zero in K steps of 8, each step the given TF32 products (pairs of
    (a part, b part) indices into (hi, lo)), each product's dot exact and
    added to the block's sum rounding toward zero, as the tensor cores add;
    every block's sum then added to the f32 sums, rounding to nearest."""
    sa, sb = np_split(a), np_split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 32):
        part = np.zeros_like(acc)
        for k in range(k0, k0 + 32, 8):
            for ia, ib in products:
                step = sa[ia][:, k:k + 8].astype(np.float64) @ \
                    sb[ib][k:k + 8].astype(np.float64)
                part = _round_toward_zero(part.astype(np.float64) + step)
        acc = (acc + part).astype(np.float32)
    return acc


THREE = ((1, 0), (0, 1), (0, 0))  # a_lo b_hi, a_hi b_lo, a_hi b_hi
ONE = ((0, 0),)


def _emulated_layer(x, ops, products):
    """The kernel's arithmetic on the CPU: BN1 + ReLU (one rounding, as its
    fma), conv1 and conv2 (taps outer, bottleneck channels inner, as its K
    order) through ``_matmul_tf32``, BN2 + ReLU, conv2's zero padding.
    (B, H, W, c_in) f32 -> (B, H, W, 32) f32."""
    inv1, sh1, w1, inv2, sh2, w2 = (t.double().numpy() for t in ops[:6])
    B, H, W, c_in = x.shape
    h = np.maximum(x.astype(np.float64) * inv1 + sh1, 0).astype(np.float32)
    b = _matmul_tf32(h.reshape(-1, c_in), w1.T.astype(np.float32), products)
    b = np.maximum(b.astype(np.float64) * inv2 + sh2, 0).astype(np.float32)
    b = np.pad(b.reshape(B, H, W, 128), ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.concatenate([b[:, dy:dy + H, dx:dx + W].reshape(-1, 128)
                           for dy in range(3) for dx in range(3)], 1)
    wt = w2.reshape(9, 32, 128).transpose(0, 2, 1).reshape(9 * 128, 32)
    return _matmul_tf32(cols, wt.astype(np.float32), products).reshape(
        B, H, W, 32)


def _f64_layer(x, ops):
    """The growth part of the plain version run in f64 over ``x``."""
    state = torch.zeros(*x.shape[:3], x.shape[3] + 32, dtype=torch.float64)
    state[..., :x.shape[3]] = torch.from_numpy(x)
    return db.dense_layer_reference(state, x.shape[3], ops)[
        ..., x.shape[3]:].numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,H,W,c_in,c_final", [
    (2, 7, 7, 128, 256),    # a ragged map (7 is no multiple of 8)
    (1, 16, 16, 224, 256),  # the last c_in of a 256-channel block
])
def test_3xtf32_emulation_matches_pallas_and_f64(B, H, W, c_in, c_final):
    import jax.numpy as jnp

    from tennis_tpu.ops.pallas.dense_block import _layer_operands, \
        dense_layer_pallas

    rng = np.random.default_rng(c_in + H + 1)
    x = rng.normal(size=(B, H, W, c_in)).astype(np.float32)
    p, s = _numpy_layer(rng, c_in)
    padded = np.zeros((B, H + 2, W + 16, c_final), np.float32)
    padded[:, 1:-1, 8:-8, :c_in] = x
    pallas = np.asarray(dense_layer_pallas(
        jnp.asarray(padded), *_layer_operands(p, s, c_in, jnp.float32),
        c_in=c_in, dtype=jnp.float32, interpret=True))
    pallas = pallas[:, 1:-1, 8:-8, c_in:c_in + 32]

    ops = _operands(p, s)
    want = _f64_layer(x, ops)
    three = _emulated_layer(x, ops, THREE)
    one = _emulated_layer(x, ops, ONE)
    assert _rel(pallas, want) <= F64_REL_TOL
    assert _rel(three, want) <= F64_REL_TOL, _rel(three, want)
    assert _rel(three, pallas) <= F64_REL_TOL
    # one TF32 product a pair misses the card's gate by far
    assert _rel(one, want) > 10 * F64_REL_TOL, _rel(one, want)


@pytest.mark.parametrize("depth", [121, 169, 201])
def test_every_f32_layer_routes_to_the_tensor_core_kernel(depth):
    routed = set()
    for batch in (1, 2, 24, 64):
        for side, c_in in _layer_shapes(DENSENET_SPECS[depth]):
            for dtype in (torch.float32, torch.bfloat16):
                routed.add(db.dense_layer_route(batch, side, side, c_in,
                                                dtype=dtype)[0])
            assert db.dense_layer_route(batch, side, side, c_in,
                                        dtype=torch.float32) == ("f32", None)
    assert "f32" in routed
    assert set(db._LIBRARIES) == set(db.KERNEL_VARIANTS)
    assert db._LIBRARIES["f32"] == "dense_layer_f32_tc"


@pytest.mark.parametrize("case", ["bf16_state", "bf16_w1", "bf16_w2", "c_in",
                                  "w1_shape", "growth", "strided_state",
                                  "past_channels"])
def test_f32_kernel_argument_checks(case):
    p, s = _numpy_layer(np.random.default_rng(0), 64)
    ops = _operands(p, s)
    state = torch.zeros(1, 4, 4, 128)
    c_in = 64
    if case == "bf16_state":
        state = state.to(torch.bfloat16)
    elif case == "bf16_w1":
        ops = ops._replace(w1=ops.w1.to(torch.bfloat16))
    elif case == "bf16_w2":
        ops = ops._replace(w2=ops.w2.to(torch.bfloat16))
    elif case == "c_in":
        c_in = 48
    elif case == "w1_shape":
        ops = ops._replace(w1=ops.w1[:, :32].contiguous())
    elif case == "growth":
        ops = ops._replace(w2=torch.zeros(3, 3, 48, 128))
    elif case == "strided_state":
        state = torch.zeros(1, 4, 8, 128)[:, :, ::2]
    else:
        c_in = 128
    with pytest.raises((TypeError, ValueError)):
        db._check_kernel_args(state, c_in, ops, "f32")
    # well-formed: the f32 kernel takes the exact f32 operands as they are
    db._check_kernel_args(torch.zeros(1, 4, 4, 128), 64, _operands(p, s),
                          "f32")


@pytest.mark.parametrize("variant", [None, "f32"])
def test_cpu_tensors_take_the_plain_version(variant):
    p, s = _numpy_layer(np.random.default_rng(1), 32)
    ops = _operands(p, s)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 5, 6, 64))
                         .astype(np.float32))
    before = (db.dense_layer.launches, dict(db.dense_layer.variant_launches))
    got = db.dense_layer(x.clone(), 32, ops, variant)
    want = db.dense_layer_reference(x.clone(), 32, ops)
    assert torch.equal(got, want)
    assert (db.dense_layer.launches, db.dense_layer.variant_launches) == before
    with pytest.raises(ValueError):
        db.dense_layer(x.clone(), 32, ops, "f64")


@pytest.mark.parametrize("kernel", ["persistent", "cluster", "f32_tc"])
def test_ablation_edits_match_their_source(kernel):
    """Every one-edit ablation of ``tools/dense_layer_ablation.py`` finds
    its text exactly once in the kernel's source, so the tool builds each
    ablation of the source as it is."""
    from tennis_torch.ops._build import CSRC
    from tennis_torch.tools.dense_layer_ablation import ABLATIONS, CASES

    with open(f"{CSRC}/dense_layer_{kernel}.cu") as f:
        source = f.read()
    for name, edits in ABLATIONS[kernel].items():
        for old, _ in edits:
            assert source.count(old) == 1, (name, old)
    assert CASES[kernel]


# ------------------------------------------------------------------ the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [
    (2, 8, 8, 64, 128), (2, 7, 7, 96, 128), (1, 4, 4, 128, 160),
    (3, 13, 9, 32, 64), (1, 1, 1, 64, 96), (2, 24, 17, 224, 256),
    (2, 128, 128, 64, 256), (2, 16, 16, 992, 1024),
    (1, 16, 16, 1888, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,c_in,c_final", CARD_SHAPES)
def test_tensor_core_kernel_matches_plain_and_f64(dev, batch, h, w, c_in,
                                                  c_final):
    state, ops = _card_layer(dev, batch, h, w, c_in, c_final, c_in + h)
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    want64 = db.dense_layer_reference(state.double(), c_in,
                                      ops)[..., c_in:c_in + 32].cpu()
    before = dict(db.dense_layer.variant_launches)
    got = db.dense_layer(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.variant_launches == {**before,
                                              "f32": before["f32"] + 1}
    part = got[..., c_in:c_in + 32]
    err = (part - want[..., c_in:c_in + 32]).abs().max() / \
        want[..., c_in:c_in + 32].abs().max()
    assert err <= KERNEL_REL_TOL, err.item()
    assert _rel(part.double().cpu().numpy(), want64.numpy()) <= F64_REL_TOL
    assert torch.equal(got[..., :c_in], state[..., :c_in])
    assert torch.equal(got[..., c_in + 32:], state[..., c_in + 32:])


@pytest.mark.cuda
def test_tensor_core_kernel_refuses_what_it_does_not_take(dev):
    """No fallback: an f32 state with bf16 weights raises and launches
    nothing; the images of well-formed weights are built on the card once."""
    state, ops = _card_layer(dev, 2, 16, 16, 96, 128, 5)
    before = dict(db.dense_layer.variant_launches)
    with pytest.raises(ValueError):
        db.dense_layer(state.clone(), 96,
                       ops._replace(w2=ops.w2.to(torch.bfloat16)))
    assert db.dense_layer.variant_launches == before
    db.dense_layer(state.clone(), 96, ops)
    db.dense_layer(state.clone(), 96, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.variant_launches == {**before,
                                              "f32": before["f32"] + 2}
    w1_img, w2_img = db._tf32_weights(ops)
    assert w1_img.is_cuda and w1_img is db._tf32_weights(ops)[0]

