"""The port's train augment against the JAX package's: ``apply_augment``
with the draws that ``device_augment`` makes from a ``jax.random`` key
injected, ``color_jitter_coeffs`` over every order, and the host train
geometry (``RandomResizedCrop``) bit for bit under the same numpy
generator. Tolerances: f32 outputs within 2e-6 absolute (normalized values
of magnitude ~2, the same f32 ops, luma mean summed in another order), bf16
outputs within one bf16 step of 2.6 (2^-6), coefficients within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.data import transforms as jax_t
from tennis_torch.data import transforms as T

JITTER, LIGHTING = 0.4, 0.1


def _jax_draws(key, batch):
    """The draws ``tennis_tpu.data.transforms.device_augment`` makes from
    ``key``, in its order of splits, as port ``AugmentDraws``."""
    k_flip, k_b, k_c, k_s, k_l, k_order = jax.random.split(key, 6)
    flip = jax.random.bernoulli(k_flip, 0.5, (batch, 1, 1, 1))
    f = [1.0 + jax.random.uniform(k, (batch,), minval=-JITTER, maxval=JITTER)
         for k in (k_b, k_c, k_s)]
    order = jax.random.randint(k_order, (batch,), 0, 6)
    alpha = jax.random.normal(k_l, (batch, 3)) * LIGHTING
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.AugmentDraws(t(flip).reshape(batch), *map(t, f), t(order),
                          t(alpha))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_matches_device_augment(seed):
    batch = 32  # every order drawn at least once at these seeds
    images = np.random.default_rng(seed).integers(
        0, 256, (batch, 24, 20, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, batch)
    assert set(draws.order.tolist()) == set(range(6))
    assert 0 < int(draws.flip.sum()) < batch
    want = np.asarray(jax_t.device_augment(jnp.asarray(images), key,
                                           dtype=jnp.float32))
    got = T.apply_augment(torch.from_numpy(images), draws, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (batch, 24, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    want_bf = np.asarray(jax_t.device_augment(jnp.asarray(images), key),
                         np.float32)
    got_bf = T.apply_augment(torch.from_numpy(images), draws).float().numpy()
    assert np.abs(got_bf - want_bf).max() <= 2 ** -6


def test_color_jitter_coeffs_match_jax():
    rng = np.random.default_rng(0)
    n = 60
    fb, fc, fs = (rng.uniform(0.6, 1.4, n).astype(np.float32)
                  for _ in range(3))
    mean_luma = rng.uniform(0, 1, n).astype(np.float32)
    order = np.arange(n) % 6
    want = jax_t.color_jitter_coeffs(*map(jnp.asarray,
                                          (fb, fc, fs, mean_luma, order)))
    got = T.color_jitter_coeffs(*map(torch.from_numpy,
                                     (fb, fc, fs, mean_luma, order)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_luma_and_flip():
    x = torch.rand(2, 5, 7, 3)
    np.testing.assert_allclose(T.luma_of(x).numpy(),
                               np.asarray(jax_t.luma_of(jnp.asarray(
                                   x.numpy()))), atol=1e-7)
    ident = T.AugmentDraws(torch.tensor([True, False]), torch.ones(2),
                           torch.ones(2), torch.ones(2),
                           torch.zeros(2, dtype=torch.int64), torch.zeros(2, 3))
    images = torch.randint(0, 256, (2, 4, 6, 3), dtype=torch.uint8)
    got = T.apply_augment(images, ident, torch.float32)
    want = T.device_prepare(images, torch.float32)
    torch.testing.assert_close(got[0], want[0].flip(1), rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


def test_augment_draws_from_a_generator():
    """Shapes, dtypes and ranges of the draws; the same seed draws the
    same."""
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    d = T.augment_draws(4096, g())
    assert d.flip.dtype == torch.bool and 0.45 < d.flip.float().mean() < 0.55
    for f in (d.fb, d.fc, d.fs):
        assert f.shape == (4096,) and f.min() >= 0.6 and f.max() <= 1.4
    assert set(d.order.tolist()) == set(range(6))
    assert d.alpha.shape == (4096, 3) and abs(d.alpha.std() - 0.1) < 0.01
    again = T.augment_draws(4096, g())
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    images = torch.randint(0, 256, (3, 8, 8, 3), dtype=torch.uint8)
    assert torch.equal(T.device_augment(images, g()),
                       T.device_augment(images, g()))


def test_train_geometry_bit_identical():
    """The same numpy generator crops the same uint8 pixels, including the
    center-crop fallback of a 4 x 400 frame no random crop fits."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((60, 80, 3), (81, 47, 3), (4, 400, 3), (32, 32, 3))]
    mine, theirs = np.random.default_rng(9), np.random.default_rng(9)
    for img in frames * 3:
        got = T.train_geometry(img, 24, mine)
        want = jax_t.train_geometry(img, 24, theirs)
        assert got.dtype == np.uint8 and got.shape == (24, 24, 3)
        np.testing.assert_array_equal(got, want)
    assert mine.integers(1 << 30) == theirs.integers(1 << 30)


def test_thread_local_rng_streams_equal_jax():
    mine, theirs = T.ThreadLocalRng(5), jax_t.ThreadLocalRng(5)
    np.testing.assert_array_equal(mine.get().random(8),
                                  theirs.get().random(8))
