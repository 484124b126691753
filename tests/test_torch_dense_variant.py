"""Which dense-layer kernel the wrapper takes, and the persistent kernel's
shared-memory budget, on CPU.

``dense_layer_variant`` sends the large maps of DenseNet at 512^2 to the
persistent kernel (``csrc/dense_layer_persistent.cu``) and the small ones
to the persistent or the cluster kernel (``csrc/dense_layer_cluster.cu``),
as measured; ``persistent_smem_bytes`` mirrors the launcher's budget. On CPU
tensors ``dense_layer`` still runs its plain version, whatever the variant,
and that still matches the JAX Pallas kernel in interpret mode.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.ops.pallas.dense_block import _layer_operands, dense_layer_pallas
from tennis_torch.models.backbones.densenet import DENSENET_SPECS
from tennis_torch.ops import dense_block as db

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tennis_torch", "csrc", "dense_layer_persistent.cu")


def block_layers(depth, data_shape=512):
    """(block, map side, c_in) of every dense layer of DenseNet-``depth``."""
    spec = DENSENET_SPECS[depth]
    side, channels = data_shape // 4, spec.num_init_features
    out = []
    for i, n in enumerate(spec.block_config):
        out += [(i, side, channels + j * spec.growth_rate) for j in range(n)]
        channels = (channels + n * spec.growth_rate) // 2
        side //= 2
    return out


@pytest.mark.parametrize("depth", [121, 169, 201])
@pytest.mark.parametrize("batch", [1, 8])
def test_every_128_map_layer_goes_persistent(depth, batch):
    block0 = [(s, c) for b, s, c in block_layers(depth) if b == 0]
    assert [s for s, _ in block0] == [128] * 6
    for side, c_in in block0:
        assert db.dense_layer_variant(batch, side, side, c_in) == "persistent"


@pytest.mark.parametrize("depth", [121, 169, 201])
def test_small_maps_go_to_the_tile_kernel(depth):
    """The small maps follow the measured routes (PERF.md): at batch 8
    the 32^2 map goes to the persistent kernel and the 16^2 map to clusters
    of 4; at batch 1 the 32^2 map to clusters of 4 (of 8 from c_in 1344) and
    the 16^2 map to clusters of 8; nothing goes to the tile kernel."""
    small = [(s, c) for b, s, c in block_layers(depth) if s < db.PERSISTENT_MIN_SIDE]
    assert {s for s, _ in small} == {32, 16}
    for side, c_in in small:
        want8 = ("persistent", None) if side == 32 else ("cluster", 4)
        want1 = ("cluster", 8 if side == 16 or c_in >= 1344 else 4)
        assert db.dense_layer_route(8, side, side, c_in) == want8
        assert db.dense_layer_route(1, side, side, c_in) == want1
    # the ragged 7x7 map (DenseNet at 224^2) as well
    assert db.dense_layer_route(8, 7, 7, 512) == ("cluster", 8)


@pytest.mark.parametrize("depth", [121, 169, 201])
def test_large_map_layers_fit_the_budget(depth):
    """Every layer the persistent kernel may take fits in 232,448 B; w1 is
    resident at every 128^2 layer and streams from c_in 320 on."""
    for block, side, c_in in block_layers(depth):
        if side < 64:
            continue
        nbytes, resident = db.persistent_smem_bytes(c_in)
        assert nbytes <= 232_448 == db.SMEM_LIMIT
        assert resident == (c_in <= 288)
        if block == 0:
            assert resident


def test_budget_numbers_of_the_source():
    """The mirror's constants and the budgets that the source states."""
    with open(SOURCE) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kStages = (\d+);", src)[1]) == db.STAGES
    assert int(re.search(r"constexpr int kChunk = (\d+);", src)[1]) == db.CHUNK
    assert int(re.search(r"kSmemLimit = (\d+);", src)[1]) == db.SMEM_LIMIT
    assert db.persistent_smem_bytes(64) == (172_864, True)
    assert db.persistent_smem_bytes(224) == (215_104, True)
    assert db.persistent_smem_bytes(288) == (232_000, True)
    assert db.persistent_smem_bytes(320) == (211_776, False)
    assert db.persistent_smem_bytes(480) == (213_056, False)


def test_past_the_budget_goes_to_the_tile_kernel():
    assert db.persistent_smem_bytes(2880)[0] <= db.SMEM_LIMIT
    assert db.dense_layer_variant(8, 128, 128, 2880) == "persistent"
    assert db.persistent_smem_bytes(2912)[0] > db.SMEM_LIMIT
    assert db.dense_layer_variant(8, 128, 128, 2912) == "tile"


def test_unknown_variant_raises():
    ops = db.LayerOperands(torch.ones(64), torch.zeros(64),
                           torch.zeros(128, 64), torch.ones(128),
                           torch.zeros(128), torch.zeros(3, 3, 32, 128))
    with pytest.raises(ValueError, match="variant"):
        db.dense_layer(torch.zeros(1, 4, 4, 96), 64, ops, "wgmma")


@pytest.mark.parametrize("variant", [None, "persistent", "tile", "cluster"])
def test_cpu_runs_the_plain_version_and_matches_pallas(variant):
    """On CPU every variant runs the plain version (no launch), which agrees
    with dense_layer_pallas(interpret=True) in f32 at one 16^2 shape."""
    rng = np.random.default_rng(11)
    B, H, W, c_in, c_final = 1, 16, 16, 64, 128
    x = rng.normal(size=(B, H, W, c_in)).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    p = {"bn1": {"scale": f32(rng.uniform(0.5, 1.5, c_in)),
                 "bias": f32(rng.normal(size=c_in))},
         "conv1": {"kernel": f32(rng.normal(0, c_in ** -0.5, (1, 1, c_in, 128)))},
         "bn2": {"scale": f32(rng.uniform(0.5, 1.5, 128)),
                 "bias": f32(rng.normal(size=128))},
         "conv2": {"kernel": f32(rng.normal(0, (9 * 128) ** -0.5, (3, 3, 128, 32)))}}
    s = {"bn1": {"mean": f32(rng.normal(size=c_in) * 0.1),
                 "var": f32(rng.uniform(0.5, 2, c_in))},
         "bn2": {"mean": f32(rng.normal(size=128) * 0.1),
                 "var": f32(rng.uniform(0.5, 2, 128))}}

    padded = np.zeros((B, H + 2, W + 16, c_final), np.float32)
    padded[:, 1:-1, 8:-8, :c_in] = x
    want = np.asarray(dense_layer_pallas(
        jnp.asarray(padded), *_layer_operands(p, s, c_in, jnp.float32),
        c_in=c_in, dtype=jnp.float32, interpret=True))[:, 1:-1, 8:-8, :c_in + 32]

    def bn(name):
        return tuple(torch.from_numpy(d[name][k]) for d, k in
                     ((p, "scale"), (p, "bias"), (s, "mean"), (s, "var")))

    ops = db.layer_operands(
        bn("bn1"), torch.from_numpy(p["conv1"]["kernel"]).permute(3, 2, 0, 1),
        bn("bn2"), torch.from_numpy(p["conv2"]["kernel"]).permute(3, 2, 0, 1),
        torch.float32)
    state = torch.zeros((B, H, W, c_final))
    state[..., :c_in] = torch.from_numpy(x)
    before = (db.dense_layer.launches, dict(db.dense_layer.variant_launches))
    got = db.dense_layer(state, c_in, ops, variant)
    assert got is state
    assert (db.dense_layer.launches, db.dense_layer.variant_launches) == before
    np.testing.assert_allclose(got[..., :c_in + 32].numpy(), want,
                               rtol=1e-4, atol=1e-4)
    assert not got[..., c_in + 32:].any()
    assert jax.devices()[0].platform == "cpu"
