"""The cluster dense-layer kernel's partition, budget and route, on CPU.

``csrc/dense_layer_cluster.cu`` runs one cluster of S CTAs per 8x8 tile:
CTA r takes 32-channel units of c_in (conv1 split-K), then owns a slice of
the bottleneck channels (the reduce of conv1, conv2 split-K) and of the
output pixels (the reduce of conv2). ``dense_block`` mirrors that partition
and the kernel's shared memory; the tests hold the mirror against the source,
show that the partition covers every channel and pixel once for every
DenseNet121/169/201 small-map layer, that the split-K arithmetic in that
partition gives the plain version's layer, and that the route takes the
kernels and cluster sizes that PERF.md records. Nothing here needs a card.
"""
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tennis_torch.models.backbones.densenet import DENSENET_SPECS
from tennis_torch.ops import dense_block as db

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tennis_torch", "csrc", "dense_layer_cluster.cu")


def small_map_c_ins(depth):
    """{map side: [c_in]} of the dense layers of DenseNet-``depth`` at 512^2
    (32^2, 16^2) and at 224^2 (14x14, 7x7)."""
    spec = DENSENET_SPECS[depth]
    out = {}
    for data_shape in (512, 224):
        side, channels = data_shape // 4, spec.num_init_features
        for n in spec.block_config:
            if side in (32, 16, 14, 7):
                out.setdefault(side, []).extend(
                    channels + j * spec.growth_rate for j in range(n))
            channels = (channels + n * spec.growth_rate) // 2
            side //= 2
    return out


@pytest.mark.parametrize("depth", [121, 169, 201])
def test_partition_covers_everything_once(depth):
    """For every cluster size and small-map c_in: the CTAs' input channels
    are whole 32-channel units that tile [0, c_in) in rank order, and their
    bottleneck channels and output pixels tile [0, 128) and [0, 64)."""
    maps = small_map_c_ins(depth)
    assert sorted(maps) == [7, 14, 16, 32]
    top = {121: 992, 169: 1632, 201: 1888}[depth]
    assert max(max(v) for v in maps.values()) == top
    for c_ins in maps.values():
        for c_in in c_ins:
            for cluster in db.CLUSTER_SIZES:
                parts = db.cluster_partition(c_in, cluster)
                assert len(parts) == cluster
                for axis, end in ((0, c_in), (1, db.BOTTLENECK), (2, 64)):
                    edges = [p[axis] for p in parts]
                    assert edges[0][0] == 0 and edges[-1][1] == end
                    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
                units = [(hi - lo) // 32 for (lo, hi), _, _ in parts]
                assert all(lo % 32 == 0 and hi % 32 == 0
                           for (lo, hi), _, _ in parts)
                assert max(units) - min(units) <= 1 and sum(units) == c_in // 32


def test_budget_and_constants_of_the_source():
    """The mirror's constants and budgets against the source's, and two CTAs
    per SM (228 KB, 1 KB reserved for each) at cluster sizes 4 and 8."""
    with open(SOURCE) as f:
        src = f.read()
    const = {name: int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)[1])
             for name in ("kStages", "kChunk", "kUnit", "kSmemLimit", "kThreads")}
    assert const["kStages"] == db.CLUSTER_STAGES
    assert const["kChunk"] == db.CLUSTER_CHUNK
    assert const["kUnit"] == 32 and const["kThreads"] == 256
    assert const["kSmemLimit"] == db.SMEM_LIMIT
    stated = re.search(r"(\d+,\d+) at S = 2, (\d+,\d+) at S = 4 and (\d+,\d+) at\n"
                       r"// S = 8", src)
    assert [int(v.replace(",", "")) for v in stated.groups()] == [
        db.cluster_smem_bytes(s) for s in db.CLUSTER_SIZES] == [135_232, 110_400,
                                                                97_984]
    for cluster in db.CLUSTER_SIZES:
        assert db.cluster_smem_bytes(cluster) <= db.SMEM_LIMIT
    for cluster in (4, 8):
        assert 2 * (db.cluster_smem_bytes(cluster) + 1024) <= 228 * 1024
    assert re.search(r"case (\d+): return", src) and sorted(
        int(s) for s in re.findall(r"case (\d+): return", src)) == list(db.CLUSTER_SIZES)


def _cluster_emulation(state, c_in, ops, cluster):
    """The kernel's arithmetic in f32, in its partition: per-CTA conv1
    partials over its input channels summed in rank order, BN2 / ReLU / mask
    / rounding per owned channel slice, per-CTA conv2 partials over those
    channels summed in rank order. The zero padding of conv2 is the mask."""
    dt = state.dtype
    parts = db.cluster_partition(c_in, cluster)
    x = state[..., :c_in].float()
    h = torch.relu(x * ops.inv1 + ops.sh1).to(dt).float().permute(0, 3, 1, 2)
    w1 = ops.w1.float()[:, :, None, None]
    bneck = 0
    for (lo, hi), _, _ in parts:
        if hi > lo:  # a CTA without units adds zeros
            bneck = bneck + F.conv2d(h[:, lo:hi], w1[:, lo:hi])
    b = torch.relu(bneck * ops.inv2[:, None, None] + ops.sh2[:, None, None])
    b = b.to(dt).float()
    w2 = ops.w2.float().permute(2, 3, 0, 1)
    out = 0
    for _, (lo, hi), _ in parts:
        out = out + F.conv2d(b[:, lo:hi], w2[:, lo:hi], padding=1)
    return out.permute(0, 2, 3, 1).to(dt)


@pytest.mark.parametrize("c_in,cluster", [(96, 2), (288, 8), (512, 4), (64, 8)])
def test_split_k_in_the_partition_is_the_layer(c_in, cluster):
    """The split-K sums of the partition give the plain version's layer (f32
    state: equal up to the order of summation)."""
    rng = np.random.default_rng(c_in + cluster)
    B, H, W = 2, 9, 7

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)

    state = t(B, H, W, c_in + 32)
    ops = db.LayerOperands(t(c_in).abs() + 0.5, t(c_in) * 0.5,
                           t(128, c_in, scale=c_in ** -0.5), t(128).abs() + 0.5,
                           t(128) * 0.5, t(3, 3, 32, 128, scale=1152 ** -0.5))
    want = db.dense_layer_reference(state.clone(), c_in, ops)[..., c_in:]
    got = _cluster_emulation(state, c_in, ops, cluster)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# DenseNet121-512: (block, map side, first c_in, layers)
_BLOCKS_121 = [(0, 128, 64, 6), (1, 64, 128, 12), (2, 32, 256, 24), (3, 16, 512, 16)]


@pytest.mark.parametrize("batch,want", [
    (8, {0: ("persistent", None), 1: ("persistent", None),
         2: ("persistent", None), 3: ("cluster", 4)}),
    (1, {0: ("persistent", None), 1: ("persistent", None),
         2: ("cluster", 4), 3: ("cluster", 8)}),
])
def test_route_of_every_densenet121_layer(batch, want):
    """The kernel and cluster size PERF.md records for each DenseNet121-512
    layer at batch 8 and 1; 58 layers, 18 + 24 persistent at batch 8."""
    counts = dict.fromkeys(db.VARIANTS, 0)
    for block, side, first, layers in _BLOCKS_121:
        for c_in in range(first, first + 32 * layers, 32):
            route = db.dense_layer_route(batch, side, side, c_in)
            assert route == want[block], (block, c_in)
            counts[route[0]] += 1
    assert sum(counts.values()) == 58
    if batch == 8:
        assert counts == {"persistent": 42, "tile": 0, "cluster": 16}


@pytest.mark.parametrize("batch,side,c_in,want", [
    (8, 7, 992, 8), (1, 7, 512, 8), (8, 14, 256, 4), (1, 14, 992, 8),
    (1, 32, 1312, 4), (1, 32, 1344, 8), (1, 32, 1760, 8), (8, 16, 1888, 4),
    (4, 16, 512, 4), (2, 32, 256, 4),
])
def test_route_of_other_small_maps(batch, side, c_in, want):
    """Ragged maps, DenseNet169/201's largest c_in and batches between: the
    first row of SMALL_MAP_ROUTES the tile count and c_in meet; a forced
    cluster launch takes the same size."""
    assert db.dense_layer_route(batch, side, side, c_in) == ("cluster", want)
    assert db.dense_layer_cluster_size(batch, side, side, c_in) == want


def test_forced_cluster_size_off_route():
    """Where the route takes another kernel, a forced cluster launch takes
    the last cluster row's size."""
    assert db.dense_layer_route(8, 32, 32, 992) == ("persistent", None)
    assert db.dense_layer_cluster_size(8, 32, 32, 992) == 4
    assert db.dense_layer_cluster_size(8, 128, 128, 64) == 4


def test_cpu_cluster_runs_the_plain_version():
    """On CPU the cluster variant at any size runs the plain version and
    counts no launch."""
    rng = np.random.default_rng(3)
    c_in = 64
    state = torch.from_numpy(rng.normal(size=(1, 5, 6, 96)).astype(np.float32))
    ops = db.LayerOperands(torch.ones(c_in), torch.zeros(c_in),
                           torch.from_numpy(rng.normal(size=(128, c_in)).astype(
                               np.float32)), torch.ones(128), torch.zeros(128),
                           torch.from_numpy(rng.normal(size=(3, 3, 32, 128)).astype(
                               np.float32)))
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    before = (db.dense_layer.launches, dict(db.dense_layer.variant_launches))
    for cluster in (None, *db.CLUSTER_SIZES):
        got = db.dense_layer(state.clone(), c_in, ops, "cluster", cluster)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (db.dense_layer.launches, db.dense_layer.variant_launches) == before
