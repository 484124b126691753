"""The data-parallel helpers of the port against the JAX package's, with no
process group: ``pad_batch``, ``shard_rows`` against the JAX mesh's
``P("data")`` placement, ``global_keep_indices``, the world-striped
loader's global batches against the JAX loader's single-shard batches and
its per-host stripes, ``data_ranks`` (``make_mesh``'s refusal), and the GRU
decode's route past the card's budget against the JAX package's
``gru_fits_vmem`` rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.data.loader import DataLoader as JaxLoader
from tennis_tpu.data.loader import global_keep_indices as jax_keep
from tennis_tpu.ops.pallas.gru import gru_fits_vmem
from tennis_tpu.parallel.mesh import make_mesh, pad_batch as jax_pad_batch, \
    shard_batch
from tennis_torch.data.loader import DataLoader, global_keep_indices
from tennis_torch.ops import gru
from tennis_torch.ops.rnn import RNNLayer, _affine, _gru_recurrence, \
    gru_decode
from tennis_torch.parallel.mesh import data_ranks, pad_batch, shard_rows


@pytest.mark.parametrize("n,multiple", [(5, 2), (8, 4), (3, 8), (1, 1),
                                        (7, 3)])
def test_pad_batch_is_the_jax_one(n, multiple):
    rng = np.random.default_rng(n)
    batch = (rng.standard_normal((n, 3)).astype(np.float32),
             rng.integers(0, 9, n).astype(np.int32))
    want, want_n = jax_pad_batch(batch, multiple)
    got, got_n = pad_batch(batch, multiple)
    assert got_n == want_n == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    tensors, t_n = pad_batch(tuple(map(torch.from_numpy, batch)), multiple)
    assert t_n == n
    for g, w in zip(tensors, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_shard_rows_is_the_data_axis_placement():
    """Rank r's rows are the block ``P("data")`` puts on device r of a
    4-way data mesh."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    mesh = make_mesh(num_data=4, devices=jax.devices()[:4])
    sharded = shard_batch(mesh, jnp.asarray(x))
    blocks = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, device in enumerate(mesh.devices[:, 0]):
        np.testing.assert_array_equal(shard_rows(x, r, 4), blocks[device])
    with pytest.raises(ValueError, match="divide"):
        shard_rows(x, 0, 3)


@pytest.mark.parametrize("n_total", [1, 7, 16, 37])
@pytest.mark.parametrize("procs", [1, 2, 3, 4])
@pytest.mark.parametrize("host_batch", [1, 4, 8])
def test_global_keep_indices_are_the_jax_ones(n_total, procs, host_batch):
    per = -(-n_total // procs)
    off = 0
    while off < per:
        n = min(host_batch, per - off)
        np.testing.assert_array_equal(
            global_keep_indices(off, n, host_batch, procs, n_total),
            jax_keep(off, n, host_batch, procs, n_total))
        off += n


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_world_striped_batches_hold_the_single_shard_samples(world, shuffle):
    """With ``num_shards = world`` and a per-rank batch of ``B / world``,
    global batch k (every rank's batch k) holds the samples of the JAX
    loader's single-shard batch k, and each rank's the JAX loader's
    per-host stripe."""
    n, global_batch = 37, 8
    kw = dict(shuffle=shuffle, seed=3, drop_last=True, num_workers=1)
    for epoch in (0, 1):
        single = JaxLoader(_Range(n), global_batch, **kw)
        single.set_epoch(epoch)
        want = [set(b.tolist()) for b in single]
        ranks = []
        for r in range(world):
            mine = DataLoader(_Range(n), global_batch // world,
                              num_shards=world, shard_id=r, **kw)
            jax_stripe = JaxLoader(_Range(n), global_batch // world,
                                   num_shards=world, shard_id=r, **kw)
            mine.set_epoch(epoch)
            jax_stripe.set_epoch(epoch)
            got = [b.tolist() for b in mine]
            assert got == [b.tolist() for b in jax_stripe]
            ranks.append(got)
        assert len({len(r) for r in ranks}) == 1
        for k, batch in enumerate(want[:len(ranks[0])]):
            assert set(sum((r[k] for r in ranks), [])) == batch, (epoch, k)


def test_data_ranks_refuse_more_gpus_than_exist():
    have = torch.cuda.device_count()
    assert data_ranks(-1, "cuda") == have
    with pytest.raises(ValueError, match="mesh wants"):
        data_ranks(have + 1, "cuda")
    assert data_ranks(-1, "cpu") == 1
    assert data_ranks(3, "cpu") == 3


@pytest.mark.parametrize("T", [1, 8, 128, 512])
@pytest.mark.parametrize("B", [1, 4, 32])
def test_gru_route_past_the_budget_is_the_plain_recurrence(T, B):
    """At H = 1024 the JAX package never runs its kernel (Wh alone fills
    its VMEM budget) and the port's route takes the plain recurrence; at
    H = 256 both take their kernels."""
    assert not gru_fits_vmem(T, B, 1024)
    assert gru.gru_decode_route(T, B, 1024) == "plain"
    assert gru.gru_decode_route(T, B, 256) in gru.VARIANTS
    if T * B <= 128:
        assert gru_fits_vmem(T, B, 256)


@pytest.mark.parametrize("T,B,H", [(128, 4, 640), (1, 4, 768), (8, 8, 600)])
def test_gru_route_where_the_reference_runs_its_kernel_raises_on_the_card(
        T, B, H):
    """Where the JAX package runs its kernel (``gru_fits_vmem``: H 640 at
    the 0102 encoder's T 128, B 4) the route does not take the plain
    recurrence: it names a card kernel whose plan takes the shape (past the
    async one's H, the grid kernel where the general one streams Wh, else
    the general one), so its card launch does not raise; the CPU path of
    that variant gives the plain version's answer."""
    assert gru_fits_vmem(T, B, H) and gru.gru_fits_smem(T, B, H)
    variant = gru.gru_decode_route(T, B, H)
    plan = {"general": gru.general_plan, "grid": gru.grid_plan}[variant]
    assert plan(H, B) is not None
    rng = np.random.default_rng(H)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((T, B, 3 * H), (B, H), (H, 3 * H), (3 * H,))]
    vl = torch.tensor([T - i % T for i in range(B)], dtype=torch.int32)
    launches = gru.gru_recurrence.launches
    ys, h = gru.gru_recurrence(*args, vl, variant=variant)
    want_ys, want_h = gru.gru_recurrence_reference(*args, vl)
    torch.testing.assert_close(ys, want_ys, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    assert gru.gru_recurrence.launches == launches


def test_gru_decode_at_h1024_runs_the_plain_recurrence():
    """Inside ``gru_decode()`` an H = 1024 layer runs the plain recurrence
    (counted in ``plain_routed``, the kernel wrapper not called) and gives
    its answer; H = 16 and H = 640 layers (the JAX package runs its kernel
    at this T and B) still go through the wrapper."""
    rng = np.random.default_rng(0)
    calls = []
    real = gru.gru_recurrence

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    for hidden, kernel in ((1024, False), (16, True), (640, True)):
        layer = RNNLayer("gru", 8, hidden,
                         generator=torch.Generator().manual_seed(1)).eval()
        x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
        vl = torch.tensor([5, 3])
        before, calls[:] = gru.gru_recurrence.plain_routed, []
        import tennis_torch.ops.rnn as rnn

        rnn.gru_recurrence = spy
        try:
            with torch.inference_mode(), gru_decode():
                final, ys = layer(x, vl)
        finally:
            rnn.gru_recurrence = real
        assert bool(calls) == kernel
        assert gru.gru_recurrence.plain_routed == before + (not kernel)
        with torch.no_grad():
            gx = _affine(layer.i2h, torch.float32)(x).transpose(0, 1)
            want_ys, want = _gru_recurrence(
                gx, _affine(layer.recurrence.h2h, torch.float32),
                torch.zeros(2, hidden), vl.to(torch.int32))
        torch.testing.assert_close(final, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ys[:, :3], want_ys.transpose(0, 1)[:, :3],
                                   rtol=1e-5, atol=1e-5)
