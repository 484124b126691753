"""The port on a CUDA card: the three dense-layer kernels (tile, persistent
and cluster) against their plain version at small and ragged shapes, the
wrapper's refusals and choice of kernel, DenseNet forwards through the
kernels (DenseNet161's widths through ``dense_layer_convs``), and the two GRU
kernels. Marked ``cuda``; each test skips without a card. On a
machine with one, run them without the JAX conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest -q``."""
import pytest
import torch

from tennis_torch.models import DenseNet, DenseNetSpec
from tennis_torch.ops import dense_block as db

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2  # max |kernel - plain| / max |plain| with bf16 state


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, batch, h, w, c_in, c_final, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=g)

    state = rand(batch, h, w, c_final).to(torch.bfloat16)
    ops = db.LayerOperands(
        rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
        rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
        rand(128).abs() + 0.5, rand(128) * 0.5,
        rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))
    return state, ops


@pytest.mark.parametrize("batch,h,w,c_in,c_final", [
    (2, 8, 8, 64, 128), (2, 7, 7, 96, 128), (1, 4, 4, 128, 160),
    (3, 13, 9, 32, 64), (1, 1, 1, 64, 96), (2, 24, 17, 224, 256)])
def test_kernel_matches_plain(dev, batch, h, w, c_in, c_final):
    state, ops = _layer(dev, batch, h, w, c_in, c_final)
    launches = db.dense_layer.launches
    got = db.dense_layer(state.clone(), c_in, ops)
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.launches == launches + 1
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    err = (part_g - part_w).abs().max() / part_w.abs().max()
    assert err <= REL_TOL, err.item()
    torch.testing.assert_close(got[..., :c_in], state[..., :c_in], rtol=0, atol=0)
    torch.testing.assert_close(got[..., c_in + 32:], state[..., c_in + 32:],
                               rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take(dev):
    state, ops = _layer(dev, 1, 8, 8, 64, 128)
    with pytest.raises(TypeError):
        db.dense_layer(state.float(), 64, ops)
    with pytest.raises(ValueError):
        db.dense_layer(state, 64, ops._replace(w1=ops.w1.cpu()))
    with pytest.raises(ValueError):
        db.dense_layer(state, 48, ops)


@pytest.mark.parametrize("batch,h,w,c_in,c_final", [
    (2, 24, 17, 224, 256),   # ragged, w1 resident
    (1, 9, 130, 64, 96),     # ragged, one pixel past two rows of tiles
    (2, 16, 16, 480, 512),   # w1 streamed, a ragged last 64-channel chunk
    (1, 20, 12, 320, 352),   # the first c_in with w1 streamed
    (1, 16, 16, 288, 320),   # the last c_in with w1 resident; 4 tiles < SMs
    (3, 13, 9, 32, 64),      # one chunk of 32 channels
    (2, 128, 128, 64, 96),   # 512 tiles: more than twice the SMs
    (3, 64, 64, 128, 160),   # 192 tiles: some CTAs take one tile, some two
])
def test_persistent_kernel_matches_plain(dev, batch, h, w, c_in, c_final):
    state, ops = _layer(dev, batch, h, w, c_in, c_final, seed=c_in)
    before = dict(db.dense_layer.variant_launches)
    got = db.dense_layer(state.clone(), c_in, ops, "persistent")
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.variant_launches["persistent"] == before["persistent"] + 1
    assert db.dense_layer.variant_launches["tile"] == before["tile"]
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    err = (part_g - part_w).abs().max() / part_w.abs().max()
    assert err <= REL_TOL, err.item()
    torch.testing.assert_close(got[..., :c_in], state[..., :c_in], rtol=0, atol=0)
    torch.testing.assert_close(got[..., c_in + 32:], state[..., c_in + 32:],
                               rtol=0, atol=0)


def test_persistent_budget_mirror_and_refusal(dev):
    """The launcher's budget equals the Python mirror; past it the launch
    raises and nothing falls back to the tile kernel."""
    import ctypes

    from tennis_torch.ops._build import load_library

    fn = load_library("dense_layer_persistent").dense_layer_persistent_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_longlong
    resident = ctypes.c_int()
    for c_in in (32, 224, 288, 320, 480, 2880, 2912):
        got = (fn(c_in, ctypes.byref(resident)), bool(resident.value))
        assert got == db.persistent_smem_bytes(c_in), c_in
    c_in = 2912
    state, ops = _layer(dev, 1, 3, 3, c_in, c_in + 32)
    before = dict(db.dense_layer.variant_launches)
    with pytest.raises(RuntimeError, match="persistent"):
        db.dense_layer(state, c_in, ops, "persistent")
    assert db.dense_layer.variant_launches == before


def _check_layer(got, state, want, c_in):
    """Growth channels within REL_TOL of the plain version, every other
    channel bit-identical."""
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    assert torch.isfinite(part_g).all()
    err = (part_g - part_w).abs().max() / part_w.abs().max()
    assert err <= REL_TOL, err.item()
    torch.testing.assert_close(got[..., :c_in], state[..., :c_in], rtol=0, atol=0)
    torch.testing.assert_close(got[..., c_in + 32:], state[..., c_in + 32:],
                               rtol=0, atol=0)


@pytest.mark.parametrize("batch,h,w,c_in,c_final,cluster", [
    (8, 32, 32, 256, 1024, None),    # block2 first, the routed size
    (8, 32, 32, 992, 1024, None),    # block2 last
    (8, 16, 16, 512, 1024, None),    # block3 first
    (8, 16, 16, 992, 1024, None),    # block3 last
    (1, 16, 16, 512, 544, None),     # batch 1
    (1, 32, 32, 256, 288, None),
    (2, 16, 16, 1888, 1920, None),   # DenseNet201's last c_in
    (1, 16, 16, 288, 320, 8),        # 9 units over 8 CTAs
    (2, 7, 7, 512, 544, None),       # ragged 7x7 (224^2 input)
    (2, 14, 14, 256, 288, None),     # ragged 14x14
    (2, 32, 32, 256, 288, 2), (2, 32, 32, 256, 288, 4),
    (2, 32, 32, 256, 288, 8),        # every cluster size
    (1, 9, 13, 96, 128, 8),          # 3 units: 5 CTAs add zeros
])
def test_cluster_kernel_matches_plain(dev, batch, h, w, c_in, c_final, cluster):
    state, ops = _layer(dev, batch, h, w, c_in, c_final, seed=c_in + h)
    size = cluster or db.dense_layer_cluster_size(batch, h, w, c_in)
    assert size in db.CLUSTER_SIZES
    before = dict(db.dense_layer.variant_launches)
    got = db.dense_layer(state.clone(), c_in, ops, "cluster", cluster)
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.variant_launches == {
        **before, "cluster": before["cluster"] + 1}
    _check_layer(got, state, want, c_in)


def test_cluster_kernel_is_deterministic(dev):
    """The partials are summed in rank order: two launches agree bit for bit."""
    state, ops = _layer(dev, 8, 16, 16, 992, 1024)
    a = db.dense_layer(state.clone(), 992, ops, "cluster", 8)
    b = db.dense_layer(state.clone(), 992, ops, "cluster", 8)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_cluster_budget_mirror_and_refusals(dev):
    """The launcher's budget equals the Python mirror; a cluster size it
    does not take raises, with no launch and no fallback."""
    import ctypes

    from tennis_torch.ops._build import load_library

    fn = load_library("dense_layer_cluster").dense_layer_cluster_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for cluster in db.CLUSTER_SIZES:
        assert fn(cluster) == db.cluster_smem_bytes(cluster)
    assert fn(1) == fn(3) == fn(16) == -1
    state, ops = _layer(dev, 1, 3, 3, 64, 96)
    for cluster in (1, 3, 16):
        before = dict(db.dense_layer.variant_launches)
        with pytest.raises(RuntimeError, match="cluster"):
            db.dense_layer(state, 64, ops, "cluster", cluster)
        assert db.dense_layer.variant_launches == before


def test_wrapper_dispatches_by_map(dev):
    for side, variant in ((128, "persistent"), (16, "cluster")):
        state, ops = _layer(dev, 1, side, side, 64, 96)
        assert db.dense_layer_variant(1, side, side, 64) == variant
        before = dict(db.dense_layer.variant_launches)
        db.dense_layer(state, 64, ops)
        assert db.dense_layer.variant_launches[variant] == before[variant] + 1


def test_densenet_forward_takes_both_kernels(dev):
    """At 256^2 the first block's 64^2 map goes to the persistent kernel and
    the second block's 32^2 map (batch 1) to the cluster kernel: the forward
    takes exactly the kernels the route names, and agrees with the
    plain-version forward on the same card."""
    gen = torch.Generator().manual_seed(0)
    spec = DenseNetSpec((2, 3), 32, 64)
    model = DenseNet(spec, generator=gen).to(dev).eval()
    model.fold()
    x = torch.randn(1, 256, 256, 3, generator=gen).to(dev)
    routed = dict.fromkeys(db.VARIANTS, 0)
    for side, c_ins in ((64, (64, 96)), (32, (64, 96, 128))):
        for c_in in c_ins:
            routed[db.dense_layer_variant(1, side, side, c_in)] += 1
    assert routed == {"persistent": 2, "tile": 0, "cluster": 3}
    with torch.inference_mode():
        before = dict(db.dense_layer.variant_launches)
        got = model(x).float()
        assert db.dense_layer.variant_launches == {
            v: before[v] + routed.get(v, 0) for v in db.ROUTES}
        want = db.densenet_features(model.spec, model.operands(), x, model.dtype,
                                    layer=db.dense_layer_reference).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 3e-2, err.item()


def test_densenet_forward_through_kernel(dev):
    """A small DenseNet on the card goes through the kernel once per layer
    and agrees with the plain-version forward on the same card."""
    gen = torch.Generator().manual_seed(0)
    model = DenseNet(DenseNetSpec((2, 3), 32, 64), generator=gen).to(dev).eval()
    model.fold()
    x = torch.randn(2, 64, 64, 3, generator=gen).to(dev)
    with torch.inference_mode():
        launches = db.dense_layer.launches
        got = model(x).float()
        assert db.dense_layer.launches == launches + 5
        want = db.densenet_features(model.spec, model.operands(), x, model.dtype,
                                    layer=db.dense_layer_reference).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 3e-2, err.item()


# ---------------------------------------------------------------- GRU kernel

GRU_TOL = 1e-4  # max |kernel - plain|, f32 with another summation order


def _gru_inputs(dev, T, B, H, lengths, seed=0):
    from tennis_torch.ops import gru

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=g)

    return (rand(T, B, 3 * H), rand(B, H, std=0.5), rand(H, 3 * H, std=H ** -0.5),
            rand(3 * H, std=0.1), torch.tensor(lengths, dtype=torch.int32,
                                               device=dev)), gru


@pytest.mark.parametrize("variant", [None, "barrier", "async"])
@pytest.mark.parametrize("T,B,H,lengths", [
    (5, 3, 32, [5, 0, 2]), (128, 4, 256, [128, 100, 37, 1]),
    (1, 1, 256, [1]), (6, 37, 64, [i % 7 for i in range(37)])])
def test_gru_kernel_matches_plain(dev, T, B, H, lengths, variant):
    args, gru = _gru_inputs(dev, T, B, H, lengths)
    launches = gru.gru_recurrence.launches
    by_variant = dict(gru.gru_recurrence.variant_launches)
    ys, h = gru.gru_recurrence(*args, variant=variant)
    ys_ref, h_ref = gru.gru_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert gru.gru_recurrence.launches == launches + 1
    taken = variant or gru.gru_route(T, B, H)
    assert gru.gru_recurrence.variant_launches[taken] == by_variant[taken] + 1
    assert ys.shape == (T, B, H) and h.shape == (B, H)
    torch.testing.assert_close(ys, ys_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=GRU_TOL)
    for b, n in enumerate(lengths):  # carry frozen past valid_length, zeros out
        assert not ys[n:, b].any()
    if 0 in lengths:
        b = lengths.index(0)
        torch.testing.assert_close(h[b], args[1][b], rtol=0, atol=0)


def test_gru_kernel_refusals(dev):
    args, gru = _gru_inputs(dev, 4, 2, 32, [4, 3])
    gx, h0, wh, bh, vl = args
    with pytest.raises(TypeError):
        gru.gru_recurrence(gx.double(), h0, wh, bh, vl)
    big, _ = _gru_inputs(dev, 2, 2, 520, [2, 2])
    assert not gru.gru_fits_smem(2, 2, 520)
    with pytest.raises(ValueError, match="shared-memory budget"):
        gru.gru_recurrence(*big)
    with pytest.raises(RuntimeError, match="forward-only"):
        gru.gru_recurrence(gx.requires_grad_(), h0, wh, bh, vl)


def test_rnn_layer_takes_the_kernel(dev):
    """A bidirectional GRU layer on the card launches the kernel once per
    direction inside the decode context, under inference mode, and agrees
    with the plain version; a gradient inside the context raises."""
    from tennis_torch.ops import gru
    from tennis_torch.ops.rnn import BiRNN, gru_decode

    layer = BiRNN("gru", 24, 32, generator=torch.Generator().manual_seed(0))
    layer = layer.to(dev)
    x = torch.randn(3, 9, 24, generator=torch.Generator().manual_seed(1)).to(dev)
    vl = torch.tensor([9, 4, 1], device=dev)
    with torch.inference_mode(), gru_decode():
        launches = gru.gru_recurrence.launches
        (hf, hb), out = layer(x, vl)
        assert gru.gru_recurrence.launches == launches + 2
    with pytest.raises(RuntimeError, match="forward-only"), gru_decode():
        layer(x, vl)
    cpu = layer.cpu()
    (hf_ref, hb_ref), out_ref = cpu(x.cpu(), vl.cpu())
    torch.testing.assert_close(out.cpu(), out_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(hb.cpu(), hb_ref, rtol=0, atol=GRU_TOL)


def _lengths(T, B, mode):
    """"mixed": 0, 1, T // 2 and T; "short": every row ends before T."""
    if mode == "mixed":
        return [(T, 0, 1, T // 2)[i % 4] for i in range(B)]
    return [(i * 7) % T for i in range(B)] if T > 1 else [0] * B


@pytest.mark.parametrize("mode", ["mixed", "short"])
@pytest.mark.parametrize("T", [1, 128])
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("H", [128, 256, 512])
def test_gru_async_matches_plain(dev, H, B, T, mode):
    """The async kernel within 1e-4 of the plain version, zeros and a frozen
    carry past each length, including batches whose rows all end before T."""
    lengths = _lengths(T, B, mode)
    args, gru = _gru_inputs(dev, T, B, H, lengths, seed=H + B + T)
    before = dict(gru.gru_recurrence.variant_launches)
    ys, h = gru.gru_recurrence(*args, variant="async")
    ys_ref, h_ref = gru.gru_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert gru.gru_recurrence.variant_launches == {
        **before, "async": before["async"] + 1}
    torch.testing.assert_close(ys, ys_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=GRU_TOL)
    for b, n in enumerate(lengths):
        assert not ys[n:, b].any()
        if n == 0:
            torch.testing.assert_close(h[b], args[1][b], rtol=0, atol=0)


@pytest.mark.parametrize("cluster", [8, 16])
def test_gru_async_is_deterministic(dev, cluster):
    """Sums run in a fixed order: two launches agree bit for bit, at either
    cluster size, and the two cluster sizes agree with the plain version."""
    args, gru = _gru_inputs(dev, 128, 4, 256, [128, 100, 37, 1])
    a = gru.gru_recurrence(*args, variant="async", cluster=cluster)
    b = gru.gru_recurrence(*args, variant="async", cluster=cluster)
    ref = gru.gru_recurrence_reference(*args)
    torch.cuda.synchronize()
    for x, y, r in zip(a, b, ref):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, r, rtol=0, atol=GRU_TOL)


def test_gru_plan_mirror_and_refusals(dev):
    """The launcher's shared-memory budget equals gru_plan's, it refuses
    what gru_plan refuses, and the wrapper raises before any launch."""
    import ctypes

    from tennis_torch.ops import gru
    from tennis_torch.ops._build import load_library

    lib = load_library("gru_recurrence_async")
    smem = lib.gru_recurrence_async_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    for H in (8, 32, 64, 128, 256, 368, 400, 480, 512):
        for B in (1, 4, 32):
            for C in gru.ASYNC_CLUSTERS:
                plan = gru.gru_plan(H, B, C)
                if plan is None:
                    continue
                assert smem(H, C, plan.segments, plan.rows) == plan.smem_bytes
    assert gru.gru_plan(512, 4, 8) is None and smem(512, 8, 2, 4) == -1
    assert smem(520, 16, 4, 4) == smem(256, 4, 4, 4) == smem(256, 8, 4, 9) == -1
    args, _ = _gru_inputs(dev, 4, 4, 512, [4, 3, 2, 1])
    before = dict(gru.gru_recurrence.variant_launches)
    with pytest.raises(ValueError, match="budget"):
        gru.gru_recurrence(*args, variant="async", cluster=8)
    with pytest.raises(ValueError, match="budget"):
        gru.gru_recurrence(*args, variant="barrier")
    assert gru.gru_recurrence.variant_launches == before


def test_rnn_layer_h512_takes_the_kernel(dev):
    """A GRU layer of 512 (the 0102 captioner at --num_hidden 512) runs on
    the card through the async kernel."""
    from tennis_torch.ops import gru
    from tennis_torch.ops.rnn import RNNLayer, gru_decode

    layer = RNNLayer("gru", 64, 512, generator=torch.Generator().manual_seed(0))
    layer = layer.to(dev)
    x = torch.randn(4, 20, 64, generator=torch.Generator().manual_seed(1)).to(dev)
    vl = torch.tensor([20, 13, 5, 1], device=dev)
    with torch.inference_mode(), gru_decode():
        before = dict(gru.gru_recurrence.variant_launches)
        h, out = layer(x, vl)
        assert gru.gru_recurrence.variant_launches == {
            **before, "async": before["async"] + 1}
    h_ref, out_ref = layer.cpu()(x.cpu(), vl.cpu())
    torch.testing.assert_close(out.cpu(), out_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h.cpu(), h_ref, rtol=0, atol=GRU_TOL)


def test_densenet161_forward_takes_no_dense_kernel(dev):
    """DenseNet161's widths (bottleneck 192, growth 48) on the card: every
    layer through dense_layer_convs, no dense-kernel launch, and the
    plain-version forward agrees."""
    gen = torch.Generator().manual_seed(0)
    spec = DenseNetSpec((2, 3, 2), 48, 96)
    model = DenseNet(spec, generator=gen).to(dev).eval()
    model.fold()
    x = torch.randn(2, 64, 64, 3, generator=gen).to(dev)
    with torch.inference_mode():
        launches = db.dense_layer.launches
        before = dict(db.dense_layer.variant_launches)
        got = model(x).float()
        assert db.dense_layer.launches == launches
        assert db.dense_layer.variant_launches == {
            **before, "convs": before["convs"] + 7}
        want = db.densenet_features(model.spec, model.operands(), x, model.dtype,
                                    layer=db.dense_layer_reference).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 3e-2, err.item()
    with pytest.raises(ValueError, match="bottleneck"):
        state = torch.zeros(1, 8, 8, 192, dtype=torch.bfloat16, device=dev)
        db.dense_layer(state, 96, model.operands()["layers"][0][0], "cluster")


# ------------------------------------------------- feature dump and prefetch

LOGIT_TOL = 5e-2  # max |kernel path - plain| / max |plain| after 58 layers


class _Split:
    """An in-memory split with what save_features reads of a TennisSet."""

    def __init__(self, frames, feat_dir):
        self.frames, self.feat_dir, self._split = frames, feat_dir, "mem"

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx], 0, idx

    def save_feature_path(self, idx):
        from tennis_torch.data.tennis_set import get_feature_path

        return get_feature_path(self.feat_dir, "mem", idx)


def test_save_features_matches_plain(dev, tmp_path):
    """DenseNet121 at 512^2 over 64 + 5 frames (a full and a ragged batch):
    every file f32 (4096,), within LOGIT_TOL of the plain-version features,
    58 dense launches a batch."""
    import numpy as np

    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import build_frame_model, \
        make_extract_features

    model = build_frame_model("DenseNet121", 11, 512,
                              generator=torch.Generator().manual_seed(0))
    frames = np.random.default_rng(0).integers(0, 256, (69, 512, 512, 3),
                                               dtype=np.uint8)
    ds = _Split(frames, str(tmp_path))
    extract = make_extract_features(model, dev)
    launches = db.dense_layer.launches
    report = driver.save_features(extract, [ds], {
        "mem": DataLoader(ds, 64, num_workers=4)}, dev)
    assert db.dense_layer.launches == launches + 2 * 58
    assert report["mem"]["files"] == 69
    got = np.stack([np.load(ds.save_feature_path(i)) for i in range(69)])
    assert got.dtype == np.float32 and got.shape == (69, 4096)
    bb = model.backbone
    for lo, hi in ((0, 64), (64, 69)):
        with torch.inference_mode():
            x = device_prepare(torch.from_numpy(frames[lo:hi]).to(dev))
            want = db.densenet_features(bb.spec, bb.operands(), x, bb.dtype,
                                        layer=db.dense_layer_reference)
        want = want.float().cpu().numpy()
        err = np.abs(got[lo:hi] - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, err


def test_prefetch_pinned_batches_stay_intact(dev):
    """20 batches through the pinned ring and the copy stream while the
    consumer's stream is kept busy: each batch's bytes arrive intact, though
    the consumer drops each tensor while its kernels may still read it."""
    import numpy as np

    from tennis_torch.data.loader import prefetch_to_device

    batches = [(np.full((8, 256, 256, 3), i, np.uint8), np.arange(8) + i,
                np.arange(8)) for i in range(20)]
    busy = torch.randn(2048, 2048, device=dev)
    sums, stats = [], {}
    for k, (x, labels, _) in enumerate(prefetch_to_device(
            iter(batches), dev, stats=stats)):
        assert x.device.type == "cuda" and x.dtype == torch.uint8
        for _ in range(4):  # device work ahead of the read
            busy = (busy @ busy).tanh_()
        sums.append(x.sum(dtype=torch.int64))
        assert labels[0] == k  # host side, unmoved
    want = [8 * 256 * 256 * 3 * i for i in range(20)]
    assert [int(s) for s in sums] == want
    assert stats["batches"] == 20


def test_prefetch_moves_every_input(dev):
    """A captioner batch through the pinned ring with ``moved=4`` (features,
    caption ids, float32 valid lengths of each) while the consumer's stream
    is kept busy: every array arrives intact on the card, the indices stay
    on the host."""
    import numpy as np

    from tennis_torch.data.loader import prefetch_to_device

    batches = [(np.full((32, 512, 64), i, np.float32),
                np.full((32, 56), i, np.int32),
                np.full(32, 512 + i, np.float32), np.full(32, 50 + i, np.float32),
                np.arange(32) + i) for i in range(12)]
    busy = torch.randn(2048, 2048, device=dev)
    got = []
    for k, (src, tgt, src_vl, tgt_vl, idxs) in enumerate(prefetch_to_device(
            iter(batches), dev, moved=4)):
        for _ in range(4):  # device work ahead of the read
            busy = (busy @ busy).tanh_()
        assert all(t.device.type == "cuda" for t in (src, tgt, src_vl, tgt_vl))
        assert isinstance(idxs, np.ndarray) and idxs[0] == k
        got.append(torch.stack([src.sum(dtype=torch.float64),
                                tgt.sum(dtype=torch.float64),
                                src_vl.sum(dtype=torch.float64),
                                tgt_vl.sum(dtype=torch.float64)]))
    want = [[32 * 512 * 64 * i, 32 * 56 * i, 32 * (512 + i), 32 * (50 + i)]
            for i in range(12)]
    assert torch.stack(got).cpu().tolist() == want


# ------------------------------------------------------------------ training


def test_train_step_on_the_card_matches_its_cpu_run(dev):
    """Three f32 train steps of a small DenseNet at 64^2, batch 4, from the
    same weights and batches on the card and on the CPU (TF32 off): the
    losses within 1e-4; the parameters and the BN statistics within 1e-3 in
    relative L2, the momentum (the sum of raw gradients) within 5e-2: cuDNN
    picks its f32 convolution algorithms by the memory free, and after the
    rest of this file it took ones whose gradients differ by ~1% (momentum
    1.2e-2, parameters 2.4e-4 seen; 7e-6 and 3e-7 when run alone). The BN
    scales and biases are drawn away from (1, 0), where the gradient of a
    BN that the next BN normalizes is a cancellation. The card's step
    launches no dense-layer kernel."""
    import numpy as np

    from tennis_torch.bridge import state_to_flax
    from tennis_torch.models import FrameModel
    from tennis_torch.parallel import train_step as ts

    spec = DenseNetSpec((2, 2, 2, 2))
    runs = {}
    for device in ("cpu", dev):
        model = FrameModel(DenseNet(spec, dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(0)),
                           5, dtype=torch.float32,
                           feature_dim=spec.final_channels,
                           generator=torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".bn" in name and name.endswith("weight"):
                    p.uniform_(0.5, 1.5, generator=g)
                elif ".bn" in name:
                    p.normal_(0.0, 0.2, generator=g)
        tx, _ = ts.sgd_with_schedule(0.05, 0.9, 1e-4, (1, 2), 0.75, 2)
        state = ts.create_train_state(model.to(device), tx)
        step = ts.make_train_step(state)
        rng = np.random.default_rng(2)
        launches = db.dense_layer.launches
        losses = []
        for _ in range(3):
            x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(
                np.float32)).to(device)
            losses.append(step(x, rng.integers(0, 5, 4))[0].item())
        assert db.dense_layer.launches == launches
        runs[str(device)] = (losses, state_to_flax(state))
    (l_cpu, t_cpu), (l_dev, t_dev) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(l_dev, l_cpu, rtol=0, atol=1e-4)

    def leaves(tree):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k])
            else:
                yield np.ravel(tree[k])

    for part in ("params", "batch_stats", "opt_state"):
        got = np.concatenate(list(leaves(t_dev[part])))
        want = np.concatenate(list(leaves(t_cpu[part])))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= (5e-2 if part == "opt_state" else 1e-3), (part, rel)


def test_apply_augment_on_the_card_matches_its_cpu_run(dev):
    """The same draws on a card batch and a CPU batch: f32 within 4e-6 (the
    card sums the luma mean in another order; 1.2e-6 seen), bf16 within one
    bf16 step of the largest value."""
    import numpy as np

    from tennis_torch.data import transforms as T

    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 64, 48, 3), dtype=np.uint8))
    draws = T.augment_draws(8, torch.Generator().manual_seed(4))
    on_dev = T.AugmentDraws(*(d.to(dev) for d in draws))
    for dtype, tol in ((torch.float32, 4e-6), (torch.bfloat16, 2 ** -6)):
        got = T.apply_augment(images.to(dev), on_dev, dtype).float().cpu()
        want = T.apply_augment(images, draws, dtype).float()
        assert (got - want).abs().max().item() <= tol
    g = torch.Generator(device=dev).manual_seed(5)
    d = T.augment_draws(16, g)
    assert all(t.device.type == "cuda" for t in d)


def test_checkpoint_codec_round_trip_on_the_card(dev, tmp_path):
    """A train state on the card written through the port's codec and read
    back: the same bytes again, every leaf as it was on the card."""
    import numpy as np

    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.models import FrameModel
    from tennis_torch.parallel import train_step as ts
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec

    spec = DenseNetSpec((1, 1))

    def state():
        model = FrameModel(DenseNet(spec, generator=torch.Generator()
                                    .manual_seed(0)), 5,
                           feature_dim=spec.final_channels,
                           generator=torch.Generator().manual_seed(1))
        tx, _ = ts.sgd_with_schedule(0.01)
        return ts.create_train_state(model.to(dev), tx)

    first = state()
    ts.make_train_step(first)(torch.rand(2, 32, 32, 3, device=dev), [0, 1])
    path = str(tmp_path / "0000.params")
    ckpt.save_state(path, state_to_flax(first))
    second = state()
    state_from_flax(second, ckpt.load_raw(path))
    assert msgpack_codec.serialize(state_to_flax(second)) == \
        open(path, "rb").read()
    for (n, a), (_, b) in zip(first.model.state_dict().items(),
                              second.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, t in first.opt_state.trace.items():
        assert torch.equal(t, second.opt_state.trace[n]), n
    assert np.asarray(ckpt.load_raw(path)["step"]) == 1


def _captioner(dev, dropout=0.0):
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder

    g = torch.Generator().manual_seed(0)
    enc, dec = get_gnmt_encoder_decoder(hidden_size=32, input_size=24,
                                        embed_size=8, generator=g,
                                        dropout=dropout)
    return NMTModel(20, enc, dec, embed_size=8, hidden_size=32,
                    generator=g).to(dev)


def _caption_batch(dev):
    g = torch.Generator().manual_seed(1)
    src = torch.randn(4, 16, 24, generator=g)
    tgt = torch.randint(0, 20, (4, 8), generator=g, dtype=torch.int32)
    return (src.to(dev), tgt.to(dev), torch.tensor([16., 9., 3., 1.], device=dev),
            torch.tensor([8., 5., 3., 2.], device=dev))


def test_captioner_train_step_launches_no_gru_kernel(dev):
    """One Adam step of a small captioner on the card: no GRU kernel launch
    (training runs the differentiable recurrence, as the JAX package trains
    through its scan), and the loss and gradients of the CPU's step."""
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.ops import gru
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step

    runs = []
    for device in (dev, torch.device("cpu")):
        state = create_seq2seq_state(_captioner(device, dropout=0.0),
                                     adam_with_clip(5.0), 1e-3)
        step = make_seq2seq_train_step(state, masked_ce_loss)
        launches = gru.gru_recurrence.launches
        loss = step(*_caption_batch(device), 7)
        assert gru.gru_recurrence.launches == launches
        runs.append((loss.item(), torch.cat(
            [m.cpu().flatten() for m in state.opt_state.inner.mu.values()])))
    (loss_c, mu_c), (loss_h, mu_h) = runs
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    # Adam's first moment is 0.1 of the clipped gradient (the update itself
    # turns rounding noise in near-zero gradients into sign flips)
    assert ((mu_c - mu_h).norm() / mu_h.norm()).item() <= 1e-4


def test_captioner_decode_context_takes_the_kernel(dev):
    """The translator's encode launches the GRU kernel 3 times (bi layer
    forward and backward, then layer 1); outside the context the encoder
    launches none and agrees with it; a gradient inside the context
    raises."""
    from tennis_torch.ops import gru
    from tennis_torch.ops.rnn import gru_decode
    from tennis_torch.translation import BeamSearchTranslator

    model = _captioner(dev).eval()
    src, _, src_vl, _ = _caption_batch(dev)
    translator = BeamSearchTranslator(model, 2, 3, max_length=6)
    launches = gru.gru_recurrence.launches
    translator.translate(src, src_vl)
    assert gru.gru_recurrence.launches == launches + 3
    with torch.inference_mode():
        with gru_decode():
            mem_k, _ = model.encode(src, src_vl)
        assert gru.gru_recurrence.launches == launches + 6
        mem_p, _ = model.encode(src, src_vl)
        assert gru.gru_recurrence.launches == launches + 6
    torch.testing.assert_close(mem_k, mem_p, rtol=0, atol=GRU_TOL)
    with pytest.raises(RuntimeError, match="forward-only"), gru_decode():
        model.encode(src, src_vl)
    assert gru.gru_recurrence.launches == launches + 6
