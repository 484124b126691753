"""The port on a CUDA card: the three dense-layer kernels (tile, persistent
and cluster) against their plain version at small and ragged shapes, the
wrapper's refusals and choice of kernel, DenseNet forwards through the
kernels (DenseNet161's widths through ``dense_layer_convs``), the four GRU
kernels, the paths around them (FlowNet-S through cuDNN; ``predict``
over in-memory frames) and the ``torch.export`` programs that carry both
kernels as custom ops. Marked ``cuda``; each test skips without a card. On a
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
    with pytest.raises(TypeError):  # a bf16 kernel takes no f32 state
        db.dense_layer(state.float(), 64, ops, "tile")
    with pytest.raises(ValueError):  # the f32 kernel takes no bf16 kernels
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
    big, _ = _gru_inputs(dev, 2, 2, 1024, [2, 2])
    assert not gru.gru_fits_smem(2, 2, 1024)
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


# (T, B, H, lengths): the widths only the general kernel takes at the
# /caption lengths (chip_smoke.py's new GRU_CASES), H below 16 (a cluster of
# H CTAs), one unit, B past 8 (more clusters, a ragged last chunk of rows),
# lengths of 0, and the widest H
GENERAL_CASES = [
    (128, 4, 300, [21, 30, 104, 69]), (128, 4, 504, [21, 30, 104, 69]),
    (128, 4, 640, [21, 30, 104, 69]), (128, 4, 737, [21, 30, 104, 69]),
    (128, 32, 185, [21, 30, 104, 69] * 8), (1, 4, 1020, [1, 1, 1, 1]),
    (5, 3, 5, [5, 0, 2]), (7, 11, 13, [i % 8 for i in range(11)]),
    (3, 2, 1, [3, 0]), (6, 37, 100, [i % 7 for i in range(37)]),
    (16, 9, 1023, [16, 0, 3, 16, 9, 1, 16, 2, 5]), (4, 4, 17, [0, 0, 0, 0])]


@pytest.mark.parametrize("layout", ["row_major", "transposed"])
@pytest.mark.parametrize("T,B,H,lengths", GENERAL_CASES)
def test_gru_general_matches_plain(dev, T, B, H, lengths, layout):
    """The general kernel within 1e-4 of the plain version, two launches
    bit for bit, zeros and a frozen carry past each length, with Wh
    row-major and as the transposed (3H, H) weight RNNLayer passes."""
    args, gru = _gru_inputs(dev, T, B, H, lengths, seed=H + B + T)
    if layout == "transposed":
        args = (args[0], args[1], args[2].t().contiguous().t(), *args[3:])
    before = dict(gru.gru_recurrence.variant_launches)
    ys, h = gru.gru_recurrence(*args, variant="general")
    ys2, h2 = gru.gru_recurrence(*args, variant="general")
    ys_ref, h_ref = gru.gru_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert gru.gru_recurrence.variant_launches == {
        **before, "general": before["general"] + 2}
    assert torch.equal(ys, ys2) and torch.equal(h, h2)
    torch.testing.assert_close(ys, ys_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=GRU_TOL)
    for b, n in enumerate(lengths):
        assert not ys[n:, b].any()
        if n == 0:
            torch.testing.assert_close(h[b], args[1][b], rtol=0, atol=0)


def test_gru_general_plan_mirror_and_refusals(dev):
    """The launcher's shared-memory budget equals general_plan's at every
    H it takes, it refuses H 1024 and a cluster other than min(16, H), and
    the wrapper raises before any launch."""
    import ctypes

    from tennis_torch.ops import gru
    from tennis_torch.ops._build import load_library

    smem = load_library("gru_recurrence_general").gru_recurrence_general_smem_bytes
    smem.argtypes = [ctypes.c_int] * 6
    smem.restype = ctypes.c_longlong
    for H in [*range(1, 1024, 11), 1023]:
        for B in (1, 4, 9, 32):
            p = gru.general_plan(H, B)
            assert smem(H, p.cluster, p.segments, p.seg_rows, p.rows,
                        p.smem_rows) == p.smem_bytes
    p = gru.general_plan(640, 4)
    assert smem(1024, 16, 4, 256, 4, 40) == -1
    assert smem(640, 8, p.segments, p.seg_rows, p.rows, p.smem_rows) == -1
    assert smem(640, 16, p.segments, p.seg_rows, 3, p.smem_rows) == -1
    assert smem(640, 16, p.segments, p.seg_rows, p.rows, 4) == -1
    args, _ = _gru_inputs(dev, 4, 4, 1024, [4, 3, 2, 1])
    small, _ = _gru_inputs(dev, 4, 4, 300, [4, 3, 2, 1])
    before = dict(gru.gru_recurrence.variant_launches)
    with pytest.raises(ValueError, match="budget"):
        gru.gru_recurrence(*args, variant="general")
    with pytest.raises(ValueError, match="clusters of 16"):
        gru.gru_recurrence(*small, variant="general", cluster=8)
    assert gru.gru_recurrence.variant_launches == before


# (T, B, H, lengths): the shapes where the general kernel streams Wh and the
# grid kernel holds it (chip_smoke.py's wide_h640, edge_h737, t1_h1020), one
# row (one cluster of 16), a full chunk of 8 rows, two chunks, three
# clusters, the widest H, lengths of 0
GRID_CASES = [
    (128, 4, 640, [21, 30, 104, 69]), (128, 4, 737, [21, 30, 104, 69]),
    (1, 4, 1020, [1, 1, 1, 1]), (20, 1, 640, [20]),
    (12, 8, 700, [12, 0, 5, 12, 1, 2, 3, 11]),
    (16, 9, 1000, [16, 0, 3, 16, 9, 1, 16, 2, 5]), (7, 3, 900, [7, 2, 0]),
    (5, 2, 1023, [0, 0])]


@pytest.mark.parametrize("layout", ["row_major", "transposed"])
@pytest.mark.parametrize("T,B,H,lengths", GRID_CASES)
def test_gru_grid_matches_plain(dev, T, B, H, lengths, layout):
    """The grid kernel, routed at each case, within 1e-4 of the plain
    version, two launches bit for bit, zeros and a frozen carry past each
    length, with Wh row-major and as the transposed (3H, H) weight RNNLayer
    passes."""
    args, gru = _gru_inputs(dev, T, B, H, lengths, seed=H + B + T)
    if layout == "transposed":
        args = (args[0], args[1], args[2].t().contiguous().t(), *args[3:])
    assert gru.gru_route(T, B, H) == "grid"
    before = dict(gru.gru_recurrence.variant_launches)
    ys, h = gru.gru_recurrence(*args)
    ys2, h2 = gru.gru_recurrence(*args, variant="grid")
    ys_ref, h_ref = gru.gru_recurrence_reference(*args)
    torch.cuda.synchronize()
    assert gru.gru_recurrence.variant_launches == {
        **before, "grid": before["grid"] + 2}
    assert torch.equal(ys, ys2) and torch.equal(h, h2)
    torch.testing.assert_close(ys, ys_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=GRU_TOL)
    for b, n in enumerate(lengths):
        assert not ys[n:, b].any()
        if n == 0:
            torch.testing.assert_close(h[b], args[1][b], rtol=0, atol=0)


def test_gru_grid_on_two_streams(dev):
    """Two grid launches queued on two streams at once, each with its own
    workspace, both right."""
    lengths = [21, 30, 104, 69]
    runs = [_gru_inputs(dev, 128, 4, H, lengths, seed=H)[0] for H in (640, 737)]
    from tennis_torch.ops import gru

    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    outs = []
    for stream, args in zip(streams, runs):
        with torch.cuda.stream(stream):
            outs.append(gru.gru_recurrence(*args, variant="grid"))
    torch.cuda.synchronize()
    for args, (ys, h) in zip(runs, outs):
        ys_ref, h_ref = gru.gru_recurrence_reference(*args)
        torch.testing.assert_close(ys, ys_ref, rtol=0, atol=GRU_TOL)
        torch.testing.assert_close(h, h_ref, rtol=0, atol=GRU_TOL)


def test_gru_grid_plan_mirror_and_refusals(dev):
    """The launcher's shared-memory budget equals grid_plan's; every plan's
    CTAs fit the clusters the card holds at once (so the route never names
    a grid the launch refuses); a partition off the source's rules is
    refused; a shape without a plan raises before any launch, and a grid
    past the resident CTAs returns an error from the launcher without
    launching (the card stays usable)."""
    import ctypes

    from tennis_torch.ops import gru
    from tennis_torch.ops._build import load_library

    lib = load_library("gru_recurrence_grid")
    smem = lib.gru_recurrence_grid_smem_bytes
    smem.argtypes = [ctypes.c_int] * 6
    smem.restype = ctypes.c_longlong
    resident = lib.gru_recurrence_grid_resident_clusters
    resident.argtypes = [ctypes.c_int, ctypes.c_longlong]
    resident.restype = ctypes.c_int
    for H in [*range(16, 1024, 13), 1023]:
        for B in (1, 4, 8, 9, 32):
            p = gru.grid_plan(H, B)
            if p is None:
                continue
            assert smem(H, p.ctas, p.segments, p.seg_rows, p.rows, B) \
                == p.smem_bytes
            assert resident(p.rows, p.smem_bytes) * p.cluster \
                >= p.ctas * p.chunks
    p = gru.grid_plan(640, 4)
    assert smem(640, 24, p.segments, p.seg_rows, p.rows, 4) == -1
    assert smem(640, p.ctas, p.segments, p.seg_rows, 3, 4) == -1
    assert smem(640, p.ctas, p.segments, p.seg_rows - 2, p.rows, 4) == -1
    assert smem(640, p.ctas, p.segments, p.seg_rows, p.rows, 32) == -1
    args, _ = _gru_inputs(dev, 4, 32, 640, [4] * 32)
    before = dict(gru.gru_recurrence.variant_launches)
    assert gru.grid_plan(640, 32) is None
    with pytest.raises(ValueError, match="no grid holds"):
        gru.gru_recurrence(*args, variant="grid")
    small, _ = _gru_inputs(dev, 4, 4, 640, [4, 3, 2, 1])
    with pytest.raises(ValueError, match="clusters of 16"):
        gru.gru_recurrence(*small, variant="grid", cluster=8)
    assert gru.gru_recurrence.variant_launches == before
    gx, h0, wh, bh, vl = args
    out = torch.empty((32, 4, 640), device=dev).transpose(0, 1)
    hf = torch.empty((32, 640), device=dev)
    workspace = torch.zeros(gru.COUNTER_STRIDE * 4 + 2 * 32 * 640,
                            dtype=torch.int32, device=dev)
    err = gru._launcher("grid")(
        gx.data_ptr(), gx.stride(0), gx.stride(1), h0.data_ptr(), wh.data_ptr(),
        wh.stride(0), wh.stride(1), bh.data_ptr(), vl.data_ptr(),
        out.data_ptr(), out.stride(0), out.stride(1), hf.data_ptr(), 4, 32,
        640, p.ctas, p.segments, p.seg_rows, 8, workspace.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0
    ys, _ = gru.gru_recurrence(*small, variant="grid")
    torch.testing.assert_close(ys, gru.gru_recurrence_reference(*small)[0],
                               rtol=0, atol=GRU_TOL)


def test_rnn_layer_ragged_width_takes_the_general_kernel(dev):
    """A GRU layer of 300 (the 0102 captioner at --num_hidden 300) runs on
    the card through the general kernel inside the decode context."""
    from tennis_torch.ops import gru
    from tennis_torch.ops.rnn import RNNLayer, gru_decode

    layer = RNNLayer("gru", 64, 300, generator=torch.Generator().manual_seed(0))
    layer = layer.to(dev)
    x = torch.randn(4, 20, 64, generator=torch.Generator().manual_seed(1)).to(dev)
    vl = torch.tensor([20, 13, 5, 1], device=dev)
    with torch.inference_mode(), gru_decode():
        before = dict(gru.gru_recurrence.variant_launches)
        h, out = layer(x, vl)
        assert gru.gru_recurrence.variant_launches == {
            **before, "general": before["general"] + 1}
    h_ref, out_ref = layer.cpu()(x.cpu(), vl.cpu())
    torch.testing.assert_close(out.cpu(), out_ref, rtol=0, atol=GRU_TOL)
    torch.testing.assert_close(h.cpu(), h_ref, rtol=0, atol=GRU_TOL)


def test_rnn_layer_h640_takes_the_grid_kernel(dev):
    """A GRU layer of 640 (the 0102 captioner at --num_hidden 640, its
    transposed Wh) runs on the card through the grid kernel inside the
    decode context."""
    from tennis_torch.ops import gru
    from tennis_torch.ops.rnn import RNNLayer, gru_decode

    layer = RNNLayer("gru", 64, 640, generator=torch.Generator().manual_seed(0))
    layer = layer.to(dev)
    x = torch.randn(4, 20, 64, generator=torch.Generator().manual_seed(1)).to(dev)
    vl = torch.tensor([20, 13, 5, 1], device=dev)
    with torch.inference_mode(), gru_decode():
        before = dict(gru.gru_recurrence.variant_launches)
        h, out = layer(x, vl)
        assert gru.gru_recurrence.variant_launches == {
            **before, "grid": before["grid"] + 1}
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


# ------------------------------------------- temporal and two-stream models


def _temporal_model(flow=None, clips=False, seed=0):
    """A small model of the new families: two-stream (``twos``/``only``),
    sixc, or a CNN-RNN over clips (DenseNet121 streams) or features."""
    from tennis_torch.models import CNNRNN, FrameModel, TwoStreamModel, \
        get_backbone

    gen = torch.Generator().manual_seed(seed)

    def net(c=3):
        return get_backbone("DenseNet121", in_channels=c, generator=gen)

    if flow in ("twos", "only"):
        return TwoStreamModel(None if flow == "only" else net(), net(), 11,
                              feature_dim=1024, generator=gen)
    if flow == "sixc":
        return FrameModel(net(6), 11, feature_dim=1024, generator=gen)
    base = FrameModel(net()) if clips else None
    return CNNRNN(base, 11, feature_dim=1024, generator=gen)


@pytest.mark.parametrize("flow,clips,shape,launches", [
    ("twos", False, (2, 64, 64, 6), 116),
    ("only", False, (2, 64, 64, 6), 58),
    ("sixc", False, (2, 64, 64, 6), 58),
    (None, True, (1, 3, 64, 64, 3), 58)])
def test_temporal_and_two_stream_eval_through_the_kernels(dev, flow, clips,
                                                          shape, launches):
    """One evaluation forward of each new model through ``make_eval_step``
    on the card: every dense layer of every stream in a routed kernel (the
    clip CNN-RNN's B*T frames in one forward), no GRU kernel, the logits
    within 5e-2 of the plain-version forward on the same card."""
    from tennis_torch.inference import make_eval_step, prepare_input
    from tennis_torch.ops import gru

    model = _temporal_model(flow, clips)
    step = make_eval_step(model, dev)
    x = torch.randint(0, 256, shape, dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    before = dict(db.dense_layer.variant_launches)
    gru_before = gru.gru_recurrence.launches
    got = step(x)
    torch.cuda.synchronize()
    by_route = {v: n - before[v] for v, n in
                db.dense_layer.variant_launches.items()}
    assert sum(by_route[v] for v in db.VARIANTS) == launches, by_route
    assert by_route["convs"] == 0
    assert gru.gru_recurrence.launches == gru_before
    with torch.inference_mode(), db.plain_dense_layers(model):
        want = model(prepare_input(x, model.dtype))
    assert db.dense_layer.variant_launches == {
        v: before[v] + by_route[v] for v in db.ROUTES}
    err = (got - want).abs().max() / want.abs().max()
    assert got.shape == (shape[0], 11) and err <= 5e-2, err.item()


def test_feature_cnnrnn_eval_on_the_card_matches_the_cpu(dev):
    """The features CNN-RNN (bf16 bi-GRU, no kernel of its own): the
    card's logits within 2e-2 of max |logit| of the CPU's, no dense and no
    GRU kernel launched."""
    from tennis_torch.inference import make_eval_step
    from tennis_torch.ops import gru

    x = torch.randn(4, 30, 1024, generator=torch.Generator().manual_seed(2))
    want = make_eval_step(_temporal_model(), torch.device("cpu"))(x)
    launches = (db.dense_layer.launches, gru.gru_recurrence.launches)
    got = make_eval_step(_temporal_model(), dev)(x).cpu()
    assert (db.dense_layer.launches, gru.gru_recurrence.launches) == launches
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("backbone,shape", [
    ("resnet18_v2", (4, 64, 64, 3)), ("resnet50_v2", (2, 64, 64, 3)),
    ("resnet18_v2", (4, 64, 64, 6)), ("rdnet", (2, 8, 64, 64, 3))])
def test_resnet_and_r21d_forwards_on_the_card_match_the_cpu(dev, backbone,
                                                            shape):
    """ResNet-v2 (3 and 6 channels) and R(2+1)D-34 through cuDNN, no
    kernel of their own: eval logits in f32 (TF32 off) within 1e-4 and in
    bf16 within 2e-2 of max |logit| of the CPU's; a train-mode step's
    gradients in f64 within 1e-6 (global relative L2; at these sizes the
    f32 gradients of ResNet-50 and R(2+1)D lie 2-5% off f64 on either
    device, ``tests/test_torch_resnet.py``); no dense-layer or GRU kernel
    launched."""
    from tennis_torch import train
    from tennis_torch.inference import make_eval_step
    from tennis_torch.ops import gru

    argv = [f"--backbone={backbone}", f"--data_shape={shape[-2]}"]
    if backbone == "rdnet":
        argv.append("--window=8")
    if shape[-1] == 6:
        argv.append("--flow=sixc")
    args = train.parse_args(argv)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    labels = torch.arange(shape[0]) % 11
    launches = (db.dense_layer.launches, gru.gru_recurrence.launches)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        cpu = train.build_model(args, 11, dtype=dtype)
        card = train.build_model(args, 11, dtype=dtype)
        card.load_state_dict(cpu.state_dict())
        want = make_eval_step(cpu, torch.device("cpu"))(x)
        got = make_eval_step(card, dev)(x).cpu()
        assert (got - want).abs().max() <= tol * want.abs().max(), dtype
    runs = []
    for device in (torch.device("cpu"), dev):
        model = train.build_model(args, 11, dtype=torch.float64)
        model.load_state_dict(cpu.state_dict())
        model.to(device, torch.float64)
        loss = torch.nn.functional.cross_entropy(
            model(x.to(device, torch.float64), train=True),
            labels.to(device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append(torch.cat([g.flatten().cpu() for g in grads]))
    assert (runs[1] - runs[0]).norm() <= 1e-6 * runs[0].norm()
    assert (db.dense_layer.launches, gru.gru_recurrence.launches) == launches


def test_flownet_on_the_card_matches_the_cpu(dev):
    """FlowNet-S through cuDNN (no kernel of its own): the five-scale
    pyramid in f32 (TF32 off) within 1e-4 of max |flow| of the CPU's, and
    ``FlowRunner.flow_batch`` in bf16 (uint8 upload, normalisation on the
    card) within 3e-2 of the CPU's f32 flow; no dense-layer or GRU kernel
    launched."""
    import numpy as np

    from tennis_torch.bridge import to_flax
    from tennis_torch.models.flownet import FlowNetS
    from tennis_torch.models.flownet_run import FlowRunner, normalise_pairs
    from tennis_torch.ops import gru

    gen = torch.Generator().manual_seed(4)
    cpu = FlowNetS(dtype=torch.float32, generator=gen)
    card = FlowNetS(dtype=torch.float32).to(dev)
    card.load_state_dict(cpu.state_dict())
    pairs = np.random.default_rng(5).integers(0, 256, (2, 2, 128, 192, 3),
                                              dtype=np.uint8)
    x = normalise_pairs(torch.from_numpy(pairs))
    launches = (db.dense_layer.launches, gru.gru_recurrence.launches)
    with torch.inference_mode():
        want = cpu(x, train=True)
        got = card(x.to(dev), train=True)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()
    runner = FlowRunner(params=to_flax(cpu)["params"], device="cuda")
    flow = torch.from_numpy(runner.flow_batch(pairs))
    assert flow.shape == want[0].shape
    assert (flow - want[0]).abs().max() <= 3e-2 * want[0].abs().max()
    assert (db.dense_layer.launches, gru.gru_recurrence.launches) == launches


def test_predict_in_memory_frames_on_the_card_match_the_cpu(dev, tmp_path,
                                                            monkeypatch):
    """``predict.predict`` past the decoder on the card: 20 frames of 96x160
    at ``--every 2 --batch_size 4 --data_shape 64`` (3 batches, the last
    edge-padded) through the dense-layer kernels, 58 launches a batch,
    probabilities within 1e-2 of the same run on the CPU and the same
    ``frames.txt``."""
    import numpy as np

    from tennis_torch import predict
    from tennis_torch.bridge import to_flax
    from tennis_torch.inference import build_frame_model
    from tennis_torch.utils import checkpoint as ckpt

    monkeypatch.chdir(tmp_path)
    model = build_frame_model("DenseNet121", 11, 64,
                              generator=torch.Generator().manual_seed(6))
    exp = tmp_path / "models" / "vision" / "experiments" / "p1"
    ckpt.save_state(ckpt.epoch_path(str(exp), 0), to_flax(model))
    frames = np.random.default_rng(7).integers(0, 256, (20, 96, 160, 3),
                                               dtype=np.uint8)
    runs = {}
    for device in ("cpu", "cuda"):
        args = predict.parse_args([
            "--model_id=p1", "--data_shape=64", "--batch_size=4", "--every=2",
            f"--out_dir={device}", f"--device={device}", "--root=none"])
        launches = db.dense_layer.launches
        runs[device] = predict.predict(
            args, predict.sample_frames(iter(frames), args.every))
        runs[device + "_launches"] = db.dense_layer.launches - launches
    assert runs["cuda_launches"] == 58 * 3 and runs["cpu_launches"] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-2)
    np.testing.assert_array_equal(runs["cuda"][1], np.arange(0, 20, 2))
    assert (tmp_path / "cuda" / "frames.txt").read_text() == \
        (tmp_path / "cpu" / "frames.txt").read_text()


# ------------------------------------------------------------------ export


def test_exported_classifier_launches_the_routed_kernels(dev, tmp_path,
                                                         monkeypatch):
    """``export_classifier`` on the card at batch 2 (DenseNet121 at 64^2):
    58 ``tennis_torch.dense_layer`` nodes naming the route's kernels, the
    loaded program 58 launches split as the route names them, and the live
    scorer's probabilities within 1e-5."""
    import numpy as np

    from tennis_torch import export
    from tennis_torch.bridge import to_flax
    from tennis_torch.inference import build_frame_model, load_classifier
    from tennis_torch.utils import checkpoint as ckpt

    monkeypatch.chdir(tmp_path)
    model = build_frame_model("DenseNet121", 11, 64,
                              generator=torch.Generator().manual_seed(8))
    exp = tmp_path / "models" / "vision" / "experiments" / "x1"
    ckpt.save_state(ckpt.epoch_path(str(exp), 0), to_flax(model))
    program, meta = export.export_classifier("DenseNet121", "x1", 64, 2,
                                             root="none")
    assert meta["platforms"] == ["cuda"]
    routed = dict.fromkeys(db.ROUTES, 0)
    side, channels = 16, 64
    for num_layers in (6, 12, 24, 16):
        for j in range(num_layers):
            routed[db.dense_layer_variant(2, side, side, channels + 32 * j)] += 1
        channels, side = (channels + 32 * num_layers) // 2, side // 2
    nodes = [n for n in program.graph.nodes
             if str(n.target).startswith("tennis_torch.dense_layer")]
    assert len(nodes) == 58
    assert {v: sum(n.args[-2] == v for n in nodes) for v in routed} == routed
    export.save_exported(str(tmp_path / "x1.pt2"), program, meta)
    _, predict, _ = export.load_exported(str(tmp_path / "x1.pt2"))
    _, live, _ = load_classifier("DenseNet121", "x1", 64, root="none")
    frames = np.random.default_rng(9).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    want = live(frames)
    before = dict(db.dense_layer.variant_launches)
    got = predict(frames)
    launched = {v: db.dense_layer.variant_launches[v] - before[v]
                for v in routed}
    assert launched == routed
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_exported_decoder_with_the_gru_op_launches_the_kernel(dev):
    """The translator's ``build_decoder(gru_kernel=True)`` exported on the
    card: three ``tennis_torch.gru_recurrence`` nodes, three GRU-kernel
    launches a run of the program, and the live translator's samples."""
    from tennis_torch import export
    from tennis_torch.ops import gru
    from tennis_torch.translation import BeamSearchTranslator

    model = _captioner(dev).eval()
    src, _, src_vl, _ = _caption_batch(dev)
    src_vl = src_vl.to(torch.int32)
    translator = BeamSearchTranslator(model, 2, 3, max_length=6)
    decode = translator.build_decoder(src.shape[0], gru_kernel=True)
    program = export._export(decode, (src, src_vl), state=model)
    assert len([n for n in program.graph.nodes if str(n.target).startswith(
        "tennis_torch.gru_recurrence")]) == 3
    want = translator.translate_tensors(src, src_vl)
    launches = gru.gru_recurrence.launches
    with torch.no_grad():
        got = program.module()(src, src_vl)
    assert gru.gru_recurrence.launches == launches + 3
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
