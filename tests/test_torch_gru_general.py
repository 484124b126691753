"""The general GRU kernel's domain, partition and slice on the CPU.

``csrc/gru_recurrence_general.cu`` takes every hidden size from 1 to 1023,
the union of the JAX kernel's domain (``gru_fits_vmem`` never holds at
H >= 1024). ``general_plan`` mirrors its partition: min(16, H) CTAs owning
ragged runs of units, each product thread's rows split between registers,
shared memory and the streamed ring. A numpy emulation of the kernel's
indexing (its shared-memory layouts, ring slots and ragged sends) over that
partition agrees with the Pallas kernel in interpret mode; the plain version
agrees with it at the new widths; a captioner at a ragged width decodes as
the JAX translator does, and its exported ``--pallas_gru`` program names the
new kernel in its op nodes.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import VIDEO_EVENTS, build_fixture
from tennis_tpu.ops.pallas.gru import gru_fits_vmem, gru_recurrence_pallas
from tennis_torch.ops import gru

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tennis_torch", "csrc")
ATOL = 1e-5  # tests/test_torch_gru.py's _close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


def source_constants(name):
    with open(os.path.join(CSRC, name)) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}


def _plan_exists(variant, H, B):
    return {"async": gru.gru_plan, "general": gru.general_plan,
            "grid": gru.grid_plan}[variant](H, B) is not None


@pytest.mark.parametrize("T,B", [(1, 1), (1, 4), (30, 64), (128, 4), (128, 8),
                                 (128, 32), (512, 4)])
def test_every_shape_the_jax_kernel_takes_has_a_card_kernel(T, B):
    """Wherever the JAX package runs its kernel, the decode route names a
    kernel whose plan exists (no launch would raise); H 1024 takes the
    plain recurrence, as the JAX package takes its scan."""
    covered = 0
    for H in range(1, 1024):
        if not gru_fits_vmem(T, B, H):
            continue
        covered += 1
        variant = gru.gru_decode_route(T, B, H)
        assert variant in ("async", "general", "grid"), (H, variant)
        assert _plan_exists(variant, H, B), H
        assert gru.gru_fits_smem(T, B, H)
    assert covered > 0
    assert not gru_fits_vmem(T, B, 1024)
    assert gru.gru_decode_route(T, B, 1024) == "plain"
    assert gru.general_plan(1024, B) is None and gru.general_plan(0, B) is None


def test_route_keeps_the_async_kernel_where_it_takes_the_shape():
    """The 0102 width and every H the async kernel takes keep it (measured
    fastest there); every other H up to 1023 goes to the grid kernel where
    the general one would stream Wh and the grid plan holds it, else to the
    general kernel."""
    assert gru.gru_route(128, 4, 256) == "async"
    for B in (1, 4, 32):
        for H in range(1, 1024):
            if gru.gru_plan(H, B) is not None:
                want = "async"
            elif gru.general_plan(H, B).stream_rows > 0 \
                    and gru.grid_plan(H, B) is not None:
                want = "grid"
            else:
                want = "general"
            assert gru.gru_route(128, B, H) == want


@pytest.mark.parametrize("H", [1, 5, 16, 37, 100, 185, 300, 504, 640, 737,
                               1020, 1023])
@pytest.mark.parametrize("B", [1, 4, 9, 32])
def test_plan_mirrors_the_source(H, B):
    """The plan with the source's constants: every unit owned by one CTA
    in runs of floor(H / C) or ceil(H / C); each CTA's slice of Wh summed
    once, its registers, shared memory and streamed rows adding up to
    3 U H weights; the shared memory within 227 KiB."""
    k = source_constants("gru_recurrence_general.cu")
    assert (gru.GENERAL_MAX_HIDDEN, gru.GENERAL_MAX_CLUSTER,
            gru.GENERAL_MAX_THREADS, gru.GENERAL_MAX_ROWS, gru.REG_ROWS,
            gru.CHUNK_ROWS, gru.RING_SLOTS, gru.SMEM_LIMIT, gru.STATIC_SMEM) \
        == (k["kMaxH"], k["kMaxCluster"], k["kMaxThreads"], k["kMaxRows"],
            k["kRegL"], k["kChunkRows"], k["kRingSlots"], k["kSmemLimit"],
            k["kStaticSmem"])
    plan = gru.general_plan(H, B)
    C, UM, S, R, L = (plan.cluster, plan.units, plan.segments, plan.rows,
                      plan.seg_rows)
    assert C == min(16, H) and UM == -(-H // C)
    assert R & (R - 1) == 0 and R <= k["kMaxRows"] and R * UM <= k["kMaxThreads"]
    # as many rows as the batch needs, unless twice R would overflow the
    # threads
    assert R >= min(B, k["kMaxRows"]) or 2 * R * UM > k["kMaxThreads"]
    assert UM * S <= plan.threads <= k["kMaxThreads"] and plan.threads % 32 == 0
    assert L % k["kChunkRows"] == 0 and L >= k["kRegL"] and S * L >= H
    assert plan.reg_rows + plan.smem_rows + plan.stream_rows == L
    assert plan.smem_rows % k["kChunkRows"] == 0
    assert plan.smem_bytes <= k["kSmemLimit"] - k["kStaticSmem"]
    runs, parts = gru.general_partition(H, plan)
    owner = np.zeros(H, np.int64)
    for rank, first, units in runs:
        assert units in (H // C, -(-H // C))
        owner[first:first + units] += 1
    np.testing.assert_array_equal(owner, 1)
    for rank, first, units in runs:
        mine = [p for p in parts if p[0] == rank]
        assert {(u, s) for _, u, s, *_ in mine} == {
            (u, s) for u in range(units) for s in range(S)}
        rows = np.zeros((units, H), np.int64)
        for _, u, s, k0, n_reg, n_smem, n_stream in mine:
            rows[u, k0:k0 + n_reg + n_smem + n_stream] += 1
        np.testing.assert_array_equal(rows, 1)  # each (row, unit) once
        # registers + shared memory + stream = the slice's 3 U H weights
        assert 3 * sum(sum(p[4:]) for p in mine) == 3 * units * H
    if H >= 640:  # past what registers and shared memory hold: streamed
        assert plan.stream_rows > 0
    if H <= 504:
        assert plan.stream_rows == 0


def emulate(gx, h0, wh, bh, vl, plan, layout):
    """The general kernel's arithmetic in numpy f32, through its own
    indexing: Wh read through ``layout``'s strides into each thread's
    registers, the resident float4 groups and the two ring slots (filled
    one chunk ahead, across steps), h in the padded double buffer, the
    partials by (segment, row, gate, unit), the sends of each CTA's run."""
    T, B, _ = gx.shape
    H = h0.shape[1]
    C, UM, S, R, L, LR, LT = (plan.cluster, plan.units, plan.segments,
                              plan.rows, plan.seg_rows, plan.smem_rows,
                              plan.stream_rows)
    KR, Q = plan.reg_rows, gru.CHUNK_ROWS
    NP, HP, J = UM * S, S * L, 3 * UM
    if layout == "row":  # (H, 3H) contiguous
        flat, sk, sj = wh.reshape(-1), 3 * H, 1
    else:  # a transposed (3H, H) weight, as RNNLayer passes it
        flat, sk, sj = np.ascontiguousarray(wh.T).reshape(-1), 1, H
    base, extra = divmod(H, C)
    tid = np.arange(NP)
    u, s = tid % UM, tid // UM
    ys = np.full((T, B, H), np.nan, np.float32)
    h_final = np.full((B, H), np.nan, np.float32)

    def weights(U, start, k):  # (3, NP): rows k of each thread's columns
        ok = (u < U) & (k < H)
        out = np.zeros((3, NP), np.float32)
        for g in range(3):
            idx = (g * H + start + np.minimum(u, U - 1)) * sj + k * sk
            out[g, ok] = flat[idx[ok]]
        return out

    for row0 in range(0, B, R):
        nb = min(R, B - row0)
        ctas = []
        for rank in range(C):
            U, start = base + (rank < extra), rank * base + min(rank, extra)
            hbuf = np.zeros((2, R, HP), np.float32)
            hbuf[0, :nb, :H] = h0[row0:row0 + nb]
            ctas.append({
                "U": U, "start": start, "hbuf": hbuf,
                "reg": np.stack([weights(U, start, s * L + i)
                                 for i in range(KR)]),
                "res": np.stack([weights(U, start, s * L + KR + i)
                                 for i in range(LR)]).reshape(-1, 4, 3, NP)
                if LR else None,
                "ring": np.full((2, Q, 3, NP), np.nan, np.float32),
                "pending": [], "used": 0,
                "h": h0[row0:row0 + nb, start:start + U].copy()})

        def issue(cta, slot, c):
            k0 = s * L + KR + LR + c * Q
            cta["pending"].append((slot, np.stack(
                [weights(cta["U"], cta["start"], k0 + q) for q in range(Q)])))

        def land(cta, keep):
            while len(cta["pending"]) > keep:
                slot, w = cta["pending"].pop(0)
                cta["ring"][slot] = w

        n_chunks = LT // Q
        for cta in ctas:
            if n_chunks:
                issue(cta, 0, 0)
        t_end = max(min(max(int(vl[row0 + b]), 0), T) for b in range(nb))
        for t in range(t_end):
            staged = []
            for cta in ctas:
                hs = np.stack([cta["hbuf"][t & 1][:, s * L + i]
                               for i in range(L)])  # (L, R, NP)
                acc = np.zeros((3, R, NP), np.float32)
                for i in range(KR):
                    acc += cta["reg"][i][:, None] * hs[i][None]
                for i in range(LR):
                    acc += cta["res"][i // 4, i % 4][:, None] * hs[KR + i][None]
                for c in range(n_chunks):
                    issue(cta, (cta["used"] + 1) & 1,
                          0 if c + 1 == n_chunks else c + 1)
                    land(cta, 1)
                    ring = cta["ring"][cta["used"] & 1]
                    assert not np.isnan(ring).any()
                    for q in range(Q):
                        acc += ring[q][:, None] * hs[KR + LR + c * Q + q][None]
                    cta["used"] += 1
                red = np.zeros((S, R, J), np.float32)
                for g in range(3):
                    red[s, :, g * UM + u] = acc[g].T
                U, start = cta["U"], cta["start"]
                gh = np.zeros((nb, 3 * U), np.float32)
                for q in range(S):  # the segments in order
                    gh += np.concatenate([red[q, :nb, g * UM:g * UM + U]
                                          for g in range(3)], axis=1)
                units = np.arange(start, start + U)
                gh += np.concatenate([bh[g * H + units] for g in range(3)])
                x = gx[t, row0:row0 + nb]
                r = 1 / (1 + np.exp(-(x[:, units] + gh[:, :U])))
                z = 1 / (1 + np.exp(-(x[:, H + units] + gh[:, U:2 * U])))
                n = np.tanh(x[:, 2 * H + units] + r * gh[:, 2 * U:])
                new = ((1 - z) * n + z * cta["h"]).astype(np.float32)
                alive = (t < vl[row0:row0 + nb])[:, None]
                cta["h"] = np.where(alive, new, cta["h"])
                ys[t][row0:row0 + nb, units] = np.where(alive, new, 0)
                staged.append(cta["h"])
            if t + 1 < t_end:  # each CTA's run into every CTA's next buffer
                for cta in ctas:
                    for src, h in zip(ctas, staged):
                        cta["hbuf"][(t + 1) & 1, :nb,
                                    src["start"]:src["start"] + src["U"]] = h
        for cta in ctas:
            cols = slice(cta["start"], cta["start"] + cta["U"])
            h_final[row0:row0 + nb, cols] = cta["h"]
            ys[t_end:, row0:row0 + nb, cols] = 0
    return ys, h_final


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(B, H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32))


def _lengths(T, B):
    """Valid lengths mixing 0, 1, a middle value and T."""
    return np.asarray([(T, 0, 1, T // 2)[i % 4] for i in range(B)], np.int32)


@pytest.mark.parametrize("H,B,stream,layout", [
    (5, 3, None, "row"), (37, 9, None, "col"), (100, 5, None, "row"),
    (100, 3, (0, 8), "col"), (100, 3, (0, 8), "row"), (640, 2, None, "col")])
def test_kernel_indexing_emulated_matches_pallas(H, B, stream, layout):
    """The emulation at the kernel's partition agrees with the Pallas
    kernel; ``stream`` forces (shared-memory rows, streamed rows) at a
    small H so that the ring runs over several steps."""
    T = 3
    gx, h0, wh, bh = _inputs(T, B, H, seed=H + B)
    vl = _lengths(T, B)
    plan = gru.general_plan(H, B)
    if stream is not None:
        plan = plan._replace(smem_rows=stream[0], stream_rows=stream[1])
    ys_j, h_j = gru_recurrence_pallas(*map(jnp.asarray, (gx, h0, wh, bh, vl)),
                                      interpret=True)
    ys_e, h_e = emulate(gx, h0, wh, bh, vl, plan, layout)
    _close(ys_e, ys_j)
    _close(h_e, h_j)


@pytest.mark.parametrize("H", [5, 100, 300, 504, 640, 737])
@pytest.mark.parametrize("B", [1, 3, 9])
def test_plain_version_matches_pallas_at_the_new_widths(H, B):
    """The kernel's oracle, and the CPU path of every variant, against the
    Pallas kernel at widths only the general kernel takes on the card."""
    T = 4 if H > 500 else 6
    gx, h0, wh, bh = _inputs(T, B, H, seed=7 * H + B)
    vl = _lengths(T, B)
    ys_j, h_j = gru_recurrence_pallas(*map(jnp.asarray, (gx, h0, wh, bh, vl)),
                                      interpret=True)
    args = [torch.from_numpy(a) for a in (gx, h0, wh, bh, vl)]
    streams = gru.general_plan(H, B).stream_rows > 0
    assert gru.gru_route(T, B, H) == ("grid" if streams else "general")
    for ys, h in (gru.gru_recurrence_reference(*args),
                  gru.gru_recurrence(*args, variant="general"),
                  gru.gru_recurrence(*args, variant="grid")):
        _close(ys, ys_j)
        _close(h, h_j)
    for b, n in enumerate(vl):
        assert not np.asarray(ys_j)[n:, b].any()


def test_translator_at_a_ragged_width_matches_jax():
    """A captioner of H 20 (taken by no kernel before the general one)
    decodes the JAX translator's beams through ``gru_decode()``: three
    recurrences a batch through the kernel's op, each routed to the
    general kernel, none to the plain recurrence."""
    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
    from tennis_tpu.translation import BeamSearchTranslator as JaxTranslator
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder
    from tennis_torch.ops import rnn
    from tennis_torch.translation import BeamSearchTranslator

    Vv, E, H, C, B, T = 12, 8, 20, 10, 3, 6
    enc, dec = jax_enc_dec(hidden_size=H)
    jmodel = JaxNMT(vocab_size=Vv, encoder=enc, decoder=dec, embed_size=E)
    rng = np.random.default_rng(20)
    src = rng.normal(size=(B, T, C)).astype(np.float32)
    vl = np.asarray([6, 3, 1], np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(src),
                                     jnp.zeros((B, 2), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray,
                                  {"params": dict(variables["params"])})
    penc, pdec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                          embed_size=E)
    model = load_flax(NMTModel(Vv, penc, pdec, embed_size=E, hidden_size=H),
                      tree).eval()
    kw = dict(bos_id=2, eos_id=3, beam_size=4, alpha=1.0, K=5, max_length=8)
    want = JaxTranslator(jmodel, **kw).translate(tree, src, vl)
    variants, real = [], rnn.gru_recurrence

    def spy(gx, *args, **kw):
        variants.append(gru.gru_route(*gx.shape[:2], gx.shape[2] // 3))
        return real(gx, *args, **kw)

    plain = gru.gru_recurrence.plain_routed
    rnn.gru_recurrence = spy
    try:
        got = BeamSearchTranslator(model, **kw).translate(src, vl)
    finally:
        rnn.gru_recurrence = real
    assert variants == ["general"] * 3
    assert gru.gru_recurrence.plain_routed == plain
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-5)


def test_exported_captioner_at_a_ragged_width_names_the_general_kernel(
        tmp_path, monkeypatch):
    """``export_captioner(..., gru_kernel=True)`` (``--pallas_gru``) of a
    captioner at H 20: three ``tennis_torch.gru_recurrence`` nodes, each
    naming the general kernel, and the live translator's top beams."""
    from tennis_torch import export
    from tennis_torch.bridge import to_flax
    from tennis_torch.data.tennis_set import CaptionIndex, get_feature_path
    from tennis_torch.inference import load_captioner
    from tennis_torch.train_gnmt import build_model, parse_args
    from tennis_torch.utils import checkpoint as ckpt

    root = build_fixture(str(tmp_path / "ds"))
    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = get_feature_path(os.path.join(root, "features", "tf"),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.normal(size=(16,)).astype(np.float32))
    argv = ["--feats_model=tf", "--num_hidden=20", "--emb_size=8",
            "--tgt_max_len=6", "--emb_file="]
    monkeypatch.chdir(tmp_path)
    vocab = CaptionIndex(root, split="train", max_cap_len=6,
                         feats_model="tf").vocab
    model = build_model(parse_args(argv), len(vocab), 16,
                        generator=torch.Generator().manual_seed(3))
    exp = os.path.join("models", "captioning", "experiments", "g20")
    os.makedirs(exp)
    tree = to_flax(model)
    ckpt.save_state(os.path.join(exp, "valid_best.params"),
                    {"params": tree["params"],
                     "batch_stats": tree.get("batch_stats", {})})
    program, meta = export.export_captioner(
        "g20", 2, src_max_len=8, root=root, gnmt_argv=argv, gru_kernel=True,
        device="cpu")
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "tennis_torch.gru_recurrence" in str(n.target)]
    assert [n.args[5] for n in nodes] == ["general"] * 3
    out = str(tmp_path / "g20.pt2")
    export.save_exported(out, program, meta)
    _, caption, _ = export.load_exported_captioner(out)
    _, live, _ = load_captioner("g20", root=root, gnmt_argv=argv,
                                src_max_len=8, device="cpu")
    feats = rng.normal(size=(2, 8, 16)).astype(np.float32)
    lengths = np.asarray([8, 3], np.int32)
    assert caption(feats, lengths) == [list(c) for c in live(feats, lengths)]
