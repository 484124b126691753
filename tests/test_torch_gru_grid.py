"""The grid GRU kernel's plan, partition and slice on the CPU.

``csrc/gru_recurrence_grid.cu`` holds Wh whole over several clusters of 16
CTAs where the general kernel would stream part of it every step, and
exchanges the hidden state between the CTAs through a double-buffered h in
device memory. ``grid_plan`` mirrors its partition; a numpy emulation of the
kernel's layouts (its register and shared-memory weights, the padded h
buffer, the partials, the exchanged h and its rows per chunk) over that
partition agrees with the Pallas kernel in interpret mode at H 640, 737 and
1020; a captioner at H 640 decodes as the JAX translator does through three
recurrences routed to the grid kernel, and its exported ``--pallas_gru``
program names the grid kernel in its op nodes.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import VIDEO_EVENTS, build_fixture
from jax.experimental import pallas as pl

from tennis_tpu.ops.pallas.gru import (_recurrence_kernel, gru_fits_vmem,
                                       gru_recurrence_pallas)
from tennis_torch.ops import gru
from test_torch_gru_general import _close, _inputs, _lengths, source_constants


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_constants_mirror_the_source():
    k = source_constants("gru_recurrence_grid.cu")
    assert (gru.GENERAL_MAX_HIDDEN, gru.GRID_CLUSTER, gru.GRID_MAX_CTAS,
            gru.GENERAL_MAX_THREADS, gru.GENERAL_MAX_ROWS, gru.REG_ROWS,
            gru.ROW_ALIGN, gru.COUNTER_STRIDE, gru.SMEM_LIMIT) \
        == (k["kMaxH"], k["kCluster"], k["kMaxCtas"], k["kMaxThreads"],
            k["kMaxRows"], k["kRegL"], k["kRowAlign"], k["kCounterStride"],
            k["kSmemLimit"])


@pytest.mark.parametrize("H", [560, 640, 700, 737, 800, 900, 1000, 1020, 1023])
@pytest.mark.parametrize("B", [1, 4, 8, 9, 32])
def test_plan_holds_wh_whole(H, B):
    """The plan with the source's constants: every unit owned by one CTA in
    runs of floor(H / G) or ceil(H / G); each CTA's slice of Wh resident
    once, registers and shared memory adding up to 3 U H weights and
    nothing streamed; the shared memory within 227 KiB; every chunk's grid
    within the CTAs the card holds at once; the fewest clusters that hold
    the slice. Where there is no plan, it is the resident-CTA cap that
    refuses it."""
    plan = gru.grid_plan(H, B)
    if plan is None:
        fewer = gru.grid_plan(H, 8 if B > 8 else B)
        assert fewer is not None and fewer.ctas * -(-B // fewer.rows) \
            > gru.GRID_MAX_CTAS
        return
    G, UM, S, R, L = (plan.ctas, plan.units, plan.segments, plan.rows,
                      plan.seg_rows)
    assert G == plan.clusters * plan.cluster and plan.cluster == 16
    assert UM == -(-H // G) and G <= H
    assert plan.chunks == -(-B // R) and G * plan.chunks <= gru.GRID_MAX_CTAS
    assert R & (R - 1) == 0 and R <= 8 and R * UM <= 256
    assert R >= min(B, 8) or 2 * R * UM > 256
    assert UM * S <= plan.threads <= 256 and plan.threads % 32 == 0
    assert L % gru.ROW_ALIGN == 0 and L >= gru.REG_ROWS and S * L >= H
    assert plan.reg_rows + plan.smem_rows == L
    assert plan.smem_bytes <= gru.SMEM_LIMIT
    assert plan.workspace_words == gru.COUNTER_STRIDE * plan.chunks \
        + 2 * B * (-(-H // 4) * 4)
    if plan.clusters > 1:  # one cluster fewer would not hold the slice
        G1 = G - 16
        UM1 = gru._ceil(H, G1)
        S1 = max(1, min(256 // UM1, H // 32))
        L1 = max(32, gru._ceil(gru._ceil(H, S1), 4) * 4)
        R1 = min(1 << (min(B, 8) - 1).bit_length(),
                 1 << ((256 // UM1).bit_length() - 1))
        assert gru._grid_smem_floats(H, G1, S1, L1, R1) * 4 > gru.SMEM_LIMIT
    runs, parts = gru.grid_partition(H, plan)
    owner = np.zeros(H, np.int64)
    for rank, first, units in runs:
        assert units in (H // G, -(-H // G))
        owner[first:first + units] += 1
    np.testing.assert_array_equal(owner, 1)
    for rank, first, units in runs:
        mine = [p for p in parts if p[0] == rank]
        assert {(u, s) for _, u, s, *_ in mine} == {
            (u, s) for u in range(units) for s in range(S)}
        rows = np.zeros((units, H), np.int64)
        for _, u, s, k0, n_reg, n_smem in mine:
            rows[u, k0:k0 + n_reg + n_smem] += 1
        np.testing.assert_array_equal(rows, 1)  # each (row, unit) once
        assert sum(p[4] + p[5] for p in mine) == units * H


@pytest.mark.parametrize("B", [1, 4, 8, 32])
def test_route_names_grid_exactly_where_the_general_kernel_streams(B):
    """Over every H up to 1023: grid where the general plan streams and the
    grid plan exists (never where the async kernel takes H); the general
    kernel's streamed shapes without a grid plan keep it."""
    for H in range(1, 1024):
        general = gru.general_plan(H, B)
        streams = general.stream_rows > 0
        route = gru.gru_route(128, B, H)
        if gru.gru_plan(H, B) is not None:
            assert route == "async" and not streams
        elif streams and gru.grid_plan(H, B) is not None:
            assert route == "grid"
        else:
            assert route == "general"
    assert gru.gru_route(128, 4, 640) == "grid"
    assert gru.gru_route(128, 4, 737) == "grid"
    assert gru.gru_route(1, 4, 1020) == "grid"
    assert gru.gru_route(128, 4, 300) == "general"


def emulate(gx, h0, wh, bh, vl, plan, layout):
    """The grid kernel's arithmetic in numpy f32, through its own indexing:
    Wh read through ``layout``'s strides into each thread's registers and
    the flat resident float4 groups, h in the padded shared buffer, the
    partials by (segment, row, gate, unit), the exchanged h in the flat
    double buffer [2][B][HX] of the workspace (rows of every chunk), copied
    back as float4 groups at the start of each step."""
    T, B, _ = gx.shape
    H = h0.shape[1]
    G, UM, S, R, L = (plan.ctas, plan.units, plan.segments, plan.rows,
                      plan.seg_rows)
    KR, LR = plan.reg_rows, plan.smem_rows
    NP, HP, J, HX = UM * S, S * L, 3 * UM, -(-H // 4) * 4
    if layout == "row":  # (H, 3H) contiguous
        flat, sk, sj = wh.reshape(-1), 3 * H, 1
    else:  # a transposed (3H, H) weight, as RNNLayer passes it
        flat, sk, sj = np.ascontiguousarray(wh.T).reshape(-1), 1, H
    base, extra = divmod(H, G)
    tid = np.arange(NP)
    u, s = tid % UM, tid // UM
    words = plan.workspace_words - gru.COUNTER_STRIDE * plan.chunks
    assert words == 2 * B * HX
    hx = np.zeros(words, np.float32)
    ys = np.full((T, B, H), np.nan, np.float32)
    h_final = np.full((B, H), np.nan, np.float32)

    def weights(U, start, k):  # (3, NP): row k of each thread's columns
        ok = (u < U) & (k < H)
        out = np.zeros((3, NP), np.float32)
        for g in range(3):
            idx = (g * H + start + np.minimum(u, U - 1)) * sj + k * sk
            out[g, ok] = flat[idx[ok]]
        return out

    for chunk in range(plan.chunks):
        row0 = chunk * R
        nb = min(R, B - row0)
        ctas = []
        for rank in range(G):
            U, start = base + (rank < extra), rank * base + min(rank, extra)
            hbuf = np.zeros(R * HP, np.float32)
            for b in range(nb):
                hbuf[b * HP:b * HP + H] = h0[row0 + b]
            wres = np.full(3 * LR * NP, np.nan, np.float32)
            for i in range(LR):
                w = weights(U, start, s * L + KR + i)
                for g in range(3):
                    wres[(((i >> 2) * 3 + g) * NP + tid) * 4 + (i & 3)] = w[g]
            ctas.append({"U": U, "start": start, "hbuf": hbuf, "wres": wres,
                         "reg": [weights(U, start, s * L + i)
                                 for i in range(KR)],
                         "h": h0[row0:row0 + nb, start:start + U].copy()})
        t_end = max(min(max(int(vl[row0 + b]), 0), T) for b in range(nb))
        for t in range(t_end):
            send = t + 1 < t_end
            for cta in ctas:
                hbuf = cta["hbuf"]
                if t > 0:  # every CTA of the chunk has stored h(t)
                    for b in range(nb):
                        src = ((t & 1) * B + row0 + b) * HX
                        hbuf[b * HP:b * HP + HX] = hx[src:src + HX]
                acc = np.zeros((3, R, NP), np.float32)
                for i in range(KR):
                    hk = np.stack([hbuf[b * HP + s * L + i] for b in range(R)])
                    acc += cta["reg"][i][:, None] * hk[None]
                for i in range(0, LR, 4):
                    q = (i >> 2) * 3 * NP + tid  # float4 index of g = 0
                    for e in range(4):
                        w = np.stack([cta["wres"][(q + g * NP) * 4 + e]
                                      for g in range(3)])
                        hk = np.stack([hbuf[b * HP + s * L + KR + i + e]
                                       for b in range(R)])
                        acc += w[:, None] * hk[None]
                red = np.full(S * R * J, np.nan, np.float32)
                for b in range(R):
                    for g in range(3):
                        red[(s * R + b) * J + g * UM + u] = acc[g, b]
                U, start = cta["U"], cta["start"]
                gh = np.zeros((nb, 3, U), np.float32)
                for q in range(S):  # the segments in order
                    for g in range(3):
                        for b in range(nb):
                            p = (q * R + b) * J + g * UM
                            gh[b, g] += red[p:p + U]
                units = np.arange(start, start + U)
                for g in range(3):
                    gh[:, g] += bh[g * H + units]
                x = gx[t, row0:row0 + nb]
                r = 1 / (1 + np.exp(-(x[:, units] + gh[:, 0])))
                z = 1 / (1 + np.exp(-(x[:, H + units] + gh[:, 1])))
                n = np.tanh(x[:, 2 * H + units] + r * gh[:, 2])
                new = ((1 - z) * n + z * cta["h"]).astype(np.float32)
                alive = (t < vl[row0:row0 + nb])[:, None]
                cta["h"] = np.where(alive, new, cta["h"])
                ys[t][row0:row0 + nb, units] = np.where(alive, new, 0)
                if send:
                    for b in range(nb):
                        dst = (((t + 1) & 1) * B + row0 + b) * HX
                        hx[dst + start:dst + start + U] = cta["h"][b]
        for cta in ctas:
            cols = slice(cta["start"], cta["start"] + cta["U"])
            h_final[row0:row0 + nb, cols] = cta["h"]
            ys[t_end:, row0:row0 + nb, cols] = 0
    assert not hx.reshape(2, B, HX)[:, :, H:].any()  # zeros past H
    return ys, h_final


@functools.lru_cache(maxsize=None)
def _pallas(T, B, H):
    """Seeded inputs and the Pallas kernel's answer in interpret mode; where
    its 12 MiB budget refuses (H 1020 past T 1 or B 4, where the JAX package
    takes its scan), the same kernel through its own ``pallas_call``."""
    gx, h0, wh, bh = _inputs(T, B, H, seed=H + B)
    vl = _lengths(T, B)
    args = tuple(map(jnp.asarray, (gx, h0, wh, bh, vl)))
    if gru_fits_vmem(T, B, H):
        ys, h = gru_recurrence_pallas(*args, interpret=True)
    else:
        ys, h = pl.pallas_call(
            _recurrence_kernel,
            out_shape=(jax.ShapeDtypeStruct((T, B, H), jnp.float32),
                       jax.ShapeDtypeStruct((B, H), jnp.float32)),
            interpret=True)(*args)
    return (gx, h0, wh, bh, vl), np.asarray(ys), np.asarray(h)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("B", [1, 4, 9])
@pytest.mark.parametrize("H", [640, 737, 1020])
def test_kernel_indexing_emulated_matches_pallas(H, B, layout):
    """The emulation at the kernel's partition agrees with the Pallas kernel
    at 1e-5. H 1020 at B 9 has no plan (two chunks of 64 CTAs are more than
    the card holds at once): its emulation takes B 8's grid over two chunks,
    the same indexing the launch would run."""
    T = 3
    (gx, h0, wh, bh, vl), ys_j, h_j = _pallas(T, B, H)
    plan = gru.grid_plan(H, B)
    if plan is None:
        assert (H, B) == (1020, 9)
        plan = gru.grid_plan(H, 8)
        plan = plan._replace(chunks=2, workspace_words=2 * gru.COUNTER_STRIDE
                             + 2 * B * (-(-H // 4) * 4))
    ys_e, h_e = emulate(gx, h0, wh, bh, vl, plan, layout)
    _close(ys_e, ys_j)
    _close(h_e, h_j)
    for b, n in enumerate(vl):
        assert not ys_e[n:, b].any()


def test_translator_at_h640_matches_jax():
    """A captioner at --num_hidden 640 (where the general kernel streams Wh)
    decodes the JAX translator's beams through ``gru_decode()``: three
    recurrences a batch through the kernel's op, each routed to the grid
    kernel, none to the plain recurrence."""
    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
    from tennis_tpu.translation import BeamSearchTranslator as JaxTranslator
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder
    from tennis_torch.ops import rnn
    from tennis_torch.translation import BeamSearchTranslator

    Vv, E, H, C, B, T = 12, 8, 640, 10, 3, 6
    assert gru_fits_vmem(T, B, H)
    enc, dec = jax_enc_dec(hidden_size=H)
    jmodel = JaxNMT(vocab_size=Vv, encoder=enc, decoder=dec, embed_size=E)
    rng = np.random.default_rng(640)
    src = rng.normal(size=(B, T, C)).astype(np.float32)
    vl = np.asarray([6, 3, 1], np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(6), jnp.asarray(src),
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
    assert variants == ["grid"] * 3
    assert gru.gru_recurrence.plain_routed == plain
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-5)


def test_exported_captioner_at_h640_names_the_grid_kernel(tmp_path,
                                                         monkeypatch):
    """``export_captioner(..., gru_kernel=True)`` (``--pallas_gru``) of a
    captioner at --num_hidden 640: three ``tennis_torch.gru_recurrence``
    nodes, each naming the grid kernel, and the live translator's top
    beams."""
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
    argv = ["--feats_model=tf", "--num_hidden=640", "--emb_size=8",
            "--tgt_max_len=6", "--emb_file="]
    monkeypatch.chdir(tmp_path)
    vocab = CaptionIndex(root, split="train", max_cap_len=6,
                         feats_model="tf").vocab
    model = build_model(parse_args(argv), len(vocab), 16,
                        generator=torch.Generator().manual_seed(3))
    exp = os.path.join("models", "captioning", "experiments", "g640")
    os.makedirs(exp)
    tree = to_flax(model)
    ckpt.save_state(os.path.join(exp, "valid_best.params"),
                    {"params": tree["params"],
                     "batch_stats": tree.get("batch_stats", {})})
    program, meta = export.export_captioner(
        "g640", 2, src_max_len=8, root=root, gnmt_argv=argv, gru_kernel=True,
        device="cpu")
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "tennis_torch.gru_recurrence" in str(n.target)]
    assert [n.args[5] for n in nodes] == ["grid"] * 3
    out = str(tmp_path / "g640.pt2")
    export.save_exported(out, program, meta)
    _, caption, _ = export.load_exported_captioner(out)
    _, live, _ = load_captioner("g640", root=root, gnmt_argv=argv,
                                src_max_len=8, device="cpu")
    feats = rng.normal(size=(2, 8, 16)).astype(np.float32)
    lengths = np.asarray([8, 3], np.int32)
    assert caption(feats, lengths) == [list(c) for c in live(feats, lengths)]
