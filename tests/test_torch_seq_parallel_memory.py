"""The sequence-sharded attention memory on four gloo ranks on the CPU: the
counterpart of ``tests/test_parallel.py::
test_seq2seq_sequence_parallel_memory_matches`` at meshes 2 x 2 and 1 x 4,
over sources of T 8 and of T 7 (padded with masked steps to the model
axis, as GSPMD pads), ragged lengths 8/7/5/3 (7/7/5/3 at T 7), so that a
row's mask crosses the blocks and row 3 has blocks with no unmasked step.

Four processes are spawned once for the module (``_rank_main``); each lays
out the meshes in turn, builds the captioner with ``mem_sharding`` (its
model world), takes its data index's rows and runs two teacher-forced
Adam steps (``make_seq2seq_train_step``) and a beam decode through
``BeamSearchTranslator(world=)``; it also takes the loss's gradients over
its rows, which equal the unsharded ones within 1e-5 of each leaf's
largest magnitude. The losses are held within rtol 2e-4 of
the JAX sequence-parallel step (``NMTModel(mem_sharding=NamedSharding(
mesh, P("data", "model", None)))``) and of the port's unsharded one; the
beam samples and lengths equal the JAX ``BeamSearchTranslator(mesh=)``'s,
the scores within rtol 1e-4. The sharded softmax is also held alone against
``masked_softmax`` with a block that is masked whole.
"""
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from tennis_torch.bridge import load_flax
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss
from tennis_torch.ops.attention import masked_softmax, \
    sharded_masked_softmax
from tennis_torch.parallel import distributed as D
from tennis_torch.parallel import train_step as ts
from tennis_torch.parallel.mesh import shard_rows
from tennis_torch.translation import BeamSearchTranslator

WORLD = 4
MESHES = ((2, 2), (1, 4))
SOURCES = (8, 7)  # T; lengths 8/7/5/3 clipped to T
V, E, H, C, B, L = 12, 6, 8, 6, 4, 7
LR, CLIP, STEPS = 1e-2, 5.0, 2
BOS, EOS, BEAM, MAX_LEN = 1, 2, 3, 6
LOSS_RTOL, SCORE_RTOL, GRAD_TOL = 2e-4, 1e-4, 1e-5


def _batch(T):
    r = np.random.default_rng(0)
    src = r.normal(size=(B, 8, C)).astype(np.float32)[:, :T]
    tgt = r.integers(3, V, (B, L)).astype(np.int32)
    src_vl = np.minimum(np.array([8, 7, 5, 3], np.float32), T)
    tgt_vl = np.full((B,), L, np.float32)
    return src, tgt, src_vl, tgt_vl


def _model(params, world=None):
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, dropout=0.0)
    return load_flax(NMTModel(V, enc, dec, embed_size=E, hidden_size=H,
                              mem_sharding=world), {"params": params})


def grads(params, T, world, data_rank=0, data_size=1):
    """The loss's gradients over a data index's rows (of ``world``, or
    ``data_rank`` of ``data_size`` without one), by parameter name."""
    if world is not None:
        data_rank, data_size = world.data_rank, world.data_size
    src, tgt, src_vl, tgt_vl = map(torch.from_numpy, shard_rows(
        _batch(T), data_rank, data_size))
    model = _model(params, world).train()
    loss = masked_ce_loss(model(src, tgt[:, :-1], src_vl, tgt_vl - 1),
                          tgt[:, 1:], tgt_vl - 1)
    names, ps = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, ps)))


def run(params, T, world):
    """The gradients of the loss, the losses of STEPS steps and the beam
    decode of the global batch."""
    g = grads(params, T, world)
    batch = _batch(T)
    model = _model(params, world)
    state = ts.create_seq2seq_state(model, ts.adam_with_clip(CLIP), LR)
    step = ts.make_seq2seq_train_step(state, masked_ce_loss)
    rows = batch if world is None else shard_rows(batch, world.data_rank,
                                                  world.data_size)
    losses = [step(*map(torch.from_numpy, rows), i).item()
              for i in range(STEPS)]
    model = _model(params, world).eval()
    translator = BeamSearchTranslator(model, BOS, EOS, beam_size=BEAM,
                                      max_length=MAX_LEN, world=world)
    return losses, translator.translate(batch[0], batch[2]), g


def _rank_main(rank, coordinator, workdir):
    torch.set_num_threads(1)
    D.initialize_multihost(coordinator, WORLD, rank, "cpu")
    try:
        params = torch.load(os.path.join(workdir, "params.pt"),
                            weights_only=False)
        out = {}
        for shape in MESHES:
            world = D.make_mesh(*shape)
            for T in SOURCES:
                out[shape, T] = run(params, T, world)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        D.shutdown()


def _jax(params):
    """JAX losses and decodes, sequence-parallel, per mesh and T."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_ed
    from tennis_tpu.models.gnmt import masked_ce_loss as jax_loss
    from tennis_tpu.parallel import make_mesh, make_seq2seq_train_step
    from tennis_tpu.parallel.mesh import shard_batch
    from tennis_tpu.translation import BeamSearchTranslator as JaxTranslator

    def build(mem_sharding=None):
        enc, dec = jax_ed(num_layers=2, num_bi_layers=1, hidden_size=H,
                          dropout=0.0)
        return JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E,
                      mem_sharding=mem_sharding)

    opt = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(CLIP), optax.adam(learning_rate)))(LR)

    def losses(model, batch, mesh=None):
        step = make_seq2seq_train_step(model, opt, jax_loss, mesh=mesh,
                                       compiler_options=None)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        o, out = opt.init(p), []
        args = shard_batch(mesh, batch) if mesh is not None else batch
        for i in range(STEPS):
            p, _, o, loss = step(p, {}, o, *args, np.uint32(i))
            out.append(float(loss))
        return out

    out = {}
    for T in SOURCES:
        batch = _batch(T)
        for shape in MESHES:
            mesh = make_mesh(*shape)
            sp = build(NamedSharding(mesh, P("data", "model", None)))
            decode = JaxTranslator(sp, bos_id=BOS, eos_id=EOS,
                                   beam_size=BEAM, max_length=MAX_LEN,
                                   mesh=mesh).translate(
                {"params": params}, batch[0], batch[2])
            out[shape, T] = (losses(sp, batch, mesh),
                             tuple(np.asarray(x) for x in decode))
    return out


def _params():
    """The captioner's weights, from a seeded generator, as a flax tree."""
    from tennis_torch.bridge import to_flax

    g = torch.Generator().manual_seed(0)
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, generator=g)
    return to_flax(NMTModel(V, enc, dec, embed_size=E, hidden_size=H,
                            generator=g))["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        workdir = str(tmp_path_factory.mktemp("sp"))
        params = _params()
        torch.save(params, os.path.join(workdir, "params.pt"))
        coordinator = f"127.0.0.1:{D.free_port()}"
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, coordinator, workdir))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        jax_runs = _jax(params)
        plain = {T: run(params, T, None) for T in SOURCES}
        plain_grads = {(T, d, n): grads(params, T, None, d, n)
                       for T in SOURCES for n in {s[0] for s in MESHES}
                       for d in range(n)}
        for p in procs:
            p.join(timeout=300)
        assert [p.exitcode for p in procs] == [0] * WORLD
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    finally:
        torch.set_num_threads(threads)
    assert not D.grouped()
    return dict(ranks=ranks, jax=jax_runs, plain=plain, grads=plain_grads)


@pytest.mark.parametrize("T", SOURCES)
@pytest.mark.parametrize("shape", MESHES)
def test_sequence_parallel_step_loss(runs, shape, T):
    """Against the JAX sequence-parallel step and the port's unsharded one
    (which ``tests/test_torch_seq2seq_step.py`` holds against the JAX
    unsharded step)."""
    jax_sp, _ = runs["jax"][shape, T]
    plain = runs["plain"][T][0]
    np.testing.assert_allclose(plain, jax_sp, rtol=LOSS_RTOL)
    for rank in runs["ranks"]:
        losses = rank[shape, T][0]
        np.testing.assert_allclose(losses, jax_sp, rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses, plain, rtol=LOSS_RTOL)


@pytest.mark.parametrize("T", SOURCES)
@pytest.mark.parametrize("shape", MESHES)
def test_sequence_parallel_beam_decode(runs, shape, T):
    _, (samples, scores, lengths) = runs["jax"][shape, T]
    assert samples.shape[0] == B
    for rank in runs["ranks"]:
        got = rank[shape, T][1]
        np.testing.assert_array_equal(got[0], samples)
        np.testing.assert_allclose(got[1], scores, rtol=SCORE_RTOL)
        np.testing.assert_array_equal(got[2], lengths)
    np.testing.assert_array_equal(runs["plain"][T][1][0], samples)


@pytest.mark.parametrize("T", SOURCES)
@pytest.mark.parametrize("shape", MESHES)
def test_sequence_parallel_gradients(runs, shape, T):
    """Every parameter's gradient over a data index's rows equals the
    unsharded one's (within 1e-5 of the leaf's largest magnitude): the
    query's and the memory's gradients sum every time block's part."""
    for r, rank in enumerate(runs["ranks"]):
        got = rank[shape, T][2]
        want = runs["grads"][T, r // shape[1], shape[0]]
        assert set(got) == set(want)
        for name, w in want.items():
            torch.testing.assert_close(
                got[name], w, rtol=0, atol=GRAD_TOL * w.abs().max().item(),
                msg=name)


def _split_softmax(scores, mask, blocks, monkeypatch):
    """``sharded_masked_softmax`` of each block, as if each block's rank
    ran it: the collectives are replaced by their result over the
    blocks (MAX and SUM over a list)."""
    import tennis_torch.ops.attention as attention

    neg = torch.finfo(torch.float32).min
    parts = list(zip(scores.chunk(blocks, -1), mask.chunk(blocks, -1)))
    top = torch.stack([s.masked_fill(~m, neg).amax(-1, keepdim=True)
                       for s, m in parts]).amax(0)
    sums = [torch.exp(s.masked_fill(~m, neg) - top).sum(-1, keepdim=True)
            for s, m in parts]
    z = torch.stack(sums).sum(0)
    monkeypatch.setattr(attention, "max_model_", lambda x, world: top)
    monkeypatch.setattr(attention, "reduce_model", lambda x, world: z)
    monkeypatch.setattr(attention, "to_model", lambda x, world: x)
    return torch.cat([sharded_masked_softmax(s, m, None) for s, m in parts],
                     -1)


def test_a_block_with_no_unmasked_step_gives_zeros_not_nan(monkeypatch):
    """Row 1 has its steps in block 0 only, row 2 none at all: the
    blocks' weights, put together, are ``masked_softmax``'s."""
    g = torch.Generator().manual_seed(0)
    scores = torch.randn(3, 1, 8, generator=g) * 4
    lengths = torch.tensor([8, 3, 0])
    mask = (torch.arange(8)[None, :] < lengths[:, None])[:, None, :]
    got = _split_softmax(scores, mask, 2, monkeypatch)
    want = masked_softmax(scores, mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert (got[1, :, 3:] == 0).all() and (got[2] == 0).all()
