"""Data parallelism on two gloo ranks on the CPU, against the port's
single-process steps and the JAX package's unsharded ones.

Two processes are spawned once for the module (``_rank_main``); each joins
a gloo group on 127.0.0.1, runs every check below on its share of the
inputs and saves what it computed, and the tests hold both ranks' results
against the same work done by this process without a group:

- the classifier step (``make_train_step`` in a group): 3 steps over a
  global batch of 8, 4 rows a rank, dealt as the world-striped loader
  deals them (rank r takes rows r, r+2, ...). The odd rows are shifted by
  +3, so that BN statistics taken per rank would be far off. A narrow
  DenseNet-BC (blocks (1, 1)) in f32 from a JAX state at step 5 with
  momentum, also held against the JAX ``make_train_step`` on the 8 rows
  at the tolerance of ``tests/test_torch_train_step.py`` (every leaf
  within 1e-4 of its largest magnitude); ResNet-18 v2 in f64 (its f32 step
  is chaotic at this size, ``tests/test_torch_resnet.py``); and the
  DenseNet over uint8 frames through the driver's device augment, whose
  draws each rank takes for its rows of the global batch;
- the seq2seq step (``make_seq2seq_train_step`` in a group): 3 Adam
  steps clipped at 0.01, hidden 8, dropout 0, over a global batch of 4
  padded to its longest lengths, rank 1's rows far shorter than rank 0's,
  also held against the JAX step at the relative L2 of
  ``tests/test_torch_seq2seq_step.py`` (1e-4);
- ``sharded_eval_iter`` over 37 rows at a per-rank batch of 8;
- the beam decode (``train_gnmt.decode_split`` in a group), batches of
  5 and 3 rows padded to the world.

Loss, parameters and BN statistics of a rank equal the single-process
step's within rtol and atol 1e-5; the evaluation's rows and the decode's
sentences equal the single-process ones exactly.
"""
import argparse
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from tennis_torch.data.loader import DataLoader, eval_iter, \
    sharded_eval_iter
from tennis_torch.inference import build_frame_model
from tennis_torch.models import DenseNet, DenseNetSpec, FrameModel
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss
from tennis_torch.parallel import distributed as D
from tennis_torch.parallel import train_step as ts
from tennis_torch.parallel.mesh import World, pad_batch, shard_rows

WORLD = 2
BLOCKS, SIDE, CLASSES, GLOBAL, STEPS = (1, 1), 32, 5, 8, 3
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
TOL = 1e-5
STEP_TOL = 1e-4  # tests/test_torch_train_step.py
V, E, H, C, B, T, L = 14, 8, 8, 32, 4, 11, 9
PARAM_TOL = 1e-4  # tests/test_torch_seq2seq_step.py
N_EVAL, EVAL_BATCH = 37, 8


def _densenet(dtype=torch.float32):
    spec = DenseNetSpec(BLOCKS)
    return FrameModel(DenseNet(spec, dtype=dtype), CLASSES, dtype=dtype,
                      feature_dim=spec.final_channels)


def _resnet():
    return build_frame_model("resnet18_v2", CLASSES, SIDE,
                             dtype=torch.float64,
                             generator=torch.Generator().manual_seed(3))


def _classifier_batches(kind):
    """STEPS global batches (x, labels): odd rows shifted by +3 (f32, f64),
    or uint8 frames with the odd rows bright and the even ones dark."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, CLASSES, GLOBAL).astype(np.int64)
        if kind == "augment":
            x = rng.integers(0, 128, (GLOBAL, SIDE, SIDE, 3)).astype(np.uint8)
            x[1::2] += 127
        else:
            x = rng.standard_normal((GLOBAL, SIDE, SIDE, 3))
            x[1::2] += 3.0
            x = x.astype(np.float64 if kind == "resnet" else np.float32)
        out.append((x, labels))
    return out


def _classifier_state(kind, tree):
    tx, _ = ts.sgd_with_schedule(LR, MOMENTUM, WD, (1, 2), 0.75, 1)
    model = _resnet() if kind == "resnet" else _densenet()
    state = ts.create_train_state(model, tx)
    if kind != "resnet":
        from tennis_torch.bridge import state_from_flax

        state_from_flax(state, tree)
    return state


def run_classifier(kind, tree, world):
    """Losses and the final state dict of STEPS steps; on a rank of a
    world, on its stripe of every global batch."""
    from tennis_torch import train

    state = _classifier_state(kind, tree)
    preprocess = None
    if kind == "augment":
        preprocess = train.make_preprocess(argparse.Namespace(flow=""),
                                           torch.float32)
    step = ts.make_train_step(state, preprocess, rng_seed=11)
    losses = []
    for x, labels in _classifier_batches(kind):
        if world.grouped:
            x, labels = x[world.rank::world.size], \
                labels[world.rank::world.size]
        loss, _ = step(torch.from_numpy(x), labels)
        losses.append(loss.item())
    return losses, {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}


def _seq2seq_batches():
    """STEPS global batches padded to their longest lengths; rank 1's rows
    (2, 3) have source and target lengths of 2-3, rank 0's the full T, L."""
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(20 + seed)
        src_vl = np.array([T, T - 1, 2, 3], np.float32)
        tgt_vl = np.array([L, L - 1, 2, 3], np.float32)
        src = rng.normal(size=(B, T, C)).astype(np.float32)
        src[np.arange(T)[None, :] >= src_vl[:, None]] = 0.0
        tgt = rng.integers(0, V, (B, L)).astype(np.int32)
        out.append((src, tgt, src_vl, tgt_vl))
    return out


def run_seq2seq(params, world):
    from tennis_torch.bridge import load_flax

    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, dropout=0.0)
    model = load_flax(NMTModel(V, enc, dec, embed_size=E, hidden_size=H),
                      {"params": params})
    state = ts.create_seq2seq_state(model, ts.adam_with_clip(0.01), 1e-2)
    step = ts.make_seq2seq_train_step(state, masked_ce_loss)
    losses = []
    for i, batch in enumerate(_seq2seq_batches()):
        if world.grouped:
            batch = shard_rows(batch, world.rank, world.size)
        losses.append(step(*map(torch.from_numpy, batch), i).item())
    return losses, {k: v.detach().clone()
                    for k, v in model.named_parameters()}


class _Rows:
    """N_EVAL samples: features (3,) from the index, label, index."""

    def __len__(self):
        return N_EVAL

    def __getitem__(self, i):
        return np.arange(3, dtype=np.float32) + i, np.int64(i % 5), np.int64(i)


def _eval_step(x):
    return x * 2.0 + 1.0


def run_eval(world):
    """(out, labels, idxs) of every row: ``sharded_eval_iter`` at a
    per-rank batch of EVAL_BATCH on a world, else ``eval_iter`` at the
    global batch."""
    if world.grouped:
        loader = DataLoader(_Rows(), EVAL_BATCH, num_workers=1,
                            num_shards=world.size, shard_id=world.rank)
        blocks = list(sharded_eval_iter(loader, EVAL_BATCH, N_EVAL,
                                        _eval_step))
    else:
        blocks = list(eval_iter(DataLoader(_Rows(), EVAL_BATCH * WORLD,
                                           num_workers=1), _eval_step))
    return tuple(np.concatenate(parts) for parts in zip(*blocks))


class _Vocab:
    bos_token, eos_token = "<bos>", "<eos>"

    def __getitem__(self, token):
        return {"<bos>": 2, "<eos>": 3}[token]

    def to_tokens(self, ids):
        return [str(int(i)) for i in ids]


def run_decode():
    """Top hypotheses of two batches (5 and 3 rows) of a seeded captioner,
    through ``decode_split``."""
    from tennis_torch.train_gnmt import decode_split
    from tennis_torch.translation import BeamSearchTranslator

    g = torch.Generator().manual_seed(4)
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, generator=g)
    model = NMTModel(V, enc, dec, embed_size=E, hidden_size=H,
                     generator=g).eval()
    rng = np.random.default_rng(6)
    batches, start = [], 0
    for n in (5, 3):
        src_vl = rng.integers(1, T + 1, n).astype(np.int32)
        src = rng.normal(size=(n, T, C)).astype(np.float32)
        tgt = rng.integers(0, V, (n, L)).astype(np.int32)
        batches.append((src, tgt, src_vl, np.full(n, L, np.int32),
                        np.arange(start, start + n)))
        start += n
    translator = BeamSearchTranslator(model, 2, 3, beam_size=3,
                                      max_length=6)
    return decode_split(translator, _Vocab(), batches, "cpu")


def run_all(cases, world):
    return dict(
        classifier={kind: run_classifier(kind, cases["tree"], world)
                    for kind in ("densenet", "resnet", "augment")},
        seq2seq=run_seq2seq(cases["seq2seq_params"], world),
        eval=run_eval(world),
        decode=run_decode())


def _rank_main(rank, coordinator, workdir):
    torch.set_num_threads(1)
    D.initialize_multihost(coordinator, WORLD, rank, "cpu")
    try:
        world = D.current_world("cpu")
        assert world == World(rank, WORLD, 0, torch.device("cpu"), True)
        cases = torch.load(os.path.join(workdir, "cases.pt"),
                           weights_only=False)
        torch.save(run_all(cases, world),
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        D.shutdown()


def _jax_inputs():
    """The DenseNet's JAX state (step 5, momentum) and the captioner's JAX
    initial parameters, as host trees."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
    from test_torch_train_step import _jax_state

    jstate = _jax_state(seed=1)
    enc, dec = jax_enc_dec(hidden_size=H, dropout=0.0)
    jmodel = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E)
    src, tgt = _seq2seq_batches()[0][:2]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                     jnp.asarray(tgt[:, :-1]))
    return (jstate, jmodel, jax.device_get(serialization.to_state_dict(jstate)),
            jax.tree_util.tree_map(np.asarray, dict(variables["params"])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, this process's single-process results and
    the JAX inputs and steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        workdir = str(tmp_path_factory.mktemp("ddp"))
        jstate, jmodel, tree, params = _jax_inputs()
        cases = dict(tree=tree, seq2seq_params=params)
        torch.save(cases, os.path.join(workdir, "cases.pt"))
        coordinator = f"127.0.0.1:{D.free_port()}"
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, coordinator, workdir))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        single = run_all(cases, World())
        for p in procs:
            p.join(timeout=300)
        assert [p.exitcode for p in procs] == [0] * WORLD
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    finally:
        torch.set_num_threads(threads)
    assert not D.grouped()  # this process made no group
    return dict(ranks=ranks, single=single, jstate=jstate, jmodel=jmodel,
                params=params, tree=tree)


def _close(a, b, what):
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=what)


@pytest.mark.parametrize("kind", ["densenet", "resnet", "augment"])
def test_classifier_step_is_the_global_batchs(runs, kind):
    """Both ranks end with the single-process losses, parameters and
    running statistics; per-rank statistics would be ~3 off the global
    ones (the check below that the ranks' halves differ)."""
    want_losses, want = runs["single"]["classifier"][kind]
    x = _classifier_batches(kind)[0][0].astype(np.float64)
    assert abs(x[0::2].mean() - x[1::2].mean()) > 0.25 * np.abs(x).max()
    for rank in runs["ranks"]:
        losses, got = rank["classifier"][kind]
        np.testing.assert_allclose(losses, want_losses, rtol=TOL, atol=TOL)
        assert set(got) == set(want)
        assert any("running" in k for k in got)
        for k in want:
            _close(got[k], want[k], k)


def test_classifier_step_equals_the_jax_unsharded_step(runs):
    """The DenseNet's data-parallel steps against the JAX
    ``make_train_step`` on the whole global batch, leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from tennis_tpu.parallel import make_train_step
    from tennis_torch.bridge import state_to_flax
    from test_torch_train_step import _jax_frame_model

    jstate = runs["jstate"]
    jstep = make_train_step(_jax_frame_model(), compiler_options=None)
    jlosses = []
    for x, labels in _classifier_batches("densenet"):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(x),
                                 jnp.asarray(labels.astype(np.int32)))
        jlosses.append(float(jloss))
    want = jax.device_get(serialization.to_state_dict(jstate))
    for rank in runs["ranks"]:
        losses, sd = rank["classifier"]["densenet"]
        np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)
        state = _classifier_state("densenet", runs["tree"])
        state.model.load_state_dict(sd)
        got = state_to_flax(state)
        for col in ("params", "batch_stats"):
            for (path, w), (_, g) in zip(
                    jax.tree_util.tree_flatten_with_path(want[col])[0],
                    jax.tree_util.tree_flatten_with_path(got[col])[0]):
                w, g = np.asarray(w), np.asarray(g)
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)
                assert err <= STEP_TOL, (jax.tree_util.keystr(path), err)


def test_seq2seq_step_is_the_global_batchs(runs):
    """Both ranks end with the single-process losses and parameters:
    each rank's rows keep the global batch's padded T, which
    ``masked_ce_loss(average="padded")`` divides by, and the clip sees the
    global gradient."""
    want_losses, want = runs["single"]["seq2seq"]
    for rank in runs["ranks"]:
        losses, got = rank["seq2seq"]
        np.testing.assert_allclose(losses, want_losses, rtol=TOL, atol=TOL)
        for k in want:
            _close(got[k], want[k], k)


def test_seq2seq_step_equals_the_jax_unsharded_step(runs):
    import jax
    import jax.numpy as jnp
    import optax

    from tennis_tpu.models.gnmt import masked_ce_loss as jax_loss
    from tennis_tpu.parallel.train_step import make_seq2seq_train_step
    from tennis_torch.bridge import from_flax

    opt = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(0.01), optax.adam(learning_rate)))(1e-2)
    step = make_seq2seq_train_step(runs["jmodel"], opt, jax_loss)
    params = jax.tree_util.tree_map(jnp.asarray, runs["params"])
    opt_state, stats = opt.init(params), {}
    for i, batch in enumerate(_seq2seq_batches()):
        params, stats, opt_state, _ = step(
            params, stats, opt_state, *map(jnp.asarray, batch), np.uint32(i))
    want = from_flax({"params": jax.device_get(params)})
    for rank in runs["ranks"]:
        got = rank["seq2seq"][1]
        num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
        den = sum((want[k] ** 2).sum() for k in want)
        assert (num / den).sqrt().item() <= PARAM_TOL


def test_sharded_eval_yields_the_single_device_rows(runs):
    """Every row once: no pad row, no wrap-padded duplicate of the last
    stripe; the rows (by index) equal the single-device pass's."""
    s_out, s_labels, s_idxs = runs["single"]["eval"]
    assert sorted(s_idxs.tolist()) == list(range(N_EVAL))
    for rank in runs["ranks"]:
        out, labels, idxs = rank["eval"]
        assert sorted(idxs.tolist()) == list(range(N_EVAL))
        order, s_order = np.argsort(idxs), np.argsort(s_idxs)
        np.testing.assert_array_equal(out[order], s_out[s_order])
        np.testing.assert_array_equal(labels[order], s_labels[s_order])


def test_sharded_decode_gives_the_single_device_sentences(runs):
    want = runs["single"]["decode"]
    assert len(want) == 8 and all(h is not None for h in want)
    for rank in runs["ranks"]:
        assert rank["decode"] == want


def test_no_group_runs_no_collective():
    """Without a process group the world is one rank, the gradient
    average returns its inputs as they are, and the fetches are host
    copies."""
    assert not D.grouped()
    world = D.current_world("cpu")
    assert world == World() and world.is_main and not world.grouped
    g = [torch.ones(3)]
    loss = torch.tensor(2.0)
    got, got_loss = ts.all_reduce_mean(g, world, loss)
    assert got[0] is g[0] and got_loss is loss
    assert ts.stripe_rows(world, 4, "cpu") is None
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(D.fetch_global(x), x)
    assert D.host_batch_slice(8) == 8
    padded, n = pad_batch((x, torch.arange(3)), 2)
    assert n == 3 and padded[0].shape == (4, 2) and padded[1].tolist() == \
        [0, 1, 2, 0]
