"""Tensor parallelism on four gloo ranks on the CPU, at meshes 2 x 2 and
1 x 4, against the JAX package's steps under the same meshes of its 8
virtual devices.

Four gloo ranks on 127.0.0.1 run once for the module
(``parallel.distributed.launch(num_model=2)``: this process is rank 0, the
others are spawned, and every rank lays out the 2 x 2 pod mesh first); each
rank lays out every mesh in turn (``make_mesh``), runs the cases below on
its rows and blocks and saves what it computed (``_rank_main``):

- the CNN-RNN over 512-d features at H 128 (the rule column-shards its
  four GRU kernels), 2 SGD steps with momentum and weight decay over a
  global batch of 8, against the JAX ``make_train_step(state_sharding=
  state_shardings(...))``;
- the same CNN-RNN's bf16 logits (its driver's dtype) against the
  unsharded module's, within 2e-2 of their largest magnitude;
- the width-96 captioner (10 sharded kernels), 3 steps of Adam with a
  global-norm clip of 0.01 (it binds: the gradient norms are far above
  it), against the JAX ``make_seq2seq_train_step(mesh=)``;
- the same captioner at dropout 0.1 on the 2 x 2 mesh and on a 2 x 1 mesh
  of the first two ranks (data parallelism alone): the same masks, so the
  same run;
- a 1 x 2 mesh of the first two ranks loads a JAX-written captioner epoch
  (Adam moments included) into placed blocks and writes it again.

The losses are held within rtol 2e-4 (``tests/test_parallel.py``'s bound),
the gathered parameters and optimizer state within 1e-5 of the JAX ones
(the CNN-RNN's element by element; the captioner's parameters in relative
L2, and element by element against the port's single-process step: Adam
turns the last bits of a near-zero gradient into ~1e-5 of update, and the
single-process port already lies 1.9e-5 off JAX at one element of 55,296),
every rank's gathered state equal to every other's (the data replicas hold
equal blocks), the dropout runs' losses within 1e-6 and their parameters
within 1e-6 in relative L2, and the rewritten epoch equal to the JAX file
byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from tennis_torch.bridge import load_flax, state_from_flax, state_to_flax, \
    to_flax
from tennis_torch.models import CNNRNN
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss
from tennis_torch.parallel import distributed as D
from tennis_torch.parallel import sharding_rules as rules
from tennis_torch.parallel import train_step as ts
from tennis_torch.parallel.mesh import World, shard_rows
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec

WORLD = 4
MESHES = ((2, 2), (1, 4))
LOSS_RTOL, TOL, DROPOUT_TOL, BF16_TOL = 2e-4, 1e-5, 1e-6, 2e-2
# the CNN-RNN
F, HC, CLASSES, GLOBAL, TC, STEPS = 512, 128, 4, 8, 3, 2
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4
# the width-96 captioner
V, E, H, C, B, T, L = 30, 8, 96, 32, 4, 11, 9
CAP_LR, CLIP, CAP_STEPS = 1e-2, 0.01, 3


def _cnnrnn_batches():
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((GLOBAL, TC, F)).astype(np.float32),
             rng.integers(0, CLASSES, GLOBAL).astype(np.int64))
            for _ in range(STEPS)]


def _caption_batches():
    """Global batches padded to their longest lengths; the last rows
    short, so that a data index's rows differ in length from another's."""
    out = []
    for seed in range(CAP_STEPS):
        rng = np.random.default_rng(30 + seed)
        src_vl = np.array([T, T - 1, 4, 2], np.float32)
        tgt_vl = np.array([L, L - 2, 3, 2], np.float32)
        src = rng.normal(size=(B, T, C)).astype(np.float32)
        src[np.arange(T)[None, :] >= src_vl[:, None]] = 0.0
        tgt = rng.integers(0, V, (B, L)).astype(np.int32)
        out.append((src, tgt, src_vl, tgt_vl))
    return out


def _captioner(dropout=0.0):
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, dropout=dropout)
    return NMTModel(V, enc, dec, embed_size=E, hidden_size=H)


def _blocks(model):
    """This rank's tensors of the column-sharded weights."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n in rules.block_worlds(model)}


def run_cnnrnn(tree, world):
    model = CNNRNN(None, CLASSES, hidden_size=HC, dtype=torch.float32,
                   feature_dim=F)
    tx, _ = ts.sgd_with_schedule(LR, MOMENTUM, WD)
    state = ts.create_train_state(model, tx, world=world)
    state_from_flax(state, tree)
    step = ts.make_train_step(state)
    losses = []
    for x, labels in _cnnrnn_batches():
        rows = slice(world.data_rank, None, world.data_size)
        loss, _ = step(torch.from_numpy(x[rows]), labels[rows])
        losses.append(loss.item())
    return losses, state_to_flax(state), _blocks(model)


def run_cnnrnn_bf16(tree, world):
    """The CNN-RNN's bf16 logits (its driver's dtype: each projection's
    product and bias sum rounded to bf16) over this data index's rows of
    the first batch, its kernels placed as blocks; every rows without a
    world."""
    model = CNNRNN(None, CLASSES, hidden_size=HC, dtype=torch.bfloat16,
                   feature_dim=F)
    load_flax(model, {"params": tree["params"]})
    x = _cnnrnn_batches()[0][0]
    if world is not None:
        rules.place_blocks(model, world)
        x = x[world.data_rank::world.data_size]
    with torch.no_grad():
        return model(torch.from_numpy(x))


def run_captioner(params, world, dropout=0.0):
    model = load_flax(_captioner(dropout), {"params": params})
    state = ts.create_seq2seq_state(model, ts.adam_with_clip(CLIP), CAP_LR,
                                    world=world)
    assert len(rules.block_worlds(model)) == (10 if world.model_size > 1
                                              else 0)
    # the whole tree is the one loaded: blocks cut, then gathered back
    got = to_flax(model)["params"]
    for path, want in _leaves(params):
        np.testing.assert_array_equal(_at(got, path), want)
    step = ts.make_seq2seq_train_step(state, masked_ce_loss)
    losses = []
    for i, batch in enumerate(_caption_batches()):
        rows = shard_rows(batch, world.data_rank, world.data_size)
        losses.append(step(*map(torch.from_numpy, rows), i).item())
    return losses, state_to_flax(state), _blocks(model)


def rewrite_epoch(params, path, world):
    """The JAX-written epoch loaded into placed blocks, written again."""
    state = ts.create_seq2seq_state(_captioner(), ts.adam_with_clip(CLIP),
                                    CAP_LR, world=world)
    assert len(rules.block_worlds(state.model)) == 10
    state_from_flax(state, ckpt.load_raw(path))
    return msgpack_codec.serialize(state_to_flax(state))


def _rank_main(workdir):
    """A rank of ``launch(num_model=2)``: the pod mesh it laid out is the
    first mesh; then every mesh in turn."""
    rank = D.current_world().rank
    assert D.current_world().model_size == MESHES[0][1]
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    out = {}
    for shape in MESHES:
        world = D.make_mesh(*shape)
        assert (world.data_size, world.model_size) == shape
        out[shape] = dict(
            cnnrnn=run_cnnrnn(cases["cnnrnn"], world),
            cnnrnn_bf16=run_cnnrnn_bf16(cases["cnnrnn"], world),
            captioner=run_captioner(cases["captioner"], world))
        if shape == (2, 2):
            out["dropout_2x2"] = run_captioner(cases["captioner"], world, 0.1)
    world = D.make_mesh(2, 1)  # ranks 2 and 3 hold no place
    assert (world is None) == (rank >= 2)
    if world is not None:
        out["dropout_2x1"] = run_captioner(cases["captioner"], world, 0.1)
    world = D.make_mesh(1, 2)
    if world is not None:
        out["epoch"] = rewrite_epoch(cases["captioner"], cases["epoch_path"],
                                     world)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _jax_cnnrnn(shape):
    """The JAX CNN-RNN state (initialised from a key, momentum drawn
    away from zero) and its losses and state after STEPS steps under the
    mesh, with its state sharded by ``state_shardings``."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from tennis_tpu.models import CNNRNN as JaxCNNRNN
    from tennis_tpu.parallel import create_train_state, make_mesh, \
        make_train_step, sgd_with_schedule
    from tennis_tpu.parallel.mesh import shard_batch
    from tennis_tpu.parallel.sharding_rules import state_shardings

    mesh = make_mesh(*shape)
    model = JaxCNNRNN(model=None, num_classes=CLASSES, hidden_size=HC,
                      dtype=jnp.float32)
    tx, _ = sgd_with_schedule(LR, MOMENTUM, WD)
    state = create_train_state(model, jax.random.PRNGKey(1),
                               jnp.zeros((1, TC, F)), tx, {"train": True},
                               mesh=mesh)
    rng = np.random.default_rng(4)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
        jax.device_get(state.opt_state[1][0].trace))
    state = state.replace(opt_state=(state.opt_state[0], (
        state.opt_state[1][0]._replace(trace=trace), state.opt_state[1][1])))
    sh = state_shardings(mesh, state)
    state = jax.tree_util.tree_map(jax.device_put, state, sh)
    tree = jax.device_get(serialization.to_state_dict(state))
    step = make_train_step(model, mesh=mesh, state_sharding=sh,
                           compiler_options=None)
    losses = []
    for x, labels in _cnnrnn_batches():
        state, loss, _ = step(state, *shard_batch(
            mesh, (x, labels.astype(np.int32))))
        # the step leaves its outputs where GSPMD put them; the next call
        # wants them in the state's shardings again
        state = jax.tree_util.tree_map(jax.device_put, state, sh)
        losses.append(float(loss))
    return tree, losses, jax.device_get(serialization.to_state_dict(state))


def _jax_captioner(shape, params):
    import jax
    import jax.numpy as jnp
    import optax

    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_ed
    from tennis_tpu.models.gnmt import masked_ce_loss as jax_loss
    from tennis_tpu.parallel import make_mesh, make_seq2seq_train_step
    from tennis_tpu.parallel.mesh import shard_batch

    mesh = make_mesh(*shape)
    enc, dec = jax_ed(hidden_size=H, dropout=0.0)
    model = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E)
    opt = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(CLIP), optax.adam(learning_rate)))(CAP_LR)
    step = make_seq2seq_train_step(model, opt, jax_loss, mesh=mesh,
                                   compiler_options=None)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state, stats, losses = opt.init(p), {}, []
    for i, batch in enumerate(_caption_batches()):
        p, stats, opt_state, loss = step(p, stats, opt_state,
                                         *shard_batch(mesh, batch),
                                         np.uint32(i))
        losses.append(float(loss))
    return losses, {"params": jax.device_get(p), "batch_stats": {},
                    "opt_state": jax.device_get(opt_state)}


def _state_dict(tree):
    from flax import serialization

    return serialization.to_state_dict(tree)


def _jax_captioner_init():
    import jax
    import jax.numpy as jnp

    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_ed

    enc, dec = jax_ed(hidden_size=H)
    model = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E)
    src, tgt = _caption_batches()[0][:2]
    variables = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.asarray(src),
                                    jnp.asarray(tgt[:, :-1]))
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the JAX runs under each mesh."""
    from tennis_tpu.utils import checkpoint as jax_ckpt

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        workdir = str(tmp_path_factory.mktemp("tp"))
        params = _jax_captioner_init()
        jax_cnn = {shape: _jax_cnnrnn(shape) for shape in MESHES}
        jax_runs = {shape: dict(cnnrnn=jax_cnn[shape][1:],
                                captioner=_jax_captioner(shape, params))
                    for shape in MESHES}
        epoch_path = os.path.join(workdir, "0002.params")
        cases = dict(cnnrnn=jax_cnn[MESHES[0]][0], captioner=params,
                     epoch_path=epoch_path)
        jax_ckpt.save_state(epoch_path, jax_runs[MESHES[0]]["captioner"][1])
        plain = run_captioner(params, World())
        plain_bf16 = run_cnnrnn_bf16(cases["cnnrnn"], None)
        torch.save(cases, os.path.join(workdir, "cases.pt"))
        # this process is rank 0; launch joins the others, raising if one
        # failed
        D.launch("test_torch_tensor_parallel:_rank_main", WORLD, (workdir,),
                 device="cpu", num_model=MESHES[0][1])
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        epoch = open(epoch_path, "rb").read()
    finally:
        torch.set_num_threads(threads)
    assert not D.grouped()
    return dict(ranks=ranks, jax=jax_runs, epoch=epoch, plain=plain,
                plain_bf16=plain_bf16)


def _rel_l2(got, want) -> float:
    """The relative L2 distance of tree ``got`` from tree ``want``."""
    num = sum(((_at(got, p).astype(np.float64) - w) ** 2).sum()
              for p, w in _leaves(want))
    den = sum((w.astype(np.float64) ** 2).sum() for _, w in _leaves(want))
    return float(np.sqrt(num / den))


def _close_trees(got, want, keys, what):
    for key in keys:
        for path, w in _leaves(want[key]):
            g = _at(got[key], path)
            assert g.shape == w.shape, (what, key, path)
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{what} {key} {path}")


@pytest.mark.parametrize("shape", MESHES)
def test_cnnrnn_sgd_step_equals_the_jax_sharded_step(runs, shape):
    jax_losses, want = runs["jax"][shape]["cnnrnn"]
    for rank in runs["ranks"]:
        losses, got, _ = rank[shape]["cnnrnn"]
        np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
        assert int(got["step"]) == int(want["step"]) == STEPS
        _close_trees(got, want, ("params",), "cnnrnn")
        _close_trees(got["opt_state"]["1"]["0"],
                     want["opt_state"]["1"]["0"], ("trace",), "cnnrnn")


@pytest.mark.parametrize("shape", MESHES)
def test_cnnrnn_bf16_logits_equal_the_plain_ones(runs, shape):
    """In bf16 the column-parallel layers round where the whole ones do:
    the logits within 2e-2 of their largest magnitude
    (``tests/test_torch_cnnrnn.py``'s bf16 bound against JAX)."""
    want = runs["plain_bf16"].float()
    for r, rank in enumerate(runs["ranks"]):
        d = r // shape[1]
        got = rank[shape]["cnnrnn_bf16"].float()
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        torch.testing.assert_close(
            got, want[d::shape[0]], rtol=0,
            atol=BF16_TOL * want.abs().max().item())


@pytest.mark.parametrize("shape", MESHES)
def test_clipped_adam_captioner_step_equals_the_jax_step(runs, shape):
    jax_losses, want = runs["jax"][shape]["captioner"]
    want = _state_dict(want)
    for rank in runs["ranks"]:
        losses, got, _ = rank[shape]["captioner"]
        np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
        assert _rel_l2(got["params"], want["params"]) <= TOL
        _close_trees(got, runs["plain"][1], ("params",), "captioner")
        adam = want["opt_state"]["inner_state"]["1"]["0"]
        _close_trees(got["opt_state"]["inner_state"]["1"]["0"], adam,
                     ("mu", "nu"), "captioner")
        assert int(got["opt_state"]["count"]) == CAP_STEPS


@pytest.mark.parametrize("case", ["cnnrnn", "captioner"])
@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_the_same_state_and_its_own_blocks(runs, shape,
                                                            case):
    """The gathered trees are equal on every rank; the data replicas of a
    model index hold equal blocks, the model ranks of a data index
    different ones."""
    ranks = runs["ranks"]
    _, first, _ = ranks[0][shape][case]
    for rank in ranks[1:]:
        for path, w in _leaves(first):
            np.testing.assert_array_equal(_at(rank[shape][case][1], path), w)
    d, m = shape
    blocks = [rank[shape][case][2] for rank in ranks]
    assert blocks[0] and all(set(b) == set(blocks[0]) for b in blocks)
    for name in blocks[0]:
        for r in range(WORLD):
            same = blocks[r % m][name]
            assert torch.equal(blocks[r][name], same)
            if m > 1 and r % m:
                assert not torch.equal(blocks[r][name], blocks[0][name])


def test_dropout_masks_follow_the_data_index(runs):
    """At dropout 0.1 the 2 x 2 run is the 2 x 1 data-parallel run: the
    model ranks of a data index draw its masks alike."""
    want_losses, want, _ = runs["ranks"][0]["dropout_2x1"]
    no_dropout = runs["ranks"][0][(2, 2)]["captioner"][0]
    assert abs(want_losses[0] - no_dropout[0]) > 100 * DROPOUT_TOL
    for rank in runs["ranks"]:
        losses, got, _ = rank["dropout_2x2"]
        np.testing.assert_allclose(losses, want_losses, rtol=DROPOUT_TOL,
                                   atol=DROPOUT_TOL)
        assert _rel_l2(got["params"], want["params"]) <= DROPOUT_TOL


def test_an_epoch_written_under_the_model_axis_is_the_jax_file(runs):
    for rank in runs["ranks"][:2]:
        assert rank["epoch"] == runs["epoch"]
    assert all("epoch" not in rank for rank in runs["ranks"][2:])
