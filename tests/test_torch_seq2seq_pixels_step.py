"""The pixels-path captioner's train step against the JAX package's on the
CPU: a 2-block f32 DenseNet ``src_embed`` at 16^2, float frames (no
augment, as in JAX), dropout 0, three Adam steps with global-norm clipping
through ``make_seq2seq_train_step`` and the JAX driver's optax chain, with
and without ``--freeze_backbone`` (``masked(set_to_zero)`` of ``src_embed``
before the clip). The losses, parameters, running statistics and Adam
moments within 1e-5 (relative; global L2 for the trees). The stem BN's
scale and bias are the exception: their gradient cancels through every BN
after it, the JAX package's f32 gradient of the scale lies 2.4e-4 off f64
(tests/test_torch_gnmt_pixels.py), and Adam turns that into updates 1.6%
and 7.7% of their move off a run with the backbone in f64 (the port's 1.3%
and 1.8%); so they are held within 5e-2 of their move of that f64 run.
Frozen
``src_embed`` parameters unchanged bit for bit while their statistics move
and their moments stay zero; and the train state in the JAX driver's file
layout (the three-stage chain when frozen, two-stage otherwise), read back
by either package."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec
from tennis_tpu.models.gnmt import NMTModel as JaxNMT
from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
from tennis_tpu.models.gnmt import masked_ce_loss as jax_masked_ce_loss
from tennis_tpu.parallel.train_step import \
    make_seq2seq_train_step as jax_make_step
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch.bridge import from_flax, load_flax, state_from_flax, \
    state_to_flax
from tennis_torch.models import DenseNet, DenseNetSpec
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss
from tennis_torch.parallel.train_step import adam_with_clip, \
    create_seq2seq_state, make_seq2seq_train_step
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec

V, E, H, B, T, L, S = 12, 8, 16, 2, 4, 6, 16
SPEC = ((2, 2), 32, 64, 4)
FEAT = 128
LR, CLIP = 1e-3, 5.0  # the driver's --lr and --clip
TOL = 1e-5
# the stem BN's leaves, held against the port's step with its backbone in
# f64 (the GNMT stays f32), within STEM_TOL of their move
STEM = {"src_embed.bn0.weight", "src_embed.bn0.bias"}
STEM_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n=3):
    out = []
    for seed in range(n):
        rng = np.random.default_rng(20 + seed)
        src_vl = np.asarray([T, 2], np.float32)
        tgt_vl = rng.integers(2, L + 1, B).astype(np.float32)
        src = rng.normal(size=(B, T, S, S, 3)).astype(np.float32)
        src[1, 2:] = 0.0  # the loader's padded steps
        tgt = rng.integers(0, V, (B, L)).astype(np.int32)
        out.append((src, tgt, src_vl, tgt_vl))
    return out


def _jax_opt(freeze):
    """The JAX driver's optimizer (tennis_tpu/train_gnmt.py ``_make_opt``)."""
    def make(learning_rate):
        stages = []
        if freeze:
            def frozen_mask(p):
                return {k: jax.tree_util.tree_map(
                    lambda _: k == "src_embed", v) for k, v in p.items()}

            stages.append(optax.masked(optax.set_to_zero(), frozen_mask))
        stages += [optax.clip_by_global_norm(CLIP), optax.adam(learning_rate)]
        return optax.chain(*stages)

    return optax.inject_hyperparams(make)(LR)


def _random_tree(shapes, rng):
    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "embedding":
            return rng.normal(0, shape[-1] ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def init():
    enc, dec = jax_enc_dec(hidden_size=H, dropout=0.0)
    jmodel = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E,
                    src_embed=JaxDenseNet(JaxSpec(*SPEC), dtype=jnp.float32))
    src, tgt = _batches(1)[0][:2]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(src), jnp.asarray(tgt[:, :-1]))
    tree = _random_tree({"params": shapes["params"],
                         "batch_stats": shapes["batch_stats"]},
                        np.random.default_rng(4))
    return jmodel, tree


@pytest.fixture(scope="module", params=[False, True], ids=["train", "frozen"])
def jax_run(request, init):
    """(freeze, per-step losses, params, stats, opt_state) of three JAX
    steps."""
    freeze = request.param
    jmodel, tree = init
    opt = _jax_opt(freeze)
    step = jax_make_step(jmodel, opt, jax_masked_ce_loss)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])
    opt_state = opt.init(params)
    losses = []
    for i, b in enumerate(_batches()):
        params, stats, opt_state, loss = step(
            params, stats, opt_state, *map(jnp.asarray, b), np.uint32(i))
        losses.append(float(loss))
    return freeze, losses, *jax.device_get((params, stats, opt_state))


def _port_state(tree, freeze, dtype=torch.float32):
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=FEAT,
                                        embed_size=E, dropout=0.0)
    model = NMTModel(V, enc, dec, embed_size=E, hidden_size=H,
                     src_embed=DenseNet(DenseNetSpec(*SPEC), dtype=dtype))
    model.src_embed.to(dtype)
    load_flax(model, tree)
    return create_seq2seq_state(model, adam_with_clip(CLIP), LR, freeze)


def _port_run(tree, freeze, dtype=torch.float32):
    state = _port_state(tree, freeze, dtype)
    step = make_seq2seq_train_step(state, masked_ce_loss)
    losses = [step(torch.from_numpy(b[0]).to(dtype),
                   *map(torch.from_numpy, b[1:]), i).item()
              for i, b in enumerate(_batches())]
    return state, losses


def _rel_l2(got: dict, want: dict, skip=()):
    assert set(got) == set(want)
    keys = [k for k in want if k not in skip]
    num = sum(((got[k].double() - want[k].double()) ** 2).sum() for k in keys)
    den = sum((want[k].double() ** 2).sum() for k in keys)
    return float((num / den).sqrt())


def test_three_steps_match_jax(init, jax_run):
    _, tree = init
    freeze, want_losses, params, stats, opt_state = jax_run
    state, losses = _port_run(tree, freeze)
    np.testing.assert_allclose(losses, want_losses, rtol=TOL)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    want = from_flax({"params": params})
    assert _rel_l2(got, want, STEM) <= TOL
    before = from_flax({"params": tree["params"]})
    assert _rel_l2(before, want) > 100 * TOL
    if not freeze:
        exact, _ = _port_run(tree, freeze, torch.float64)
        for n, p in exact.model.named_parameters():
            if n in STEM:
                move = (p.detach() - before[n].double()).norm()
                assert (got[n].double() - p.detach()).norm() <= \
                    STEM_TOL * move, n
    got_stats = dict(state.model.named_buffers())
    want_stats = from_flax({"batch_stats": stats})
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), w.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
    adam = opt_state.inner_state[2 if freeze else 1][0]
    for key in ("mu", "nu"):
        want = from_flax({"params": getattr(adam, key)})
        assert _rel_l2(getattr(state.opt_state.inner, key), want,
                       STEM) <= TOL, key
    assert state.opt_state.inner.count == int(adam.count) == 3
    assert state.opt_state.count == int(opt_state.count) == 3


def test_frozen_backbone_is_unchanged_bit_for_bit(init):
    _, tree = init
    state, _ = _port_run(tree, True)
    before = from_flax(tree)
    names = [n for n, _ in state.model.named_parameters()
             if n.startswith("src_embed.")]
    assert names and set(state.trained).isdisjoint(names)
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[n]) == (n in names), n
    for n, buf in state.model.named_buffers():
        assert not torch.equal(buf, before[n]), n  # train-mode BN moved it
    for n in names:
        assert not state.opt_state.inner.mu[n].any()
        assert not state.opt_state.inner.nu[n].any()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_state_is_the_jax_drivers_file_layout(init, jax_run, tmp_path):
    """The port's state tree is the JAX driver's (keys, shapes, dtypes and
    values; ``{"0": mask, "1": clip, "2": adam}`` when frozen); the JAX
    package's file loads into the port's state and is written again byte
    for byte; the JAX package restores the port's file into its template."""
    jmodel, tree = init
    freeze, _, params, stats, opt_state = jax_run
    state, _ = _port_run(tree, freeze)
    flax_tree = state_to_flax(state)
    chain = flax_tree["opt_state"]["inner_state"]
    if freeze:
        assert sorted(chain) == ["0", "1", "2"]
        assert chain["0"] == {"inner_state": {}} and chain["1"] == {}
    else:
        assert sorted(chain) == ["0", "1"] and chain["0"] == {}
    want = serialization.to_state_dict(
        {"params": params, "batch_stats": stats, "opt_state": opt_state})
    got_leaves, want_leaves = dict(_leaves(flax_tree)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        g = got_leaves[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.ndim == 0:  # counts and the rate (the arrays: test above)
            np.testing.assert_allclose(g, w, rtol=1e-7, err_msg=str(k))

    path = str(tmp_path / "0002.params")
    jax_ckpt.save_state(path, {"params": params, "batch_stats": stats,
                               "opt_state": opt_state})
    fresh = _port_state(tree, freeze)
    state_from_flax(fresh, ckpt.load_raw(path))
    assert msgpack_codec.serialize(state_to_flax(fresh)) == \
        open(path, "rb").read()
    # a file of the other --freeze_backbone setting is refused
    with pytest.raises(KeyError, match="freeze_backbone"):
        state_from_flax(_port_state(tree, not freeze), ckpt.load_raw(path))

    ours = str(tmp_path / "port.params")
    ckpt.save_state(ours, state_to_flax(state))
    opt = _jax_opt(freeze)
    template = {"params": jax.tree_util.tree_map(jnp.asarray, tree["params"]),
                "batch_stats": jax.tree_util.tree_map(
                    jnp.asarray, tree["batch_stats"]),
                "opt_state": opt.init(tree["params"])}
    restored = jax_ckpt.load_state(ours, template)
    assert int(restored["opt_state"].count) == 3
    for (k, a), (_, b) in zip(_leaves(dict(restored["params"])),
                              _leaves(flax_tree["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
