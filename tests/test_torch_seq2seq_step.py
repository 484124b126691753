"""The captioner's train step and optimizer against the JAX package's on
the CPU, from the same JAX-initialised weights at dropout 0: the parameters
after 3 steps of Adam with global-norm clipping (the clip idle, and engaged
at ``--clip 0.01``) and of plain SGD within 1e-4 in relative L2 of the JAX
step's; a change of the injected learning rate between steps; and the
optimizer state in the layout of the JAX driver's files (the tree's keys,
shapes and dtypes, values, and a JAX-written file that reads back and is
written again byte for byte)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tennis_tpu.models.gnmt import NMTModel as JaxNMT
from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
from tennis_tpu.models.gnmt import masked_ce_loss as jax_masked_ce_loss
from tennis_tpu.parallel.train_step import \
    make_seq2seq_train_step as jax_make_step
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch.bridge import from_flax, load_flax, state_from_flax, \
    state_to_flax
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss
from tennis_torch.parallel.train_step import adam_with_clip, \
    create_seq2seq_state, make_seq2seq_train_step
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec

V, E, H, C, B, T, L = 14, 8, 16, 32, 4, 11, 9
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n=3):
    out = []
    for seed in range(n):
        rng = np.random.default_rng(10 + seed)
        src_vl = rng.integers(1, T + 1, B).astype(np.float32)
        tgt_vl = rng.integers(2, L + 1, B).astype(np.float32)
        src = rng.normal(size=(B, T, C)).astype(np.float32)
        src[np.arange(T)[None, :] >= src_vl[:, None]] = 0.0
        tgt = rng.integers(0, V, (B, L)).astype(np.int32)
        out.append((src, tgt, src_vl, tgt_vl))
    return out


@pytest.fixture(scope="module")
def init():
    enc, dec = jax_enc_dec(hidden_size=H, dropout=0.0)
    jmodel = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E)
    src, tgt = _batches(1)[0][:2]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                     jnp.asarray(tgt[:, :-1]))
    return jmodel, jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


def _jax_opt(clip, optimizer):
    def make(learning_rate):
        return optax.chain(optax.clip_by_global_norm(clip),
                           optax.adam(learning_rate) if optimizer == "adam"
                           else optax.sgd(learning_rate))

    return optax.inject_hyperparams(make)


def _jax_run(jmodel, params, lr, clip, optimizer, lrs=()):
    """Params and opt_state after a step per batch; ``lrs[i]``, when given,
    is set as the learning rate before step i."""
    opt = _jax_opt(clip, optimizer)(lr)
    step = jax_make_step(jmodel, opt, jax_masked_ce_loss)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = opt.init(params)
    stats = {}
    for i, batch in enumerate(_batches()):
        if i < len(lrs):
            opt_state.hyperparams["learning_rate"] = jnp.asarray(lrs[i])
        params, stats, opt_state, _ = step(
            params, stats, opt_state, *map(jnp.asarray, batch), np.uint32(i))
    return jax.device_get(params), jax.device_get(opt_state)


def _port_state(params, lr, clip, optimizer):
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                        embed_size=E, dropout=0.0)
    model = load_flax(NMTModel(V, enc, dec, embed_size=E, hidden_size=H),
                      {"params": params})
    return create_seq2seq_state(model, adam_with_clip(clip, optimizer), lr)


def _port_run(params, lr, clip, optimizer, lrs=()):
    state = _port_state(params, lr, clip, optimizer)
    step = make_seq2seq_train_step(state, masked_ce_loss)
    for i, batch in enumerate(_batches()):
        if i < len(lrs):
            state.opt_state.learning_rate = lrs[i]
        step(*map(torch.from_numpy, batch), i)
    return state


def _rel(state, jax_params):
    want = from_flax({"params": jax_params})
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    num = sum(((got[k].detach() - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    return (num / den).sqrt().item(), max(
        ((got[k].detach() - want[k]).norm() / want[k].norm()).item()
        for k in want)


def _grad_norm(jmodel, params, batch):
    src, tgt, src_vl, tgt_vl = map(jnp.asarray, batch)
    g = jax.grad(lambda p: jax_masked_ce_loss(
        jmodel.apply({"params": p}, src, tgt[:, :-1], src_vl, tgt_vl - 1),
        tgt[:, 1:], tgt_vl - 1))(params)
    return float(optax.global_norm(g))


@pytest.mark.parametrize("optimizer,clip", [
    ("adam", 5.0), ("adam", 0.01), ("sgd", 5.0), ("sgd", 0.01)])
def test_three_steps_match_jax(init, optimizer, clip):
    jmodel, params = init
    norm = _grad_norm(jmodel, params, _batches(1)[0])
    # the clip is idle at 5 and engaged at 0.01 for this model and batch
    assert (norm < clip) == (clip == 5.0)
    # rates at which 3 steps move the weights by well over the tolerance
    lr = 1e-2 if optimizer == "adam" else 2.0 if clip == 5.0 else 20.0
    want, want_opt = _jax_run(jmodel, params, lr, clip, optimizer)
    state = _port_run(params, lr, clip, optimizer)
    total, worst = _rel(state, want)
    moved, _ = _rel(_port_state(params, lr, clip, optimizer), want)
    assert moved > 100 * PARAM_TOL  # the steps moved the weights
    assert total <= PARAM_TOL and worst <= 10 * PARAM_TOL
    assert state.opt_state.count == int(want_opt.count) == 3


def test_injected_learning_rate_change_takes_effect(init):
    jmodel, params = init
    lrs = (1e-2, 0.0, 3e-2)
    want, _ = _jax_run(jmodel, params, 1e-2, 5.0, "adam", lrs)
    state = _port_run(params, 1e-2, 5.0, "adam", lrs)
    assert _rel(state, want)[0] <= PARAM_TOL
    # the same run at an unchanged rate ends elsewhere
    fixed = _port_run(params, 1e-2, 5.0, "adam")
    assert _rel(fixed, want)[0] > 100 * PARAM_TOL


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_state_to_flax_is_the_jax_driver_tree(init, optimizer):
    jmodel, params = init
    lrs = (1e-2, 1e-2, 2.5e-3)
    want_params, want_opt = _jax_run(jmodel, params, 1e-2, 5.0, optimizer,
                                     lrs)
    state = _port_run(params, 1e-2, 5.0, optimizer, lrs)
    tree = state_to_flax(state)
    assert list(tree) == ["batch_stats", "opt_state", "params"]
    assert tree["batch_stats"] == {}
    want = serialization.to_state_dict(want_opt)
    got_leaves = dict(_leaves(tree["opt_state"]))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        g = got_leaves[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=str(k))
    assert float(tree["opt_state"]["hyperparams"]["learning_rate"]) == \
        np.float32(2.5e-3)
    # the empty nodes of the chain are there, as flax writes them
    assert tree["opt_state"]["inner_state"]["0"] == {}
    assert tree["opt_state"]["inner_state"]["1"]["1"] == {}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_jax_file_round_trips_byte_for_byte(init, tmp_path, optimizer):
    """A file the JAX driver's code writes (``checkpoint.save_state`` of
    ``{"params", "batch_stats", "opt_state"}``) loads into the port's state
    and is written again byte for byte; the JAX package restores the
    port's own file into its template."""
    jmodel, params = init
    lrs = (1e-2, 1e-2, 5e-3)
    want_params, want_opt = _jax_run(jmodel, params, 1e-2, 5.0, optimizer,
                                     lrs)
    path = str(tmp_path / "0002.params")
    jax_ckpt.save_state(path, {"params": want_params, "batch_stats": {},
                               "opt_state": want_opt})
    state = _port_state(params, 1e-2, 5.0, optimizer)
    state_from_flax(state, ckpt.load_raw(path))
    assert state.opt_state.learning_rate == float(np.float32(5e-3))
    assert state.opt_state.count == 3
    data = open(path, "rb").read()
    assert msgpack_codec.serialize(state_to_flax(state)) == data

    ours = str(tmp_path / "port.params")
    ckpt.save_state(ours, state_to_flax(state))
    opt = _jax_opt(5.0, optimizer)(1e-2)
    template = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                "batch_stats": {}, "opt_state": opt.init(params)}
    restored = jax_ckpt.load_state(ours, template)
    assert float(restored["opt_state"].hyperparams["learning_rate"]) == \
        np.float32(5e-3)
    assert int(restored["opt_state"].count) == 3
    for (k, a), (_, b) in zip(_leaves(dict(restored["params"])),
                              _leaves(want_params)):
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_state_from_flax_refuses_the_other_optimizer(init, tmp_path):
    jmodel, params = init
    _, adam_opt = _jax_run(jmodel, params, 1e-2, 5.0, "adam", ())
    tree = serialization.to_state_dict(
        {"params": params, "batch_stats": {}, "opt_state": adam_opt})
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = _port_state(params, 1e-2, 5.0, "sgd")
    with pytest.raises(ValueError, match="other --optimizer"):
        state_from_flax(state, tree)
    with pytest.raises(KeyError):
        state_from_flax(state, {"params": params, "opt_state": {}})
