"""The captioner in train mode against the JAX package on the CPU: a small
``NMTModel`` initialised by JAX and carried over by the bridge, at dropout
0. Logits within 1e-5 relative, ``masked_ce_loss`` within 1e-6 in every
mode, and the gradient of every parameter within 1e-4 in relative L2 of
``jax.grad``'s. Then the port's dropout (the keep share, the 1/(1-p)
scale, masks reproducible from the generator) and the GRU decode context
(the kernel's plain version inside it on the CPU, gradients only outside
it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models.gnmt import NMTModel as JaxNMT
from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
from tennis_tpu.models.gnmt import masked_ce_loss as jax_masked_ce_loss
from tennis_torch.bridge import from_flax, load_flax
from tennis_torch.models.gnmt import NMTModel, dropout, \
    get_gnmt_encoder_decoder, masked_ce_loss
from tennis_torch.ops import gru, rnn

V, E, H, C, B, T, L = 14, 8, 16, 32, 4, 11, 9
LOGIT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src_vl = np.asarray([T, 7, 3, 1], np.float32)
    tgt_vl = np.asarray([L, 6, 4, 2], np.float32)
    src = rng.normal(size=(B, T, C)).astype(np.float32)
    src[np.arange(T)[None, :] >= src_vl[:, None]] = 0.0
    tgt = rng.integers(0, V, (B, L)).astype(np.int32)
    tgt[np.arange(L)[None, :] >= tgt_vl[:, None]] = 1  # <pad>
    return src, tgt, src_vl, tgt_vl


@pytest.fixture(scope="module", params=["gru", "lstm"])
def models(request):
    cell = request.param
    enc, dec = jax_enc_dec(cell_type=cell, hidden_size=H, dropout=0.0)
    jmodel = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E)
    src, tgt, _, _ = _batch()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                     jnp.asarray(tgt[:, :-1]))
    rng = np.random.default_rng(1)
    # non-zero biases, so a dropped or misplaced bias gradient would show
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        if str(p[-1].key) == "bias" else np.asarray(v),
        dict(variables["params"]))
    penc, pdec = get_gnmt_encoder_decoder(cell_type=cell, hidden_size=H,
                                          input_size=C, embed_size=E,
                                          dropout=0.0)
    model = NMTModel(V, penc, pdec, embed_size=E, hidden_size=H)
    load_flax(model, {"params": params})
    return jmodel, params, model.train(), cell


def _jax_loss(jmodel, params, batch):
    src, tgt, src_vl, tgt_vl = map(jnp.asarray, batch)

    def loss(p):
        logits = jmodel.apply({"params": p}, src, tgt[:, :-1], src_vl,
                              tgt_vl - 1, train=True,
                              rngs={"dropout": jax.random.PRNGKey(3)})
        return jax_masked_ce_loss(logits, tgt[:, 1:], tgt_vl - 1), logits

    return jax.value_and_grad(loss, has_aux=True)(params)


def _port_loss(model, batch):
    src, tgt, src_vl, tgt_vl = map(torch.from_numpy, batch)
    logits = model(src, tgt[:, :-1], src_vl, tgt_vl - 1)
    loss = masked_ce_loss(logits, tgt[:, 1:], tgt_vl - 1)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, logits, dict(zip(names, grads))


def test_train_mode_logits_loss_and_grads_match_jax(models):
    jmodel, params, model, _ = models
    batch = _batch(2)
    (loss_j, logits_j), grads_j = _jax_loss(jmodel, params, batch)
    loss_t, logits_t, grads_t = _port_loss(model, batch)
    logits_j = np.asarray(logits_j)
    rel = np.abs(logits_t.detach().numpy() - logits_j).max() / \
        np.abs(logits_j).max()
    assert rel <= LOGIT_TOL
    assert abs(loss_t.item() - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    assert set(want) == set(grads_t)
    for name, g in grads_t.items():
        w = want[name]
        assert g.shape == w.shape, name
        denom = max(w.norm().item(), 1e-12)
        assert (g - w).norm().item() / denom <= GRAD_TOL, name


def test_train_mode_without_dropout_equals_eval_mode(models):
    _, _, model, _ = models
    src, tgt, src_vl, tgt_vl = map(torch.from_numpy, _batch(4))
    with torch.no_grad():
        a = model.train()(src, tgt[:, :-1], src_vl, tgt_vl - 1)
        b = model.eval()(src, tgt[:, :-1], src_vl, tgt_vl - 1)
    model.train()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("average", ["padded", "valid"])
@pytest.mark.parametrize("weights", [None, "ones", "mask"])
def test_masked_ce_loss_matches_jax(average, weights):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(5, 8, 13)) * 3).astype(np.float32)
    labels = rng.integers(0, 13, (5, 8)).astype(np.int32)
    vl = np.asarray([8, 5, 0, 3, 1], np.float32)
    w = {None: None, "ones": np.ones(5, np.float32),
         "mask": np.asarray([1, 1, 0, 1, 0], np.float32)}[weights]
    want = float(jax_masked_ce_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(vl), average,
        None if w is None else jnp.asarray(w)))
    got = masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(vl), average,
                         None if w is None else torch.from_numpy(w)).item()
    assert abs(got - want) <= LOSS_TOL * max(abs(want), 1.0)


def test_dropout_keep_share_scale_and_generator():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(5)
    y = dropout(x, 0.2, True, g)
    kept = y != 0
    assert 0.79 <= kept.float().mean().item() <= 0.81
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    again = dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)
    other = dropout(x, 0.2, True, torch.Generator().manual_seed(6))
    assert not torch.equal(y, other)
    assert dropout(x, 0.2, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, True, None)


def test_model_dropout_is_drawn_from_the_forward_generator(models):
    """A train-mode forward at dropout 0.5: masks from the generator it is
    given (the same seed, the same logits; another seed, others), the
    identity in eval mode, and a refusal without a generator."""
    _, params, base, cell = models
    enc, dec = get_gnmt_encoder_decoder(cell_type=cell, hidden_size=H,
                                        input_size=C, embed_size=E,
                                        dropout=0.5)
    model = load_flax(NMTModel(V, enc, dec, embed_size=E, hidden_size=H),
                      {"params": params}).train()
    src, tgt, src_vl, tgt_vl = map(torch.from_numpy, _batch(5))
    args = (src, tgt[:, :-1], src_vl, tgt_vl - 1)
    with torch.no_grad():
        a = model(*args, generator=torch.Generator().manual_seed(1))
        b = model(*args, generator=torch.Generator().manual_seed(1))
        c = model(*args, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            model(*args)
        model.eval()
        d = model(*args)
        e = base.eval()(*args)
    base.train()
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(d, e, rtol=0, atol=0)


def _layer_and_input():
    layer = rnn.RNNLayer("gru", C, H, reverse=True,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(1))
    return layer, x, torch.tensor([T, 7, 3, 0])


def test_decode_context_runs_the_plain_version_on_the_cpu(monkeypatch):
    layer, x, vl = _layer_and_input()
    calls = []
    monkeypatch.setattr(rnn, "gru_recurrence", lambda *a: calls.append(1)
                        or gru.gru_recurrence(*a))
    launches = gru.gru_recurrence.launches
    with torch.no_grad():
        outside = layer(x, vl)
        assert calls == []  # the differentiable recurrence, not the wrapper
        with rnn.gru_decode():
            inside = layer(x, vl)
        assert calls == [1]
    assert gru.gru_recurrence.launches == launches  # no kernel on the CPU
    for a, b in zip(outside, inside):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_gradients_flow_only_outside_the_decode_context():
    layer, x, vl = _layer_and_input()
    final, ys = layer(x, vl)
    (ys.sum() + final.sum()).backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in layer.parameters())
    with rnn.gru_decode():
        with pytest.raises(RuntimeError, match="forward-only"):
            layer(x, vl)
        with torch.no_grad():
            layer(x, vl)
    # the context is off again, and nests back to its previous value
    with rnn.gru_decode():
        with rnn.gru_decode(False):
            layer(x, vl)[1].sum().backward()
    layer(x, vl)[1].sum().backward()


def test_lstm_layers_ignore_the_decode_context():
    layer = rnn.RNNLayer("lstm", C, H,
                         generator=torch.Generator().manual_seed(0))
    _, x, vl = _layer_and_input()
    (h, c), ys = layer(x, vl)
    with rnn.gru_decode():
        (h2, c2), ys2 = layer(x, vl)
        ys2.sum().backward()
    torch.testing.assert_close(ys, ys2, rtol=0, atol=0)
