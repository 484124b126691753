"""The port's GRU recurrence, RNN layers and masking against the JAX package
on the CPU: the recurrence against the Pallas kernel in interpret mode, the
layers against the JAX modules at the same weights (carried by the bridge)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.ops import masking as jax_masking
from tennis_tpu.ops import rnn as jax_rnn
from tennis_tpu.ops.pallas.gru import gru_recurrence_pallas
from tennis_torch.bridge import load_flax
from tennis_torch.ops import gru, masking, rnn

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lengths(T, B):
    """Valid lengths mixing 0, 1, a middle value and T."""
    return np.asarray([(0, 1, T // 2, T)[i % 4] for i in range(B)], np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("T,B,H", [(5, 8, 8), (3, 4, 4), (1, 4, 4), (7, 3, 16)])
def test_recurrence_matches_pallas(T, B, H):
    rng = np.random.default_rng(T * 100 + B * 10 + H)
    gx = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wh = (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bh = rng.normal(size=(3 * H,)).astype(np.float32) * 0.1
    vl = _lengths(T, B)
    ys_j, h_j = gru_recurrence_pallas(jnp.asarray(gx), jnp.asarray(h0),
                                      jnp.asarray(wh), jnp.asarray(bh),
                                      jnp.asarray(vl), interpret=True)
    args = [torch.from_numpy(a) for a in (gx, h0, wh, bh, vl)]
    for fn in (gru.gru_recurrence_reference, gru.gru_recurrence):
        ys, h = fn(*args)
        assert ys.shape == (T, B, H) and h.shape == (B, H)
        _close(ys, ys_j)
        _close(h, h_j)
    # valid_length omitted means every row runs all T steps
    ys_full, _ = gru.gru_recurrence(*args[:4])
    ys_jf, _ = gru_recurrence_pallas(jnp.asarray(gx), jnp.asarray(h0),
                                     jnp.asarray(wh), jnp.asarray(bh),
                                     interpret=True)
    _close(ys_full, ys_jf)


def test_gru_sequence_and_budget():
    rng = np.random.default_rng(0)
    T, B, C, H = 4, 3, 6, 8
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    h0 = np.zeros((B, H), np.float32)
    wx = rng.normal(size=(C, 3 * H)).astype(np.float32) * 0.3
    wh = rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.3
    bx = rng.normal(size=(3 * H,)).astype(np.float32) * 0.1
    bh = rng.normal(size=(3 * H,)).astype(np.float32) * 0.1
    from tennis_tpu.ops.pallas.gru import gru_sequence_pallas

    ys_j, h_j = gru_sequence_pallas(*map(jnp.asarray, (x, h0, wx, wh, bx, bh)),
                                    interpret=True)
    ys, h = gru.gru_sequence(*map(torch.from_numpy, (x, h0, wx, wh, bx, bh)))
    _close(ys, ys_j)
    _close(h, h_j)
    # the H100 budget: every H from 1 to 1023 (the general kernel past 512
    # and at the non-multiples of 8), none from 1024
    assert gru.gru_fits_smem(128, 4, 256) and gru.gru_fits_smem(128, 32, 128)
    assert gru.gru_fits_smem(128, 4, 512)
    assert gru.gru_fits_smem(128, 4, 520)
    assert not gru.gru_fits_smem(128, 4, 1024)
    assert gru.gru_fits_smem(5, 4, 12)


def _jax_layer(module, x, vl, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                         None if vl is None else jnp.asarray(vl))
    out = module.apply(params, jnp.asarray(x),
                       None if vl is None else jnp.asarray(vl))
    tree = jax.tree_util.tree_map(np.asarray, {"params": dict(params["params"])})
    return tree, out


def _port(module, tree, x, vl):
    load_flax(module, tree)
    return module(torch.from_numpy(x),
                  None if vl is None else torch.from_numpy(vl))


def _close_tree(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w)
    else:
        _close(got.detach(), want)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_rnn_layer_matches_jax(cell, reverse, masked):
    """Forward and reverse layers, with and without valid_length; the LSTM
    case holds the forget bias of +1.0 added at run time."""
    rng = np.random.default_rng(1)
    B, T, C, H = 4, 6, 5, 8
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    vl = np.asarray([6, 3, 1, 0], np.int32) if masked else None
    tree, (final_j, ys_j) = _jax_layer(
        jax_rnn.RNNLayer(cell, H, reverse=reverse), x, vl)
    final, ys = _port(rnn.RNNLayer(cell, C, H, reverse=reverse), tree, x, vl)
    _close(ys.detach(), ys_j)
    _close_tree(final, final_j)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_birnn_and_stacked_match_jax(cell):
    rng = np.random.default_rng(2)
    B, T, C, H = 3, 7, 6, 8
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    vl = np.asarray([7, 4, 2], np.int32)
    tree, (finals_j, out_j) = _jax_layer(jax_rnn.BiRNN(cell, H), x, vl)
    finals, out = _port(rnn.BiRNN(cell, C, H), tree, x, vl)
    _close(out.detach(), out_j)
    _close_tree(finals, finals_j)
    for bidirectional in (True, False):
        tree, out_j = _jax_layer(
            jax_rnn.StackedRNN(cell, H, num_layers=2,
                               bidirectional=bidirectional), x, vl, seed=3)
        out = _port(rnn.StackedRNN(cell, C, H, num_layers=2,
                                   bidirectional=bidirectional), tree, x, vl)
        _close(out.detach(), out_j)


def test_cells_match_jax():
    rng = np.random.default_rng(4)
    B, C, H = 3, 5, 6
    x = rng.normal(size=(B, C)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    for cell, carry in (("gru", h), ("lstm", (h, c))):
        jcell = jax_rnn.make_cell(cell, H)
        jcarry = jax.tree_util.tree_map(jnp.asarray, carry)
        params = jcell.init(jax.random.PRNGKey(0), jcarry, jnp.asarray(x))
        want = jcell.apply(params, jcarry, jnp.asarray(x))
        port = rnn.make_cell(cell, C, H)
        load_flax(port, jax.tree_util.tree_map(
            np.asarray, {"params": dict(params["params"])}))
        got = port(jax.tree_util.tree_map(torch.from_numpy, carry),
                   torch.from_numpy(x))
        _close_tree(got, want)
    with pytest.raises(ValueError):
        rnn.make_cell("rnn", C, H)


@pytest.mark.parametrize("axis,shape", [(1, (3, 6, 2)), (1, (3, 5)),
                                        (2, (3, 2, 6))])
def test_masking_matches_jax(axis, shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    vl = np.asarray([shape[axis], 2, 0], np.int32)
    xt, vlt = torch.from_numpy(x), torch.from_numpy(vl)
    for fn_t, fn_j in ((masking.sequence_mask, jax_masking.sequence_mask),
                       (masking.reverse_sequence, jax_masking.reverse_sequence)):
        np.testing.assert_array_equal(
            fn_t(xt, vlt, axis=axis).numpy(),
            np.asarray(fn_j(jnp.asarray(x), jnp.asarray(vl), axis=axis)))
    np.testing.assert_array_equal(
        masking.reverse_sequence(xt, None, axis=axis).numpy(),
        np.asarray(jax_masking.reverse_sequence(jnp.asarray(x), None,
                                                axis=axis)))
    assert masking.sequence_mask(xt, None) is xt
    np.testing.assert_array_equal(
        masking.sequence_mask(xt, vlt, axis=axis, value=-1.0).numpy(),
        np.asarray(jax_masking.sequence_mask(jnp.asarray(x), jnp.asarray(vl),
                                             axis=axis, value=-1.0)))
