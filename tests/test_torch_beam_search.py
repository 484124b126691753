"""The port's beam search and translator against the JAX package on the
CPU: the same deterministic decode step in both frameworks, brute-force
optimality when the beam holds every prefix, and ``BeamSearchTranslator`` on
a small ``NMTModel`` carried over by the bridge."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.ops.beam_search import beam_search as jax_beam_search
from tennis_torch.ops.beam_search import beam_search

V, EOS, BOS, HIDDEN = 5, 4, 0, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decoders(seed=0, eos_boost=0.0):
    """A tiny deterministic decoder (state = running embedding sum, logits
    = tanh(state) @ W), built from the same numpy draws in both frameworks;
    ``eos_boost`` raises the EOS logit so every beam can finish early."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(V, HIDDEN)).astype(np.float32)
    w = rng.normal(size=(HIDDEN, V)).astype(np.float32)
    boost = np.zeros(V, np.float32)
    boost[EOS] = eos_boost
    emb_j, w_j, boost_j = map(jnp.asarray, (emb, w, boost))
    emb_t, w_t, boost_t = map(torch.from_numpy, (emb, w, boost))

    def step_j(tokens, state):
        state = state + emb_j[tokens]
        return jnp.tanh(state) @ w_j + boost_j, state

    def step_t(tokens, state):
        state = state + emb_t[tokens.long()]
        return torch.tanh(state) @ w_t + boost_t, state

    return step_j, step_t


@pytest.mark.parametrize("beam,alpha,K,max_length,batch,eos_boost", [
    (4, 1.0, 5, 6, 3, 0.0), (3, 0.6, 2, 5, 2, 0.0), (1, 1.0, 5, 4, 2, 0.0),
    (5, 0.0, 5, 7, 1, 0.0), (6, 1.0, 5, 9, 2, 0.0),
    (3, 1.0, 5, 12, 2, 3.0),  # every beam finishes before max_length
])
def test_beam_search_matches_jax(beam, alpha, K, max_length, batch,
                                 eos_boost):
    step_j, step_t = _decoders(seed=beam + max_length, eos_boost=eos_boost)
    init = np.random.default_rng(batch).normal(
        size=(batch, HIDDEN)).astype(np.float32)
    want = jax.jit(lambda s: jax_beam_search(
        step_j, s, batch, beam, BOS, EOS, max_length, alpha, K))(
            jnp.asarray(init))
    calls = []

    def counting_step(tokens, state):
        calls.append(1)
        return step_t(tokens, state)

    samples, scores, vl = beam_search(counting_step, torch.from_numpy(init),
                                      batch, beam, BOS, EOS, max_length,
                                      alpha, K)
    np.testing.assert_array_equal(samples.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    assert samples.dtype == vl.dtype == torch.int32
    if eos_boost:  # the loop exits as soon as every beam has finished
        assert len(calls) < max_length
        assert (vl.numpy() < max_length + 2).all()
    else:
        assert len(calls) <= max_length


def _brute_force(step_t, max_length, alpha, K):
    """Best (score, tokens-with-BOS-and-EOS) over every hypothesis that ends
    at EOS or at the step budget."""
    best = (-np.inf, None)
    for length in range(1, max_length + 1):
        for seq in itertools.product(range(V), repeat=length):
            if EOS in seq[:-1] or (seq[-1] != EOS and length < max_length):
                continue
            tokens = [BOS] + list(seq)
            state = torch.zeros(1, HIDDEN)
            cum = 0.0
            for t in range(length):
                logits, state = step_t(torch.tensor([tokens[t]]), state)
                cum += float(torch.log_softmax(logits, -1)[0, tokens[t + 1]])
            score = cum / ((K + length) / (K + 1)) ** alpha
            if score > best[0]:
                best = (score, tokens)
    return best


@pytest.mark.parametrize("seed,alpha", [(3, 1.0), (4, 0.5)])
def test_exhaustive_beam_matches_brute_force(seed, alpha):
    """A beam of V**3 holds every prefix up to length 3: the search is
    exhaustive and must find the best hypothesis."""
    _, step_t = _decoders(seed=seed)
    max_length, K = 3, 5
    samples, scores, vl = beam_search(step_t, torch.zeros(1, HIDDEN), 1,
                                      V ** 3, BOS, EOS, max_length, alpha, K)
    bf_score, bf_tokens = _brute_force(step_t, max_length, alpha, K)
    assert float(scores[0, 0]) == pytest.approx(bf_score, rel=1e-5)
    expect = bf_tokens if bf_tokens[-1] == EOS else bf_tokens + [EOS]
    np.testing.assert_array_equal(samples[0, 0, :int(vl[0, 0])].numpy(),
                                  expect)
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()


def test_translator_matches_jax():
    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
    from tennis_tpu.translation import BeamSearchTranslator as JaxTranslator
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder
    from tennis_torch.translation import BeamSearchTranslator

    Vv, E, H, C, B, T = 12, 8, 16, 10, 3, 6
    enc, dec = jax_enc_dec(hidden_size=H)
    jmodel = JaxNMT(vocab_size=Vv, encoder=enc, decoder=dec, embed_size=E)
    rng = np.random.default_rng(5)
    src = rng.normal(size=(B, T, C)).astype(np.float32)
    vl = np.asarray([6, 3, 1], np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(src),
                                     jnp.zeros((B, 2), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray,
                                  {"params": dict(variables["params"])})
    penc, pdec = get_gnmt_encoder_decoder(hidden_size=H, input_size=C,
                                          embed_size=E)
    model = load_flax(NMTModel(Vv, penc, pdec, embed_size=E, hidden_size=H),
                      tree).eval()
    kw = dict(bos_id=2, eos_id=3, beam_size=4, alpha=1.0, K=5, max_length=8)
    want = JaxTranslator(jmodel, **kw).translate(tree, src, vl)
    translator = BeamSearchTranslator(model, **kw)
    got = translator.translate(src, vl)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-5)

    class Tokens:  # vocab stand-in: ids as strings
        def to_tokens(self, ids):
            return [str(int(i)) for i in ids]

    toks = translator.translate_tokens(src, vl, Tokens())
    for b in range(B):
        n = int(got[2][b, 0])
        assert toks[b] == [str(int(i)) for i in got[0][b, 0, 1:n - 1]]


@pytest.mark.parametrize("beam,alpha,K,max_length,batch,eos_boost", [
    (4, 1.0, 5, 6, 3, 0.0),
    (3, 1.0, 5, 12, 2, 3.0),  # every beam finishes before max_length
])
def test_while_loop_form_equals_the_python_loop(beam, alpha, K, max_length,
                                                batch, eos_boost):
    """``beam_search_loop`` (one ``while_loop``, the exported form) gives the
    Python loop's samples, scores and lengths bit for bit, over a state
    tree with a tuple, a dict, a 0-dim tensor and a None."""
    from tennis_torch.ops.beam_search import beam_search_loop

    _, step_t = _decoders(seed=beam + max_length, eos_boost=eos_boost)
    init = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, HIDDEN)).astype(np.float32))
    scale = torch.tensor(0.5)

    def step(tokens, states):
        (state, extra), rest = states
        logits, state = step_t(tokens, state)
        return logits + rest["bias"] * scale, \
            ((state, extra), {"bias": rest["bias"], "none": None})

    states = ((init, scale), {"bias": torch.zeros(batch, V) + 0.1,
                              "none": None})
    want = beam_search(step, states, batch, beam, BOS, EOS, max_length,
                       alpha, K)
    got = beam_search_loop(step, states, batch, beam, BOS, EOS, max_length,
                           alpha, K)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
