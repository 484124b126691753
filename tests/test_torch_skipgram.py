"""SkipGram and its trainer against the JAX package on the CPU: fastText
hashes, subword and alias tables equal; the (center, context) pairs the
trainers take (the native library's) and the numpy fallback's equal; the pair loss, its gradients and one AdaGrad step from the same
parameters and the same negatives (drawn by the JAX sampler and handed to
both) within 1e-6; ``token_vectors`` equal; the trainer's flags those of
the JAX trainer; and ``python -m tennis_torch.train_embeddings`` on the
synthetic fixture writes the embedding file in the JAX driver's format,
which the port's and the JAX package's ``load_embeddings`` read to the same
array (the captioner's ``tgt_embed``)."""
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import build_fixture
from tennis_tpu.models import skipgram as jsg
from tennis_tpu import native as jax_native
from tennis_torch import native, train_embeddings
from tennis_torch.models import skipgram as tsg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["hits", "serve", "the", "ball", "net", "a", "returns", "ace",
         "über", "x", "forehand", "backhand"]
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_hashes_and_tables_equal():
    for w in WORDS:
        assert tsg.fasttext_hash(w) == jsg.fasttext_hash(w)
        assert tsg.word_ngram_hashes(w, (3, 4, 5, 6), 100) == \
            jsg.word_ngram_hashes(w, (3, 4, 5, 6), 100)
    for got, want in zip(tsg.build_subword_table(WORDS),
                         jsg.build_subword_table(WORDS)):
        np.testing.assert_array_equal(got, want)
    counts = np.random.default_rng(0).integers(1, 200, 57)
    for got, want in zip(tsg.build_alias_table(counts),
                         jsg.build_alias_table(counts)):
        np.testing.assert_array_equal(got, want)


def test_alias_sampler_follows_the_unigram_distribution():
    counts = np.asarray([50, 20, 10, 5, 1, 1, 100])
    prob, alias = (torch.from_numpy(a) for a in tsg.build_alias_table(counts))
    draws = tsg.alias_sample(torch.Generator().manual_seed(0), prob, alias,
                             (200_000,))
    want = counts ** 0.75 / (counts ** 0.75).sum()
    got = np.bincount(draws.numpy(), minlength=len(counts)) / draws.numel()
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_center_context_pairs_equal():
    """The pairs both trainers take (each package's native library, built
    here) are equal, and so are the numpy fallbacks' (ROADMAP departure 6,
    closed)."""
    assert native.HAVE_NATIVE and jax_native.HAVE_NATIVE
    rng = np.random.default_rng(1)
    sents = [list(rng.integers(0, 40, rng.integers(1, 15))) for _ in range(30)]
    for window, seed in ((3, 1), (1, 7), (5, 2)):
        for got, want in zip(native.center_context_pairs(sents, window, seed),
                             jax_native.center_context_pairs(sents, window,
                                                             seed)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(
                native._center_context_pairs_np(sents, window, seed),
                jax_native._center_context_pairs_np(sents, window, seed)):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def models():
    counts = np.random.default_rng(2).integers(1, 60, len(WORDS))
    kw = dict(vocab_size=len(WORDS), num_buckets=100, emb_size=16,
              counts=counts, num_negatives=5, idx_to_token=WORDS)
    jmodel, tmodel = jsg.SkipGram(**kw), tsg.SkipGram(**kw)
    rng = np.random.default_rng(3)
    params = {"embedding": rng.uniform(-0.5, 0.5, (jmodel.num_units, 16)),
              "embedding_out": rng.normal(0, 0.3, (len(WORDS), 16))}
    return jmodel, tmodel, {k: v.astype(np.float32) for k, v in params.items()}


def _batch(jmodel, seed=4, B=64):
    rng = np.random.default_rng(seed)
    center = rng.integers(0, len(WORDS), B)
    context = rng.integers(0, len(WORDS), B)
    key = jax.random.PRNGKey(seed)
    # the negatives the JAX loss draws from this key, handed to the port
    negatives = np.array(jsg.alias_sample(
        key, jmodel.alias_prob, jmodel.alias_alias, (B, jmodel.num_negatives)))
    return center, context, key, negatives


def test_loss_gradients_and_one_adagrad_step_match_jax(models):
    jmodel, tmodel, params = models
    center, context, key, negatives = _batch(jmodel)
    assert (negatives == center[:, None]).any()  # the mask matters
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        return jmodel.loss(p, jnp.asarray(center), jnp.asarray(context),
                           key).mean()

    tx = optax.adagrad(0.05)
    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    updates, _ = tx.update(want_grads, tx.init(jparams))
    want_params = optax.apply_updates(jparams, updates)
    per_pair = jmodel.loss(jparams, jnp.asarray(center), jnp.asarray(context),
                           key)

    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t = (torch.from_numpy(center), torch.from_numpy(context),
         torch.from_numpy(negatives).long())
    got_pairs = tmodel.loss(tparams, *t)
    np.testing.assert_allclose(got_pairs.numpy(), np.asarray(per_pair),
                               rtol=TOL, atol=TOL)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    grads = torch.autograd.grad(tmodel.loss(leaves, *t).mean(),
                                list(leaves.values()))
    for (k, g) in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    step = train_embeddings.make_step(
        tmodel, tparams, train_embeddings.adagrad_init(tparams), 0.05)
    loss = step(*t)
    assert abs(loss.item() - float(want_loss)) <= TOL
    for k, v in tparams.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_params[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
        assert not np.array_equal(v.numpy(), params[k])  # the step moved it


def test_token_vectors_equal(models):
    jmodel, tmodel, params = models
    want = np.asarray(jmodel.token_vectors(
        jax.tree_util.tree_map(jnp.asarray, params)))
    got = tmodel.token_vectors({k: torch.from_numpy(v)
                                for k, v in params.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_flags_are_the_jax_trainers():
    from absl import flags as absl_flags

    from tennis_tpu.train_embeddings import FLAGS

    args = train_embeddings.parse_args([])
    names = {n for n in FLAGS if not isinstance(FLAGS[n], absl_flags.Flag)
             or FLAGS[n].name == n}
    assert names == set(vars(args)) - {"device"}
    for name in names:
        assert getattr(args, name) == FLAGS[name].default, name
    assert train_embeddings.parse_args(["--noadd_extra"]).add_extra is False
    assert train_embeddings.parse_args(["--overwrite"]).overwrite is True


def test_vocab_and_corpus_are_the_jax_drivers(tmp_path):
    from tennis_tpu import train_embeddings as jte

    root = build_fixture(str(tmp_path / "ds"))
    got = train_embeddings.load_corpus(root, True)
    assert got == jte.load_corpus(root, True)
    counter = Counter(t for s in got for t in s)
    a, b = train_embeddings.EmbeddingVocab(counter), jte.EmbeddingVocab(counter)
    assert a.idx_to_token == b.idx_to_token
    assert a.idx_to_counts == b.idx_to_counts
    vecs = np.random.default_rng(5).normal(size=(len(a), 8))
    word = a.idx_to_token[0]
    assert train_embeddings.k_closest_tokens(a, vecs, word, 3) == \
        jte.k_closest_tokens(b, vecs, word, 3)


def test_driver_writes_the_embedding_file_both_packages_read(tmp_path):
    from tennis_tpu.data.vocab import load_embeddings as jax_load
    from tennis_torch.data.tennis_set import TennisSet
    from tennis_torch.data.vocab import load_embeddings

    root = build_fixture(str(tmp_path / "ds"))
    out = subprocess.run(
        [sys.executable, "-m", "tennis_torch.train_embeddings",
         f"--root={root}", "--device=cpu", "--emb_size=12", "--epochs=2",
         "--batch_size=4", "--log_interval=2", "--notsne"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO,
                                    OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in ("# sentences:", "epoch 1:", "epoch 2, iter 2, loss",
                 "wrote"):
        assert line in out.stderr, line
    path = os.path.join(root, "embeddings-ex.txt")
    sentences = train_embeddings.load_corpus(root, True)
    vocab = train_embeddings.EmbeddingVocab(
        Counter(t for s in sentences for t in s))
    lines = open(path, encoding="utf-8").read().splitlines()
    assert [line.split()[0] for line in lines] == vocab.idx_to_token
    rows = np.asarray([[float(x) for x in line.split()[1:]] for line in lines])
    assert rows.shape == (len(vocab), 12)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, rtol=1e-5)
    # the captioner's vocabulary reads the same matrix through both loaders
    cap_vocab = TennisSet(root=root, split="train", captions=True).vocab
    got = load_embeddings(path, cap_vocab, 12)
    want = jax_load(path, cap_vocab, 12)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0
    # a second run keeps the file unless --overwrite
    before = open(path).read()
    train_embeddings.main([f"--root={root}", "--device=cpu", "--epochs=1",
                           "--emb_size=12", "--seed=9", "--notsne"])
    assert open(path).read() == before
