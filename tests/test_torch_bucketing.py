"""The captioner's data path against the JAX package's, on the synthetic
fixture with a numpy feature store: the captions-mode ``TennisSet``
(vocabulary, captions, caption ids, bucketing lengths, items),
``load_embeddings``, ``bucket_keys``, the sampler's batches for each seed
and epoch, and every array ``BucketedCaptionLoader`` yields. All exact."""
import os

import numpy as np
import pytest

from fixtures import VIDEO_EVENTS, build_fixture
from tennis_tpu.data import bucketing as jax_bucketing
from tennis_tpu.data import loader as jax_loader
from tennis_tpu.data import vocab as jax_vocab
from tennis_tpu.data.tennis_set import TennisSet as JaxTennisSet
from tennis_torch.data import bucketing, loader, vocab
from tennis_torch.data.tennis_set import TennisSet

FEAT_DIM = 32


def make_feature_store(root, name, dim=FEAT_DIM):
    """A seeded .npy feature for every on-disk fixture frame."""
    from tennis_torch.data.tennis_set import get_feature_path

    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = get_feature_path(os.path.join(root, "features", name),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.normal(size=(dim,)).astype(np.float32))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = build_fixture(tmp_path_factory.mktemp("ds"))
    make_feature_store(root, "tf")
    return root


def _pair(root, split, **kw):
    common = dict(root=root, captions=True, split=split, feats_model="tf")
    want = JaxTennisSet(**common, **{k: v for k, v in kw.items()
                                     if k != "vocab"},
                        vocab=kw.get("vocab", (None, None))[0])
    got = TennisSet(**common, **{k: v for k, v in kw.items() if k != "vocab"},
                    vocab=kw.get("vocab", (None, None))[1])
    return want, got


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("max_cap_len", [-1, 5])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_captions_tennis_set_matches_jax(root, split, every, max_cap_len):
    train_j, train_t = _pair(root, "train")
    assert train_t.vocab.idx_to_token == train_j.vocab.idx_to_token
    want, got = _pair(root, split, every=every, max_cap_len=max_cap_len,
                      inference=split != "train",
                      vocab=(train_j.vocab, train_t.vocab))
    assert len(got) == len(want) > 0
    assert got._samples == want._samples
    assert got.get_captions() == want.get_captions()
    assert got.get_captions(split=True) == want.get_captions(split=True)
    for a, b in zip(got.get_captions(ids=True), want.get_captions(ids=True)):
        np.testing.assert_array_equal(a, b)
    assert got.get_data_lens() == want.get_data_lens()
    assert got.stats() == want.stats()
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert len(a) == len(b)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype
        assert a[2:] == b[2:]


def test_load_embeddings_matches_jax(root, tmp_path):
    v = TennisSet(root=root, captions=True, split="train",
                  feats_model="tf").vocab
    vj = JaxTennisSet(root=root, captions=True, split="train",
                      feats_model="tf").vocab
    rng = np.random.default_rng(3)
    path = tmp_path / "emb.txt"
    lines = [f"{tok} " + " ".join(f"{x:.6f}" for x in rng.normal(size=6))
             for tok in v.idx_to_token[4::2] + ["notaword"]]
    path.write_text("\n".join(["", "junk"] + lines) + "\n")
    for dim in (None, 6):
        want = jax_vocab.load_embeddings(str(path), vj, dim)
        got = vocab.load_embeddings(str(path), v, dim)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", ["constant", "linear", "exp"])
@pytest.mark.parametrize("num_buckets", [1, 2, 5])
def test_bucket_keys_match_jax(scheme, num_buckets):
    rng = np.random.default_rng(num_buckets)
    lengths = rng.integers(3, 600, 97).tolist()
    assert bucketing.bucket_keys(lengths, num_buckets, scheme) == \
        jax_bucketing.bucket_keys(lengths, num_buckets, scheme)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=100), dict(shuffle=False),
    dict(shuffle=True, seed=3, ratio=0.5),
    dict(shuffle=True, seed=3, batch_multiple=4),
    dict(shuffle=False, key_element=-1)])
def test_sampler_batches_match_jax(kw):
    rng = np.random.default_rng(5)
    lens = list(zip(rng.integers(8, 500, 130).tolist(),
                    rng.integers(4, 52, 130).tolist()))
    a = bucketing.FixedBucketSampler(lens, 16, 5, **kw)
    b = jax_bucketing.FixedBucketSampler(lens, 16, 5, **kw)
    assert len(a) == len(b)
    assert a.stats() == b.stats()
    for epoch in range(3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b)


def test_padded_batch_matches_jax():
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(n, 3)).astype(np.float32) for n in (4, 1, 7)]
    got, got_l = loader.padded_batch(arrays)
    want, want_l = jax_loader.padded_batch(arrays)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_l, want_l)
    assert got_l.dtype == want_l.dtype == np.int32


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_bucketed_loader_matches_jax(root, split):
    """The drivers' loaders: train shuffled by seed and bucketed on frames,
    val and test in order on caption length; time axes padded to 8,
    float32 lengths, sample indices in inference mode."""
    train_j, train_t = _pair(root, "train", max_cap_len=10)
    if split == "train":
        want, got = train_j, train_t
    else:
        want, got = _pair(root, split, inference=True,
                          vocab=(train_j.vocab, train_t.vocab))
    kw = dict(shuffle=True, seed=100) if split == "train" else \
        dict(shuffle=False, key_element=-1)
    a = bucketing.BucketedCaptionLoader(got, 3, 2, num_workers=2,
                                        pad_multiple=8, **kw)
    b = jax_bucketing.BucketedCaptionLoader(want, 3, 2, num_workers=2,
                                            pad_multiple=8, **kw)
    assert len(a) == len(b) > 0
    for epoch in range(2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        batches = list(zip(a, b))
        assert len(batches) == len(b)
        for x, y in batches:
            assert len(x) == len(y) == (4 if split == "train" else 5)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)
            assert x[0].shape[1] % 8 == 0 and x[1].shape[1] % 8 == 0
            assert x[2].dtype == x[3].dtype == np.float32
