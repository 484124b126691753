"""The port's classification metrics against the JAX package's, on seeded
labels and scores with argmax ties and classes absent from a batch. Every
comparison is exact: the same counts give the same floats."""
import numpy as np
import pytest

from tennis_tpu.metrics import accuracy as jax_accuracy
from tennis_tpu.metrics import vision as jax_vision
from tennis_torch.metrics import PRF1, Accuracy, TopKAccuracy, \
    confusion_matrix, prf1_from_confusion

CLASSES = ["OTH", "SFI", "SFF", "SFL", "SNI", "SNF", "SNL", "HFL", "HFR",
           "HNL", "HNR"]


def _batches(seed, n_batches=4, size=37, classes=11, ties=False, absent=()):
    """Seeded (labels, f32 scores) batches; ``ties`` draws scores from three
    values so argmax and top-k meet equal scores; labels never take the
    classes in ``absent``."""
    rng = np.random.default_rng(seed)
    allowed = [c for c in range(classes) if c not in absent]
    out = []
    for _ in range(n_batches):
        labels = rng.choice(allowed, size).astype(np.int32)
        if ties:
            scores = rng.integers(0, 3, (size, classes)).astype(np.float32)
        else:
            scores = rng.standard_normal((size, classes)).astype(np.float32)
        out.append((labels, scores))
    return out


CASES = [dict(seed=0), dict(seed=1, ties=True), dict(seed=2, absent=(3, 5, 7)),
         dict(seed=3, ties=True, absent=(0, 10)), dict(seed=4, n_batches=1,
                                                       size=1)]


@pytest.mark.parametrize("case", CASES)
def test_prf1_equals_jax(case):
    got, want = PRF1(CLASSES), jax_vision.PRF1(CLASSES)
    for labels, scores in _batches(**case):
        got.update(labels, scores)
        want.update(labels, scores)
    np.testing.assert_array_equal(got.mat, want.mat)
    assert got.get() == want.get()
    assert got.get_dict() == want.get_dict()
    assert got.confusion_str() == want.confusion_str()
    got.reset()
    assert not got.mat.any()


@pytest.mark.parametrize("case", CASES[:3])
def test_confusion_matrix_equals_jax(case):
    for labels, scores in _batches(**case):
        want = np.asarray(jax_vision.confusion_matrix(labels, scores, 11))
        got = confusion_matrix(labels, scores, 11)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        # class indices as predictions
        preds = scores.argmax(-1)
        np.testing.assert_array_equal(
            confusion_matrix(labels, preds, 11),
            np.asarray(jax_vision.confusion_matrix(labels, preds, 11)))


def test_prf1_from_confusion_equals_jax():
    mat = np.random.default_rng(5).integers(0, 9, (11, 11))
    mat[4] = 0  # an absent class
    mat[:, 6] = 0  # a class never predicted
    for a, b in zip(jax_vision.prf1_from_confusion(mat),
                    prf1_from_confusion(mat)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ignore", [(), (0,), tuple(range(1, 11))])
def test_accuracy_equals_jax(case, ignore):
    got = Accuracy("acc", ignore_labels=ignore)
    want = jax_accuracy.Accuracy("acc", ignore_labels=ignore)
    assert got.get()[0] == want.get()[0]
    assert np.isnan(got.get()[1]) and np.isnan(want.get()[1])
    for labels, scores in _batches(**case):
        got.update(labels, scores)
        want.update(labels, scores)
        got.update(labels, scores.argmax(-1))  # index predictions too
        want.update(labels, scores.argmax(-1))
    assert (got.num_correct, got.num_total) == (want.num_correct,
                                                want.num_total)
    g, w = got.get()[1], want.get()[1]
    assert g == w or (np.isnan(g) and np.isnan(w))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 5, 20])
def test_topk_accuracy_equals_jax(case, k):
    got, want = TopKAccuracy(k), jax_accuracy.TopKAccuracy(k)
    assert got.name == want.name
    for labels, scores in _batches(**case):
        got.update(labels, scores)
        want.update(labels, scores)
    assert got.get() == want.get()
