"""The port's caption metrics and caption text helpers against the JAX
package's: pure Python copies, so every result must be identical (BLEU,
the NLG suite, the Porter stemmer, ``get_comp_str`` and the sentence files),
on the synthetic fixture's captions and on seeded random corpora."""
import numpy as np
import pytest

from fixtures import build_fixture
from tennis_tpu.metrics import bleu as jax_bleu
from tennis_tpu.metrics import nlg as jax_nlg
from tennis_tpu.metrics import porter as jax_porter
from tennis_tpu.utils import captioning as jax_captioning
from tennis_torch.metrics import bleu, nlg, porter
from tennis_torch.utils import captioning

WORDS = ["serve", "serves", "served", "serving", "fault", "faults", "ace",
         "aces", "the", "a", "into", "net", "long", "wide", "player",
         "players", "forehand", "backhand", "winner", "winners", "rally",
         "rallies", "hits", "hitting", "goes", "going", "volley", "out"]


def _corpus(seed, n=40, lo=1, hi=14):
    rng = np.random.default_rng(seed)
    return [[WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(lo, hi))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def fixture_captions(tmp_path_factory):
    from tennis_tpu.data import TennisSet

    root = build_fixture(tmp_path_factory.mktemp("ds"))
    caps = []
    for split in ("train", "val", "test"):
        caps += TennisSet(root=root, captions=True, split=split).get_captions(
            split=True)
    return caps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nlg_suite_identical_on_random_corpora(seed):
    refs, hyps = _corpus(seed), _corpus(seed + 100)
    hyps[::5] = refs[::5]  # some perfect matches
    hyps[3] = []           # an empty hypothesis
    want = jax_nlg.nlg_metric_suite([[r] for r in refs], hyps)
    got = nlg.nlg_metric_suite([[r] for r in refs], hyps)
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}


def test_nlg_suite_identical_on_fixture_captions(fixture_captions):
    refs = fixture_captions
    hyps = [list(reversed(c)) for c in refs[::2]] + refs[1::2]
    refs = refs[::2] + refs[1::2]
    assert nlg.nlg_metric_suite([[r] for r in refs], hyps) == \
        jax_nlg.nlg_metric_suite([[r] for r in refs], hyps)
    # strings and token lists score alike
    as_str = [" ".join(h) for h in hyps]
    assert nlg.nlg_metric_suite([[" ".join(r)] for r in refs], as_str) == \
        jax_nlg.nlg_metric_suite([[r] for r in refs], hyps)


@pytest.mark.parametrize("kwargs", [
    {}, {"max_n": 2}, {"smooth": True}, {"tokenized": False},
    {"tokenized": False, "tokenizer": "intl"}, {"bpe": True},
    {"split_compound_word": True}])
def test_compute_bleu_identical(kwargs):
    refs = _corpus(5, 30)
    hyps = _corpus(6, 30)
    refs2 = _corpus(7, 30)
    if kwargs.get("tokenized") is False:
        refs = [" ".join(r) + " ." for r in refs]
        refs2 = [" ".join(r) + "!" for r in refs2]
        hyps = [" ".join(h) + " ," for h in hyps]
    if kwargs.get("bpe"):
        hyps = [[w[:3] + "@@", w[3:]] if len(w) > 4 else [w]
                for h in hyps for w in h[:1]]
    if kwargs.get("split_compound_word"):
        hyps = [h + ["back-hand"] for h in hyps]
    assert bleu.compute_bleu([refs, refs2], hyps, **kwargs) == \
        jax_bleu.compute_bleu([refs, refs2], hyps, **kwargs)


def test_porter_identical():
    words = WORDS + ["caresses", "ponies", "ties", "caress", "cats", "feed",
                     "agreed", "plastered", "bled", "motoring", "sing",
                     "conflated", "troubled", "sized", "hopping", "tanned",
                     "falling", "hissing", "fizzed", "failing", "filing",
                     "happy", "sky", "relational", "conditional", "rational",
                     "valenci", "hesitanci", "digitizer", "conformabli",
                     "radicalli", "differentli", "vileli", "analogousli",
                     "vietnamization", "predication", "operator", "feudalism",
                     "decisiveness", "hopefulness", "callousness", "formaliti",
                     "sensitiviti", "sensibiliti", "triplicate", "formative",
                     "formalize", "electriciti", "electrical", "hopeful",
                     "goodness", "revival", "allowance", "inference",
                     "airliner", "gyroscopic", "adjustable", "defensible",
                     "irritant", "replacement", "adjustment", "dependent",
                     "adoption", "homologou", "communism", "activate",
                     "angulariti", "homologous", "effective", "bowdlerize",
                     "probate", "rate", "cease", "controll", "roll", "a",
                     "is", "generalizations", "oscillators"]
    assert [porter.porter_stem(w) for w in words] == \
        [jax_porter.porter_stem(w) for w in words]


def test_meteor_rouge_cider_identical():
    refs, hyps = _corpus(11), _corpus(12)
    for name in ("meteor_lite", "rouge_l", "cider_d"):
        assert getattr(nlg, name)([[r] for r in refs], hyps) == \
            getattr(jax_nlg, name)([[r] for r in refs], hyps), name


def test_caption_text_helpers_identical(tmp_path, fixture_captions):
    tgts = fixture_captions[:6]
    prds = [" ".join(c) for c in _corpus(3, 6)]
    assert captioning.get_comp_str(tgts, prds) == \
        jax_captioning.get_comp_str(tgts, prds)
    sentences = tgts + prds + [[]]
    captioning.write_sentences(sentences, str(tmp_path / "port.txt"))
    jax_captioning.write_sentences(sentences, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert captioning.read_sentences(str(tmp_path / "port.txt")) == \
        jax_captioning.read_sentences(str(tmp_path / "jax.txt"))
