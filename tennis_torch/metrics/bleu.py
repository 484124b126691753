"""Corpus BLEU (pure Python, no deps); a copy of ``tennis_tpu/metrics/bleu.py``.

Same contract as the reference's ``metrics/bleu.py`` (``compute_bleu`` at
metrics/bleu.py:158-247): clipped modified n-gram precision up to ``max_n``, closest
reference-length brevity penalty, optional +1 smoothing, optional 13a / international
tokenization, BPE un-merging and compound-word splitting. Returns the same 5-tuple
``(bleu, precisions, bp, ref_length, trans_length)``.
"""
from __future__ import annotations

import math
import re
import sys
import unicodedata
from collections import Counter

__all__ = ["compute_bleu"]

_LIST_TYPES = (list, tuple)


def _ngram_counts(tokens, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _tokenize_13a(text: str) -> str:
    """mteval-v13a.pl tokenization (as used by WMT / tensorflow-nmt BLEU)."""
    norm = text.rstrip()
    norm = norm.replace("<skipped>", "")
    norm = norm.replace("-\n", "")
    norm = norm.replace("\n", " ")
    norm = norm.replace("&quot;", '"')
    norm = norm.replace("&amp;", "&")
    norm = norm.replace("&lt;", "<")
    norm = norm.replace("&gt;", ">")
    norm = f" {norm} "
    norm = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", norm)
    norm = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", norm)
    norm = re.sub(r"([\.,])([^0-9])", r" \1 \2", norm)
    norm = re.sub(r"([0-9])(-)", r"\1 \2 ", norm)
    return re.sub(r"\s+", " ", norm).strip()


class _UnicodeRegex:
    """Punctuation/symbol classes for the mteval-v14 international tokenizer."""

    def __init__(self):
        punct = self._chars_with_property("P")
        symbol = self._chars_with_property("S")
        self.nondigit_punct = re.compile(r"([^\d])([" + punct + r"])")
        self.punct_nondigit = re.compile(r"([" + punct + r"])([^\d])")
        self.symbol = re.compile("([" + symbol + "])")

    @staticmethod
    def _chars_with_property(prefix: str) -> str:
        return "".join(
            chr(x)
            for x in range(sys.maxunicode)
            if unicodedata.category(chr(x)).startswith(prefix)
        )


_UNICODE_REGEX = None


def _tokenize_intl(text: str) -> str:
    global _UNICODE_REGEX
    if _UNICODE_REGEX is None:  # lazy: building the char classes is slow
        _UNICODE_REGEX = _UnicodeRegex()
    text = text.rstrip()
    text = _UNICODE_REGEX.nondigit_punct.sub(r"\1 \2 ", text)
    text = _UNICODE_REGEX.punct_nondigit.sub(r" \1 \2", text)
    text = _UNICODE_REGEX.symbol.sub(r" \1 ", text)
    return text.strip()


_TOKENIZERS = {"13a": _tokenize_13a, "intl": _tokenize_intl, None: lambda s: s}


def _bpe_to_words(tokens, delimiter: str = "@@"):
    words, word = [], ""
    for piece in tokens:
        if piece.endswith(delimiter) and len(piece) >= len(delimiter):
            word += piece[: -len(delimiter)]
        else:
            words.append(word + piece)
            word = ""
    return words


def _split_compound_words(tokens):
    return re.sub(r"(\S)-(\S)", r"\1 ##AT##-##AT## \2", " ".join(tokens)).split()


def _closest_ref_length(references, trans_len: int) -> int:
    return min((abs(len(r) - trans_len), len(r)) for r in references)[1]


def _brevity_penalty(ref_length: int, trans_length: int) -> float:
    if trans_length > ref_length:
        return 1.0
    if trans_length == 0:
        return 0.0
    return math.exp(1.0 - ref_length / trans_length)


def compute_bleu(
    reference_corpus_list,
    translation_corpus,
    tokenized: bool = True,
    tokenizer="13a",
    max_n: int = 4,
    smooth: bool = False,
    lower_case: bool = False,
    bpe: bool = False,
    split_compound_word: bool = False,
):
    """Corpus BLEU of ``translation_corpus`` against per-sentence reference sets.

    ``reference_corpus_list`` is a list of reference *corpora* (one entry per reference
    set, each parallel to the translations), matching the reference signature.
    """
    for refs in reference_corpus_list:
        if len(refs) != len(translation_corpus):
            raise ValueError("translations and references are not parallel")

    numer = [0] * max_n
    denom = [0] * max_n
    ref_length = 0
    trans_length = 0

    for refs, translation in zip(zip(*reference_corpus_list), translation_corpus):
        if not tokenized:
            refs = [_TOKENIZERS[tokenizer](r).split() for r in refs]
            translation = _TOKENIZERS[tokenizer](translation).split()
        else:
            refs = [list(r) for r in refs]
            translation = list(translation)
        if bpe:
            refs = [_bpe_to_words(r) for r in refs]
            translation = _bpe_to_words(translation)
        if split_compound_word:
            refs = [_split_compound_words(r) for r in refs]
            translation = _split_compound_words(translation)
        if lower_case:
            refs = [[w.lower() for w in r] for r in refs]
            translation = [w.lower() for w in translation]

        trans_length += len(translation)
        ref_length += _closest_ref_length(refs, len(translation))

        for n in range(1, max_n + 1):
            trans_counts = _ngram_counts(translation, n)
            if not trans_counts:
                continue
            max_ref = Counter()
            for r in refs:
                for gram, count in _ngram_counts(r, n).items():
                    max_ref[gram] = max(max_ref[gram], count)
            numer[n - 1] += sum(
                min(count, max_ref[gram]) for gram, count in trans_counts.items()
            )
            denom[n - 1] += sum(trans_counts.values())

    c = 1 if smooth else 0
    precisions = [
        (numer[n] + c) / (denom[n] + c) if denom[n] > 0 else 0.0 for n in range(max_n)
    ]

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_n)
    else:
        geo_mean = 0.0

    bp = _brevity_penalty(ref_length, trans_length)
    return geo_mean * bp, precisions, bp, ref_length, trans_length
