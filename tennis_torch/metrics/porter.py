"""Porter stemmer (the original 1980 algorithm), pure Python; a copy of
``tennis_tpu/metrics/porter.py``.

Used as the stem-match stage of :func:`tennis_torch.metrics.nlg.meteor_lite` —
the reference scores captions through nlg-eval's METEOR jar (reference
train_gnmt.py:379-385), whose aligner matches exact → stem → synonym →
paraphrase; adding the stem stage closes most of the strict-matching underread
(deviation D1 in PARITY.md). Implements the algorithm exactly as published
(An algorithm for suffix stripping, Program 14(3) 1980); cross-checked in tests
against NLTK's ``PorterStemmer(mode='ORIGINAL_ALGORITHM')``.
"""
from __future__ import annotations

__all__ = ["porter_stem"]

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel→consonant transitions."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        if _is_cons(stem, i):
            if prev_vowel:
                m += 1
            prev_vowel = False
        else:
            prev_vowel = True
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _ends_cvc(w: str) -> bool:
    """*o: stem ends consonant-vowel-consonant, final consonant not w/x/y."""
    if len(w) < 3:
        return False
    return (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def _rule_step(word: str, rules) -> str:
    """Porter step semantics: the LONGEST matching suffix is selected first,
    THEN its condition is checked — a failed condition ends the step without
    trying shorter suffixes."""
    best = None
    for suffix, repl, cond in rules:
        if word.endswith(suffix) and (best is None or len(suffix) > len(best[0])):
            best = (suffix, repl, cond)
    if best is None:
        return word
    suffix, repl, cond = best
    stem = word[: len(word) - len(suffix)]
    if cond is None or cond(stem):
        return stem + repl
    return word


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
]

_STEP3 = [
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
]

_STEP4 = [
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
    "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
]


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2 or not w.isalpha():
        return w

    # ---- step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # ---- step 1b
    ed_ing_stripped = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        ed_ing_stripped = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        ed_ing_stripped = True
    if ed_ing_stripped:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # ---- step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # ---- step 2
    w = _rule_step(w, [(s, r, lambda st: _measure(st) > 0) for s, r in _STEP2])

    # ---- step 3
    w = _rule_step(w, [(s, r, lambda st: _measure(st) > 0) for s, r in _STEP3])

    # ---- step 4 ("ion" additionally needs the stem to end in s/t)
    rules4 = [(s, "", lambda st: _measure(st) > 1) for s in _STEP4]
    rules4.append(
        ("ion", "", lambda st: _measure(st) > 1 and st[-1:] in ("s", "t"))
    )
    w = _rule_step(w, rules4)

    # ---- step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]

    # ---- step 5b
    if w.endswith("ll") and _measure(w) > 1:
        w = w[:-1]

    return w
