"""Caption metric suite: BLEU-1..4, ROUGE-L, CIDEr-D and a METEOR variant; a
copy of ``tennis_tpu/metrics/nlg.py``, so the scores are identical.

Replaces the reference's external ``nlgeval`` dependency (reference
train_gnmt.py:42,379-385 — BLEU1-4, METEOR, ROUGE_L, CIDEr). nlg-eval is
unmaintained and Java/WordNet-backed; these are standalone reimplementations of the
standard COCO-caption formulations:

- ROUGE-L: LCS-based F-measure with beta=1.2 (pycocoevalcap rouge.py).
- CIDEr-D: tf-idf weighted n-gram cosine, n=1..4, length-gaussian sigma=6,
  clipped counts, ×10 scale (pycocoevalcap cider.py defaults, as used by nlg-eval).
- METEOR: exact → Porter-stem alignment (tennis_torch.metrics.porter) with the
  standard fragmentation penalty (alpha=0.9, beta=3, gamma=0.5). **Deviation**:
  no WordNet synonym/paraphrase stages (Java + corpus deps), so scores remain a
  mild lower bound of official METEOR — but the stem stage recovers
  inflection-level matches (serve/serves/serving share a stem), which dominate
  the 250-word tennis commentary vocabulary. Documented as D1 in PARITY.md so
  parity comparisons apply a (now tighter) tolerance.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Sequence

from tennis_torch.metrics.bleu import compute_bleu

__all__ = ["rouge_l", "cider_d", "meteor_lite", "nlg_metric_suite"]


def _tok(s):
    return s.split() if isinstance(s, str) else list(s)


def _lcs_len(a, b):
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def _normalize(references, hypotheses):
    """Canonical format: refs = per-sample list of token-lists; hyps = token-lists.
    Accepts strings (split on whitespace) and single references transparently."""
    hyps = [_tok(h) for h in hypotheses]
    refs = []
    for rs in references:
        if isinstance(rs, str):
            rs = [rs]
        elif rs and not isinstance(rs[0], (list, tuple)) and not isinstance(
            rs[0], str
        ):
            rs = [rs]
        elif rs and isinstance(rs[0], str) and " " not in rs[0] and len(rs) > 1:
            # a bare token-list like ["the", "cat"] — treat as one reference
            rs = [rs]
        refs.append([_tok(r) for r in rs])
    return refs, hyps


def rouge_l(references: Sequence, hypotheses: Sequence, beta: float = 1.2) -> float:
    """Corpus ROUGE-L: mean per-sentence LCS F-measure (best over references)."""
    assert len(references) == len(hypotheses)
    refs_all, hyps = _normalize(references, hypotheses)
    total = 0.0
    for refs, hyp_t in zip(refs_all, hyps):
        best = 0.0
        for ref_t in refs:
            lcs = _lcs_len(ref_t, hyp_t)
            if lcs == 0 or not hyp_t or not ref_t:
                continue
            prec = lcs / len(hyp_t)
            rec = lcs / len(ref_t)
            score = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
            best = max(best, score)
        total += best
    return total / max(len(hypotheses), 1)


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def cider_d(references: Sequence, hypotheses: Sequence, max_n: int = 4,
            sigma: float = 6.0) -> float:
    """Corpus CIDEr-D (pycocoevalcap formulation, ×10)."""
    assert len(references) == len(hypotheses)
    refs_tok, hyps_tok = _normalize(references, hypotheses)

    # document frequency over reference sets
    doc_freq = [defaultdict(float) for _ in range(max_n)]
    for refs in refs_tok:
        for n in range(max_n):
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref, n + 1).keys())
            for g in seen:
                doc_freq[n][g] += 1.0
    log_n_docs = math.log(max(len(refs_tok), 1))

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n + 1)
        vec, norm = {}, 0.0
        for g, c in counts.items():
            df = math.log(max(doc_freq[n].get(g, 0.0), 1.0))
            w = c * max(log_n_docs - df, 0.0)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), counts

    total = 0.0
    for refs, hyp in zip(refs_tok, hyps_tok):
        score_n = [0.0] * max_n
        for n in range(max_n):
            h_vec, h_norm, h_counts = tfidf_vec(hyp, n)
            for ref in refs:
                r_vec, r_norm, r_counts = tfidf_vec(ref, n)
                # CIDEr-D clips hyp counts to ref counts
                num = 0.0
                for g, w in h_vec.items():
                    if g in r_vec:
                        clipped = min(w, r_vec[g])
                        num += clipped * r_vec[g]
                if h_norm > 0 and r_norm > 0:
                    sim = num / (h_norm * r_norm)
                else:
                    sim = 0.0
                delta = len(hyp) - len(ref)
                sim *= math.exp(-(delta**2) / (2 * sigma**2))
                score_n[n] += sim / len(refs)
        total += 10.0 * sum(score_n) / max_n
    return total / max(len(hyps_tok), 1)


def _meteor_chunks(hyp, ref):
    """Two-stage greedy alignment in order — exact matches first, then
    Porter-stem matches over the leftovers (the official aligner's exact → stem
    module order; synonym/paraphrase stages stay out, see module docstring).
    Returns (#matches, #chunks)."""
    from tennis_torch.metrics.porter import porter_stem

    ref_used = [False] * len(ref)
    hyp_used = [False] * len(hyp)
    align = []
    for i, w in enumerate(hyp):
        for j, r in enumerate(ref):
            if not ref_used[j] and r == w:
                ref_used[j] = True
                hyp_used[i] = True
                align.append((i, j))
                break
    hyp_stems = [porter_stem(w) for w in hyp]
    ref_stems = [porter_stem(r) for r in ref]
    for i, s in enumerate(hyp_stems):
        if hyp_used[i]:
            continue
        for j, r in enumerate(ref_stems):
            if not ref_used[j] and r == s:
                ref_used[j] = True
                align.append((i, j))
                break
    align.sort()
    if not align:
        return 0, 0
    chunks = 1
    for (i1, j1), (i2, j2) in zip(align, align[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    return len(align), chunks


def meteor_lite(references: Sequence, hypotheses: Sequence, alpha: float = 0.9,
                beta: float = 3.0, gamma: float = 0.5) -> float:
    """Exact+stem METEOR (no synonym/paraphrase stages); mean over sentences,
    best over refs."""
    refs_all, hyps = _normalize(references, hypotheses)
    total = 0.0
    for refs, hyp_t in zip(refs_all, hyps):
        best = 0.0
        for ref_t in refs:
            m, chunks = _meteor_chunks(hyp_t, ref_t)
            if m == 0:
                continue
            prec = m / len(hyp_t)
            rec = m / len(ref_t)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            frag = chunks / m
            penalty = gamma * frag**beta
            best = max(best, fmean * (1 - penalty))
        total += best
    return total / max(len(hypotheses), 1)


def nlg_metric_suite(references, hypotheses):
    """The reference's reported metric dict (train_gnmt.py:379-385 layout):
    Bleu_1..4, METEOR, ROUGE_L, CIDEr. ``references``: list over samples of list of
    token-lists (or strings); ``hypotheses``: list of token-lists (or strings).

    Scale contract: Bleu_1..4/METEOR/ROUGE_L are fractions in [0, 1]; CIDEr is
    on the pycocoevalcap scale (the scorer's internal x10 already applied,
    typical range 0-10). Published-style tables (reference
    img/tennis_cap_summary.svg: Bleu_1 46.7, CIDEr 96.4) are these values
    x 100 (the JAX package's parity gate applies that one factor)."""
    refs_tok, hyps_tok = _normalize(references, hypotheses)

    out = {}
    for n in range(1, 5):
        # corpus BLEU with closest-ref brevity; single-reference corpus layout
        bleu, _, _, _, _ = compute_bleu(
            [[r[0] for r in refs_tok]], hyps_tok, max_n=n, smooth=False
        )
        out[f"Bleu_{n}"] = bleu
    out["METEOR"] = meteor_lite(refs_tok, hyps_tok)
    out["ROUGE_L"] = rouge_l(refs_tok, hyps_tok)
    out["CIDEr"] = cider_d(refs_tok, hyps_tok)
    return out
