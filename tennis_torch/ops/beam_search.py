"""Batched beam search (counterpart of ``tennis_tpu/ops/beam_search.py``).

The JAX package runs the search as one compiled ``lax.while_loop``. Here
``beam_search`` is a Python loop over torch ops on the model's device with
the same early exit (``t < max_length and not all finished``: one host read
per step), and ``beam_search_loop`` the same search as one
``torch._higher_order_ops.while_loop``, the form ``torch.export`` keeps;
both run one shared step. Batch and beam fold into one leading axis, so
every decoder op sees a (B*K) batch.

Scoring follows gluonnlp's ``BeamSearchScorer(alpha, K)``: the ranking score
of a hypothesis of length t is ``cum_logprob / lp(t)`` with
``lp(t) = ((K + t) / (K + 1)) ** alpha``. Finished beams freeze their
penalized score and compete as single candidates. Ties go to the lower
candidate index, as ``lax.top_k`` and the stable ``jnp.argsort`` break them:
the top-k is a stable descending sort (``torch.topk`` promises no order
among equal values, and ties do occur among the ``NEG_INF`` fill).

Returned samples start with BOS and include the EOS position in
``valid_length`` (callers strip ``[1:vl-1]``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

NEG_INF = -1.0e9


def _lp(t: torch.Tensor, alpha: float, K: int) -> torch.Tensor:
    return torch.pow((K + t.float()) / (K + 1), alpha)


def _tree_map(fn, tree, min_dim: int = 1):
    """``fn`` over the tensors of at least ``min_dim`` dimensions of a tree
    of tuples, lists and dicts; every other leaf as it is."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x, min_dim) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, min_dim) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() >= min_dim:
        return fn(tree)
    return tree


def _tile_beam(tree, beam_size: int):
    """(B, ...) -> (B*K, ...) by repeating each batch row K times."""
    return _tree_map(lambda x: x.repeat_interleave(beam_size, dim=0), tree)


def _gather_beams(tree, parent, batch_size: int, beam_size: int):
    """Reorder the (B*K, ...) leaves by per-batch parent beam indices (B, K)."""
    flat = (parent + torch.arange(batch_size, device=parent.device)[:, None]
            * beam_size).reshape(-1)
    return _tree_map(lambda x: x.index_select(0, flat), tree)


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index (``lax.top_k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _flatten(tree) -> list:
    """The tensors of a state tree, in order."""
    leaves: list = []
    _tree_map(leaves.append, tree, min_dim=0)
    return leaves


def _unflatten(leaves, tree):
    """``tree`` with its tensors replaced by ``leaves``, in order."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree, min_dim=0)


def _init(init_states, B: int, Kb: int, bos_id: int, eos_id: int, L: int):
    """The search's first carry: ``(seqs, scores, finished, lengths,
    states)``, only beam 0 live."""
    leaves = _flatten(init_states)
    device = leaves[0].device if leaves else torch.device("cpu")
    states = _tile_beam(init_states, Kb)
    seqs = torch.full((B, Kb, L), eos_id, dtype=torch.int32, device=device)
    seqs[:, :, 0] = bos_id
    # only beam 0 is live at first, so the first expansion picks K tokens
    scores = torch.full((B, Kb), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, Kb), dtype=torch.bool, device=device)
    lengths = torch.ones((B, Kb), dtype=torch.int32, device=device)
    return seqs, scores, finished, lengths, states


def _search_step(decode_step, t, seqs, scores, finished, lengths, states,
                 eos_id: int, alpha: float, K: int):
    """One expansion of every beam: ``t`` (a 0-dim int64 tensor) steps
    taken so far -> the next ``(seqs, scores, finished, lengths,
    states)``. The Python loop of :func:`beam_search` and the
    ``while_loop`` of :func:`beam_search_loop` both run it."""
    B, Kb, L = seqs.shape
    device = seqs.device
    neg_inf = torch.full((), NEG_INF, device=device)
    last_tokens = seqs.reshape(B * Kb, L).gather(
        1, (lengths.reshape(B * Kb, 1) - 1).long())[:, 0]
    logits, new_states = decode_step(last_tokens, states)
    logp = torch.log_softmax(logits.float(), dim=-1)
    V = logp.shape[-1]
    logp = logp.reshape(B, Kb, V)

    # hypotheses extended this round have t + 1 tokens
    lp_t = _lp(t + 1, alpha, K)

    raw_alive = torch.where(finished[..., None], neg_inf,
                            scores[..., None] + logp)
    penalized_alive = raw_alive / lp_t
    keep_scores = torch.where(finished, scores, neg_inf)
    candidates = torch.cat([penalized_alive.reshape(B, Kb * V),
                            keep_scores], dim=1)
    top_scores, top_idx = _top_k(candidates, Kb)

    from_keep = top_idx >= Kb * V
    parent = torch.where(from_keep, top_idx - Kb * V, top_idx // V)
    token = torch.where(from_keep, torch.full_like(top_idx, eos_id),
                        top_idx % V).to(torch.int32)

    # reorder by parent; kept-finished beams' states advanced by a spurious
    # step, which is never read again
    states = _gather_beams(new_states, parent, B, Kb)
    seqs = seqs.gather(1, parent[..., None].expand(B, Kb, L))
    lengths = lengths.gather(1, parent)
    prev_finished = finished.gather(1, parent)

    now_eos = ~from_keep & (token == eos_id)
    new_finished = (from_keep & prev_finished) | now_eos
    expanded = ~from_keep
    positions = torch.arange(L, device=device)[None, None, :]
    pos_mask = (positions == lengths[..., None]) & expanded[..., None]
    seqs = torch.where(pos_mask, token[..., None], seqs)
    lengths = torch.where(expanded, lengths + 1, lengths)
    # alive beams carry the raw cumulative log-prob; finished beams (new or
    # kept) their frozen penalized score
    scores = torch.where(new_finished, top_scores, top_scores * lp_t)
    return seqs, scores, new_finished, lengths, states


def _final(seqs, scores, finished, lengths, alpha: float, K: int):
    """Unfinished beams penalized at their length, beams sorted by score:
    ``(samples, scores, valid_length)``."""
    B, Kb, L = seqs.shape
    final_scores = torch.where(finished, scores,
                               scores / _lp(lengths - 1, alpha, K))
    order = torch.sort(-final_scores, dim=1, stable=True).indices
    seqs = seqs.gather(1, order[..., None].expand(B, Kb, L))
    final_scores = final_scores.gather(1, order)
    lengths = lengths.gather(1, order)
    finished = finished.gather(1, order)
    valid_length = torch.where(finished, lengths, lengths + 1)
    return seqs, final_scores, valid_length


def beam_search(decode_step: Callable, init_states: Any, batch_size: int,
                beam_size: int, bos_id: int, eos_id: int, max_length: int,
                alpha: float = 1.0, K: int = 5):
    """Run beam search as a Python loop (one host read a step for the early
    exit).

    Args:
        decode_step: ``(tokens (N,), states) -> (logits (N, V), new_states)``
            with ``N = batch_size * beam_size``.
        init_states: decoder state tree (tuples, lists, dicts, tensors with a
            leading batch axis ``batch_size``, None), tiled to the beam here.
        max_length: decode-step budget (excludes BOS).

    Returns:
        samples (B, K, max_length+2) int32, BOS first, EOS included;
        scores (B, K) float32, length-penalized log-prob, descending;
        valid_length (B, K) int32, BOS and EOS included (unfinished beams
        get a trailing EOS counted in, as in gluonnlp).
    """
    seqs, scores, finished, lengths, states = _init(
        init_states, batch_size, beam_size, bos_id, eos_id, max_length + 2)
    t = 0
    # under a sequence-sharded memory the model ranks of a data index run
    # this loop in lockstep: their logits come from all-reduced values,
    # alike on each, so finished.all() agrees among them
    while t < max_length and not bool(finished.all()):
        seqs, scores, finished, lengths, states = _search_step(
            decode_step, torch.tensor(t, device=seqs.device), seqs, scores,
            finished, lengths, states, eos_id, alpha, K)
        t += 1
    return _final(seqs, scores, finished, lengths, alpha, K)


def beam_search_loop(decode_step: Callable, init_states: Any,
                     batch_size: int, beam_size: int, bos_id: int,
                     eos_id: int, max_length: int, alpha: float = 1.0,
                     K: int = 5):
    """:func:`beam_search` as one ``torch._higher_order_ops.while_loop``,
    the form ``torch.export`` keeps (the counterpart of the JAX
    ``lax.while_loop``): the carry ``(t, seqs, scores, finished, lengths,
    *the decoder state's tensors)`` keeps fixed shapes, the condition is
    ``(t < max_length) & ~finished.all()`` and the body is
    :func:`_search_step`. The same arguments and results as
    :func:`beam_search`, bit for bit."""
    from torch._higher_order_ops import while_loop

    seqs, scores, finished, lengths, states = _init(
        init_states, batch_size, beam_size, bos_id, eos_id, max_length + 2)

    def cond(t, seqs, scores, finished, lengths, *leaves):
        return (t < max_length) & ~finished.all()

    def body(t, seqs, scores, finished, lengths, *leaves):
        out = _search_step(decode_step, t, seqs, scores, finished, lengths,
                           _unflatten(leaves, states), eos_id, alpha, K)
        # a 0-dim leaf is never gathered, so the step may pass it through:
        # it leaves as a copy, since a while_loop's outputs may not alias
        # its inputs
        new = [x.clone() if x.dim() == 0 else x for x in _flatten(out[4])]
        return (t + 1, *out[:4], *new)

    t0 = torch.zeros((), dtype=torch.int64, device=seqs.device)
    _, seqs, scores, finished, lengths, *_ = while_loop(
        cond, body, (t0, seqs, scores, finished, lengths, *_flatten(states)))
    return _final(seqs, scores, finished, lengths, alpha, K)
