"""SkipGram word-embedding trainer (counterpart of
``tennis_tpu/train_embeddings.py``).

Corpus = ``captions.txt`` (+ the extra caption corpus when present and
``--add_extra``), a vocabulary with no special tokens, fastText SkipGram
(ngrams 3-6, ``--ngram_buckets`` buckets, ``--num_negatives`` negatives,
smoothing 0.75), AdaGrad, ``--epochs`` epochs of (center, context) pairs
over a ``--window`` drawn per epoch, in a permuted order, at
``--batch_size``. It writes ``<root>/embeddings-ex.txt`` (``embeddings.txt``
without ``--add_extra``; an existing file only with ``--overwrite``) in the
reference's format (a token and its row-normalized vector a line), which
both captioner paths read as their fixed ``tgt_embed`` (``--emb_file``),
logs a k-NN probe, and writes the t-SNE scatter export when scikit-learn is
there.

The flags are the JAX trainer's, with the same names and defaults, plus
``--device`` (``cuda`` by default; asking for it without a GPU raises).
AdaGrad is ``optax.adagrad(lr)``'s: the accumulator starts at 0.1, the
update is ``-lr g / sqrt(acc + 1e-7)``. The pairs come from the port's
copy of the native batch ops (``tennis_torch.native.center_context_pairs``)
when that is built, as the JAX driver takes them from its own, else from
its numpy fallback (a window drawn per center from ``default_rng(seed +
epoch)``), whose pairs differ in order and in their reduced windows. The
losses are summed on the device and read at each log line, not after every
step.

Run: ``python -m tennis_torch.train_embeddings --root data`` (``--device
cpu`` off the GPU).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from collections import Counter

import numpy as np
import torch

log = logging.getLogger(__name__)

ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad's defaults


def _bool(value: str) -> bool:
    if value.lower() in ("1", "true", "t", "yes"):
        return True
    if value.lower() in ("0", "false", "f", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SkipGram embedding flags")
    add = p.add_argument

    def flag(name, help_):
        add(f"--{name}", type=_bool, nargs="?", const=True, help=help_)
        add(f"--no{name}", dest=name, action="store_false")

    add("--root", default="data", help="dataset root")
    flag("add_extra", "include the extra captions corpus")
    add("--batch_size", type=int, default=32, help="batch size")
    add("--emb_size", type=int, default=100, help="embedding dim")
    add("--epochs", type=int, default=2, help="epochs")
    add("--window", type=int, default=3, help="context window")
    add("--num_negatives", type=int, default=3, help="negatives per pair")
    add("--ngram_buckets", type=int, default=100, help="subword hash buckets")
    add("--lr", type=float, default=0.05, help="adagrad learning rate")
    flag("overwrite", "overwrite existing embedding file")
    add("--log_interval", type=int, default=500, help="log every N batches")
    add("--seed", type=int, default=0, help="rng seed")
    add("--probe_word", default="hits", help="k-NN probe word")
    flag("tsne", "write the t-SNE visualisation export")
    add("--device", default="cuda", choices=["cuda", "cpu"],
        help="Device the model runs on")
    p.set_defaults(add_extra=True, overwrite=False, tsne=True)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return parser().parse_args(argv)


def load_corpus(root: str, add_extra: bool):
    """Caption token lists, dropping the leading point-id column."""
    paths = [os.path.join(root, "annotations", "captions.txt")]
    if add_extra:
        extra = os.path.join(root, "annotations", "captions_extra_001-045.txt")
        if os.path.exists(extra):
            paths.append(extra)
        else:
            log.warning("extra corpus %s not found", extra)
    lines = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            lines += [line.rstrip().split()[1:] for line in f if line.strip()]
    return lines


class EmbeddingVocab:
    """Frequency-sorted vocab (ties by token) with NO special tokens."""

    def __init__(self, counter: Counter):
        items = sorted(counter.items(), key=lambda kv: kv[0])
        items.sort(key=lambda kv: kv[1], reverse=True)
        self.idx_to_token = [t for t, _ in items]
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}
        self.idx_to_counts = [c for _, c in items]

    def __len__(self):
        return len(self.idx_to_token)

    def __contains__(self, t):
        return t in self.token_to_idx

    def __getitem__(self, t):
        return self.token_to_idx[t]


def k_closest_tokens(vocab, vecs, word: str, k: int = 10):
    """Cosine k-NN probe."""
    vecs = np.asarray(vecs)
    unit = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-10)
    sims = unit @ unit[vocab[word]]
    order = np.argsort(-sims)
    return [vocab.idx_to_token[i] for i in order[1: k + 1]]


def adagrad_init(params: dict) -> dict:
    return {k: torch.full_like(v, ADAGRAD_INIT) for k, v in params.items()}


@torch.no_grad()
def adagrad_update(params: dict, grads: dict, acc: dict, lr: float) -> None:
    """``optax.adagrad(lr)`` in place: ``acc += g^2``; ``p -= lr g /
    sqrt(acc + eps)`` where ``acc > 0``."""
    for k, p in params.items():
        g = grads[k]
        acc[k].addcmul_(g, g)
        scale = torch.where(acc[k] > 0, torch.rsqrt(acc[k] + ADAGRAD_EPS),
                            torch.zeros((), device=g.device))
        p.sub_(lr * scale * g)


def make_step(model, params: dict, acc: dict, lr: float):
    """``step(center, context, negatives) -> mean loss`` (a device scalar):
    the gradient of the mean pair loss, then AdaGrad in place."""
    names = list(params)

    def step(center, context, negatives):
        leaves = [params[k].requires_grad_(True) for k in names]
        loss = model.loss(params, center, context, negatives).mean()
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        adagrad_update(params, dict(zip(names, grads)), acc, lr)
        return loss.detach()

    return step


def train(args: argparse.Namespace):
    """Train and export; returns ``(params, vocab, vecs)``."""
    from tennis_torch.inference import resolve_device
    from tennis_torch.models.skipgram import SkipGram

    from tennis_torch.native import HAVE_NATIVE, center_context_pairs

    device = resolve_device(args.device)
    sentences = load_corpus(args.root, args.add_extra)
    counter = Counter(t for s in sentences for t in s)
    vocab = EmbeddingVocab(counter)
    coded = [[vocab[t] for t in s if t in vocab] for s in sentences]
    log.info("# sentences: %d, vocab: %d, native batch ops: %s",
             len(sentences), len(vocab), HAVE_NATIVE)

    model = SkipGram(
        vocab_size=len(vocab), num_buckets=args.ngram_buckets,
        emb_size=args.emb_size, counts=vocab.idx_to_counts,
        num_negatives=args.num_negatives, idx_to_token=vocab.idx_to_token,
        device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    step = make_step(model, params, adagrad_init(params), args.lr)
    negatives = torch.Generator(device=device).manual_seed(args.seed + 1)

    B = args.batch_size
    for epoch in range(1, args.epochs + 1):
        tic = time.time()
        centers, contexts = center_context_pairs(coded, args.window,
                                                 seed=args.seed + epoch)
        log.info("prepare pairs (epoch %d): %.2fs", epoch, time.time() - tic)
        perm = np.random.default_rng(args.seed + epoch).permutation(
            len(centers))
        centers = torch.from_numpy(centers[perm]).to(device)
        contexts = torch.from_numpy(contexts[perm]).to(device)
        n_batches = len(centers) // B
        log.info("epoch %d: %d pairs, %d batches", epoch, len(centers),
                 n_batches)
        tic = time.time()
        loss_sum, word_count = torch.zeros((), device=device), 0
        for i in range(n_batches):
            c, x = centers[i * B:(i + 1) * B], contexts[i * B:(i + 1) * B]
            loss_sum += step(c, x, model.sample_negatives(negatives, B))
            word_count += B
            if i % args.log_interval == 0 and i > 0:
                wps = word_count / (time.time() - tic)
                log.info("epoch %d, iter %d, loss %.2f, %.2fK wps", epoch, i,
                         float(loss_sum) / args.log_interval, wps / 1000)
                tic, word_count = time.time(), 0
                loss_sum.zero_()

        vecs = model.token_vectors(params).cpu().numpy()
        if args.probe_word in vocab:
            log.info('closest tokens to "%s": %s', args.probe_word,
                     ", ".join(k_closest_tokens(vocab, vecs,
                                                args.probe_word)))

    vecs = model.token_vectors(params).cpu().numpy()
    name = "embeddings-ex.txt" if args.add_extra else "embeddings.txt"
    save_path = os.path.join(args.root, name)
    if args.overwrite or not os.path.exists(save_path):
        with open(save_path, "w", encoding="utf-8") as f:
            for i, word in enumerate(vocab.idx_to_token):
                f.write("%s %s\n" % (word, " ".join(str(x) for x in vecs[i])))
        log.info("wrote %s", save_path)

    if args.tsne:
        try:
            from sklearn.manifold import TSNE

            perplexity = min(40, max(2, len(vocab) - 1))
            pts = TSNE(n_components=2, perplexity=perplexity,
                       init="random").fit_transform(vecs)
            with open(os.path.join(args.root, "embs-for-vis.txt"), "w") as f:
                f.write('"word","x","y"\n')
                for i, t in enumerate(vocab.idx_to_token):
                    f.write('"%s",%f,%f\n' % (t, pts[i, 0], pts[i, 1]))
        except Exception as e:  # scikit-learn is optional
            log.warning("t-SNE export skipped: %s", e)

    return params, vocab, vecs


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
