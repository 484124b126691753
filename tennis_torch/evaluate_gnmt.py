"""Captioning evaluator (counterpart of ``tennis_tpu/evaluate_gnmt.py``),
features and pixels paths.

Reads the experiment's ``best_test_out.txt`` when it exists (unless
``--force``); otherwise loads ``valid_best.params`` (written by either
package), beam-decodes the test split in buckets (the encoder's GRU
recurrences through the CUDA kernel on a GPU; on the pixels path the
``src_embed`` DenseNet's dense layers through the f32 dense-layer kernel)
and writes that file. Then it
scores the hypotheses with the NLG suite and, with ``--metrics_out``, dumps
the suite as JSON: Bleu_1..4, METEOR and ROUGE_L as fractions in [0, 1],
CIDEr on the pycocoevalcap scale (its internal x10 applied).

``--num_devices N`` (N > 1) shards the beam decode over N ranks, as the
JAX evaluator shards it over its mesh: each rank decodes its rows of every
test batch (padded to a multiple of N) and the sentences are gathered;
only rank 0 writes ``best_test_out.txt`` and ``--metrics_out``.

Run: ``python -m tennis_torch.evaluate_gnmt --model_id 0102 --feats_model
0006 --num_hidden 256`` (``--device cpu`` off the GPU).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from tennis_torch.train_gnmt import _bool, build_model, decode_split, \
    feature_dim, make_datasets, make_loader, make_translator, parser, \
    refuse_unported

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = parser()
    p.add_argument("--force", type=_bool, nargs="?", const=True,
                   default=False,
                   help="re-decode even if best_test_out.txt exists")
    p.add_argument("--metrics_out", default="",
                   help="optional path: dump the NLG metric suite as JSON")
    return p.parse_args(argv)


def evaluate(args: argparse.Namespace, datasets=None) -> dict:
    """The NLG suite of the experiment's test hypotheses (rank 0's under
    ``--num_devices > 1``). ``datasets`` (train, val, test) replaces the
    on-disk splits, as in ``train_gnmt.train``."""
    from tennis_torch.parallel.distributed import rank_environment, \
        run_ranks

    refuse_unported(args)
    ranks, kw = rank_environment(args, max(args.num_devices, 1))
    return run_ranks("tennis_torch.evaluate_gnmt:run_rank", (args, datasets),
                     ranks, kw)


def run_rank(args: argparse.Namespace, datasets=None) -> dict:
    """:func:`evaluate` on this rank of the world."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.inference import fold_densenets, resolve_device
    from tennis_torch.metrics.nlg import nlg_metric_suite
    from tennis_torch.parallel.distributed import current_world
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.captioning import read_sentences, write_sentences
    from tennis_torch.utils.experiments import experiment_dir, setup_logging

    world = current_world(resolve_device(args.device))
    device = world.device
    exp_dir = experiment_dir("captioning", args.model_id)
    if world.is_main:
        setup_logging(exp_dir, vars(args))

    data_train, _, data_test = datasets or make_datasets(args)
    vocab = data_train.vocab
    test_tgt = data_test.get_captions(split=True)

    cached = os.path.join(exp_dir, "best_test_out.txt")
    if os.path.exists(cached) and not args.force:
        log.info("reusing cached predictions %s", cached)
        hyps = read_sentences(cached)
    else:
        loader = make_loader(args, data_test, "test")
        if len(loader) == 0:
            raise SystemExit("test loader produced zero batches: no test "
                             "captions under --root")
        best_path = os.path.join(exp_dir, "valid_best.params")
        if not os.path.exists(best_path):
            raise FileNotFoundError(f"{best_path} (train first)")
        model = build_model(args, len(vocab), feature_dim(data_test)
                            if args.feats_model else None)
        tree = ckpt.load_raw(best_path)
        load_flax(model, {"params": tree["params"],
                          "batch_stats": tree.get("batch_stats", {})})
        model.to(device).eval()
        fold_densenets(model)
        log.info("loaded %s", best_path)
        hyps = decode_split(make_translator(args, model, vocab), vocab,
                            loader, device)
        if world.is_main:
            write_sentences(hyps, cached)

    suite = nlg_metric_suite([[t] for t in test_tgt], hyps)
    for k, v in suite.items():
        log.info("test %s=%.4f", k, v)
    if args.metrics_out and world.is_main:
        with open(args.metrics_out, "w") as f:
            json.dump(suite, f)
    return suite


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
