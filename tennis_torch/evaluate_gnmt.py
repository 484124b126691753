"""Captioning evaluator (counterpart of ``tennis_tpu/evaluate_gnmt.py``),
features path.

Reads the experiment's ``best_test_out.txt`` when it exists (unless
``--force``); otherwise loads ``valid_best.params`` (written by either
package), beam-decodes the test split in buckets (the encoder's GRU
recurrences through the CUDA kernel on a GPU) and writes that file. Then it
scores the hypotheses with the NLG suite and, with ``--metrics_out``, dumps
the suite as JSON: Bleu_1..4, METEOR and ROUGE_L as fractions in [0, 1],
CIDEr on the pycocoevalcap scale (its internal x10 applied).

Run: ``python -m tennis_torch.evaluate_gnmt --model_id 0102 --feats_model
0006 --num_hidden 256`` (``--device cpu`` off the GPU).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from tennis_torch.train_gnmt import _bool, build_model, \
    decode_split, feature_dim, make_datasets, make_loader, make_translator, \
    parser, refuse_unported

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
    """The NLG suite of the experiment's test hypotheses. ``datasets``
    (train, val, test) replaces the on-disk splits, as in
    ``train_gnmt.train``."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.inference import resolve_device
    from tennis_torch.metrics.nlg import nlg_metric_suite
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.captioning import read_sentences, write_sentences
    from tennis_torch.utils.experiments import experiment_dir, setup_logging

    refuse_unported(args)
    device = resolve_device(args.device)
    exp_dir = experiment_dir("captioning", args.model_id)
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
        model = build_model(args, len(vocab), feature_dim(data_test))
        tree = ckpt.load_raw(best_path)
        load_flax(model, {"params": tree["params"],
                          "batch_stats": tree.get("batch_stats", {})})
        model.to(device).eval()
        log.info("loaded %s", best_path)
        hyps = decode_split(make_translator(args, model, vocab), vocab, loader,
                            device)
        write_sentences(hyps, cached)

    suite = nlg_metric_suite([[t] for t in test_tgt], hyps)
    for k, v in suite.items():
        log.info("test %s=%.4f", k, v)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(suite, f)
    return suite


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
