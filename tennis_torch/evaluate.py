"""Event-classifier evaluation driver (counterpart of
``tennis_tpu/evaluate.py``).

Takes the ``train`` flag surface plus ``--split`` and ``--metrics_out``.
Loads the experiment's best epoch (``scores.txt``, else the newest), scores
``--split`` with test-time settings and returns the per-frame probabilities
keyed by image path, the ground truths and the metric set; logs PRF1 with
its confusion matrix and writes the PRF1 dict as JSON to ``--metrics_out``.
``--temp_pool max|mean`` scores the donor named by ``--feats_model`` (its
dumped features) or ``--backbone_from_id`` (frames through its backbone)
with its features pooled over ``--window`` and its own head applied.
``--save_feats`` dumps the features of ``--split`` only (a ``FrameModel``'s;
the CNN-RNN and the two-stream net raise ``ValueError``, as in the JAX
driver). The model is the one the flags compose (``train.build_model``):
R(2+1)D over clips (``--backbone rdnet --window 8|32``), the CNN-RNN over
features or clips (``--window > 1 --temp_pool gru|lstm``), the two-stream
net (``--flow twos|only``), the 6-channel backbone (``--flow sixc``) or the
framewise classifier over a DenseNet or ResNet-v2. ``--vis`` renders the
scored frames with their probabilities into ``<experiment>/results.mp4``
(``utils.visualisation.visualise_events``).

It runs on every local GPU, as the JAX evaluator runs over every local
device (one rank with ``--device cpu``), and ``--multihost --coordinator
host:port --num_hosts H --host_id h`` joins H hosts: each rank scores its
stripe of every global batch, the rows of every rank are gathered
(``sharded_eval_iter``), and only global rank 0 writes ``--metrics_out``
and ``--vis``; under ``--save_feats`` each rank writes its own rows.

Run: ``python -m tennis_torch.evaluate --model_id 0006 --backbone
DenseNet121`` (``--device cpu`` off the GPU; add the training flags of the
experiment, e.g. ``--feats_model 0006 --temp_pool gru --window 30`` or
``--flow twos``).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from tennis_torch import train as train_driver

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = train_driver.add_flags(
        argparse.ArgumentParser(description="Event-classifier evaluation"))
    p.add_argument("--split", default="test",
                   help="the split to evaluate on: train, val, or test")
    p.add_argument("--metrics_out", default="",
                   help="optional path: dump the PRF1 metric dict as JSON")
    return p.parse_args(argv)


def evaluate_model(args: argparse.Namespace):
    """Returns ``(results, gts, metrics)``: probabilities and labels keyed
    by ``frames/<video>.mp4/<chunk>/<frame>.jpg``, and the metric set; three
    empty dicts under ``--save_feats``. Runs on every rank of the world
    the flags make; returns rank 0's."""
    from tennis_torch.parallel.distributed import rank_environment, \
        run_ranks

    pool = args.temp_pool if args.temp_pool in ("max", "mean") else None
    if pool and args.window <= 1:
        raise ValueError("--temp_pool max|mean needs --window > 1")
    if pool and args.save_feats:
        raise ValueError("--save_feats cannot combine with --temp_pool "
                         "max|mean: the pooled wrap has no per-frame feature "
                         "dump (dump from the donor experiment instead)")
    # every local device, as the JAX evaluator's make_mesh() takes
    local, kw = rank_environment(args, -1, args.batch_size)
    return run_ranks("tennis_torch.evaluate:run_rank", (args,), local, kw)


def run_rank(args: argparse.Namespace):
    """:func:`evaluate_model` on this rank of the world."""
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.data.tennis_set import get_image_path
    from tennis_torch.inference import make_eval_step, \
        make_extract_features, resolve_device
    from tennis_torch.parallel.distributed import current_world, \
        host_batch_slice
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir, setup_logging

    pool = args.temp_pool if args.temp_pool in ("max", "mean") else None
    world = current_world(resolve_device(args.device))
    device = world.device
    exp_dir = experiment_dir("vision", args.model_id)
    if world.is_main:
        setup_logging(exp_dir, vars(args))

    test_set = train_driver.make_eval_dataset(args, args.split)
    log.info(test_set)
    feats = bool(args.feats_model)
    # the pooled wrap loads the framewise donor; the rest, the model the
    # flags compose
    model = train_driver.build_model(args, test_set.num_class,
                                     feats and not pool)
    loader = DataLoader(
        test_set, batch_size=host_batch_slice(args.batch_size),
        shuffle=False, num_workers=train_driver._num_workers(args, 8),
        num_shards=world.data_size, shard_id=world.data_rank,
        transform=None if feats else
        train_driver._geometry_transform(args, False))

    src_dir = exp_dir  # the pooled wrap scores the donor's checkpoint
    if pool and args.feats_model:
        src_dir = experiment_dir("vision", args.feats_model)
    elif pool and args.backbone_from_id:
        src_dir = experiment_dir("vision", args.backbone_from_id)
    epoch, score = ckpt.best_or_latest(src_dir)
    train_driver.load_epoch(model, src_dir, epoch)
    log.info("loaded epoch %d (score=%s) from %s", epoch, score, src_dir)

    if args.save_feats:
        train_driver.refuse_feature_dump(model)
        train_driver.save_features(make_extract_features(model, device),
                                   [test_set], {args.split: loader}, device)
        return {}, {}, {}

    step = make_eval_step(model, device, pool=pool, feats=feats)
    metrics = train_driver._metric_set(test_set.classes)
    results, gts = {}, {}
    tic = time.time()
    for probs, labels, idxs in train_driver.eval_batches(
            loader, lambda x: torch.softmax(step(x), dim=-1), device):
        for m in metrics.values():
            m.update(labels, probs)
        for p, label, idx in zip(probs, labels, idxs):
            sample = test_set._samples[int(idx)]
            img_path = get_image_path("frames", sample[0], sample[1])
            results[img_path] = p
            gts[img_path] = int(label)
    log.info("evaluated %d frames in %.1fs", len(results), time.time() - tic)
    for name, value in metrics["prf1"].get():
        log.info("test %s=%.4f", name, value)
    log.info("confusion:\n%s", metrics["prf1"].confusion_str())
    if args.metrics_out and world.is_main:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics["prf1"].get_dict(), f)
    if args.vis and world.is_main:
        from tennis_torch.utils.visualisation import visualise_events

        out_path = os.path.join(exp_dir, "results.mp4")
        visualise_events(test_set, results, out_path)
        log.info("wrote %s", out_path)
    return results, gts, metrics


def main(argv=None):
    return evaluate_model(parse_args(argv))


if __name__ == "__main__":
    main()
