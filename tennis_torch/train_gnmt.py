"""Captioning trainer (counterpart of ``tennis_tpu/train_gnmt.py``),
features path.

The flags are the JAX trainer's, with the same names and defaults, parsed
with argparse (``parse_args``; the serving loader reads a checkpoint's
``--gnmt_flag`` arguments through it), plus ``--device`` (``cuda`` by
default; asking for it without a GPU raises).

``train`` runs the JAX loop: the captions-mode ``TennisSet`` splits over
``--feats_model`` features (the train split's vocabulary), three bucketed
loaders (val and test bucketed on caption length, time axes padded to
multiples of 8) through the pinned prefetch, the ``tgt_embed`` init from
``<root>/<--emb_file>``, Adam with global-norm clipping at an injected
learning rate, the quarantining resume (the learning rate read back from
the restored state), then per epoch: the train steps (dropout masks drawn
from a host seed of ``default_rng(seed + 1)`` a step; ``--log_interval``,
``--max_batches``), on val and test the teacher-forced loss and the beam
decode (its encoder's GRU recurrences through the CUDA kernel on a GPU, as
the translator decodes), the NLG suite and the ``epoch{N}_*_out.txt`` files,
the learning-rate decay of the last third, the epoch file and its
``scores.txt`` row, and ``valid_best.params`` and ``best_test_out.txt`` on a
new best BLEU-4. The files are the JAX package's, so either package resumes
or evaluates the other's. The train step runs the GRU through a plain
differentiable recurrence, as the JAX package trains through its scan.

The pixels path (a DenseNet ``src_embed``: ``--pretrained_npz``,
``--freeze_backbone``, ``--backbone_from_id``) and ``--num_devices > 1``
raise ``NotImplementedError``.

Run: ``python -m tennis_torch.train_gnmt --model_id 0102 --feats_model 0006
--num_hidden 256`` (``--device cpu`` off the GPU).
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def _bool(value: str) -> bool:
    if value.lower() in ("1", "true", "t", "yes"):
        return True
    if value.lower() in ("0", "false", "f", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GNMT captioner flags")
    add = p.add_argument
    add("--root", default="data", help="Dataset root")
    add("--model_id", default="0000", help="model id")
    add("--epochs", type=int, default=40, help="training epochs")
    add("--num_hidden", type=int, default=128, help="state dim")
    add("--emb_size", type=int, default=100, help="embedding dim")
    add("--dropout", type=float, default=0.2, help="dropout")
    add("--num_layers", type=int, default=2, help="encoder/decoder layers")
    add("--num_bi_layers", type=int, default=1, help="bidirectional layers")
    add("--cell_type", default="gru", choices=["gru", "lstm"],
        help="gru or lstm")
    add("--batch_size", type=int, default=128, help="train batch size")
    add("--beam_size", type=int, default=4, help="beam size")
    add("--lp_alpha", type=float, default=1.0, help="length penalty alpha")
    add("--lp_k", type=int, default=5, help="length penalty K")
    add("--test_batch_size", type=int, default=32, help="eval batch size")
    add("--num_buckets", type=int, default=5, help="bucket count")
    add("--bucket_scheme", default="constant", help="constant|linear|exp")
    add("--bucket_ratio", type=float, default=0.0,
        help="bucket throughput ratio")
    add("--tgt_max_len", type=int, default=50, help="max caption length")
    add("--optimizer", default="adam", help="optimizer")
    add("--lr", type=float, default=1e-3, help="learning rate")
    add("--lr_update_factor", type=float, default=0.5, help="LR decay factor")
    add("--clip", type=float, default=5.0, help="gradient clip")
    add("--log_interval", type=int, default=100, help="log every N batches")
    add("--num_devices", "--num_gpus", dest="num_devices", type=int,
        default=-1, help="devices (num_gpus analogue)")
    add("--backbone", default="DenseNet121", help="CNN backbone (pixels path)")
    add("--backbone_from_id", default=None,
        help="backbone weights source exp id")
    add("--freeze_backbone", type=_bool, nargs="?", const=True, default=False,
        help="freeze backbone")
    add("--data_shape", type=int, default=512, help="input crop side")
    add("--every", type=int, default=1, help="every nth frame")
    add("--feats_model", default=None,
        help="load features from this model id")
    add("--emb_file", default="embeddings-ex.txt",
        help="word-embedding file from train_embeddings.py")
    add("--num_workers", type=int, default=8, help="loader threads")
    add("--frames_cache", type=int, default=0,
        help="pixels path: read the pre-resized frames mirror")
    add("--remat", default="none", choices=["none", "block", "hires", "growth"],
        help="pixels path: dense-block rematerialization")
    add("--pretrained_npz", default=None,
        help="pixels path: converted pretrained backbone weights (.npz)")
    add("--seed", type=int, default=100, help="rng seed")
    add("--max_batches", type=int, default=-1, help="debug batch limit")
    add("--device", default="cuda", choices=["cuda", "cpu"],
        help="Device the model runs on")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return parser().parse_args(argv)


def build_model(args: argparse.Namespace, vocab_size: int, feat_dim: int,
                generator: torch.Generator | None = None):
    """The features-path ``NMTModel`` the flags describe (f32, CPU), with
    ``--dropout`` in its train mode."""
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder

    if not args.feats_model:
        raise ValueError("only the features-path captioner is ported "
                         "(--feats_model=<vision exp id>)")
    encoder, decoder = get_gnmt_encoder_decoder(
        cell_type=args.cell_type, num_layers=args.num_layers,
        num_bi_layers=args.num_bi_layers, hidden_size=args.num_hidden,
        input_size=feat_dim, embed_size=args.emb_size, generator=generator,
        dropout=args.dropout)
    return NMTModel(vocab_size, encoder, decoder, embed_size=args.emb_size,
                    hidden_size=args.num_hidden, generator=generator)


def refuse_unported(args: argparse.Namespace):
    """Raise for what the port does not train yet."""
    if args.num_devices > 1:
        raise NotImplementedError("--num_devices > 1 is not ported yet "
                                  "(ROADMAP.md slice 9)")
    if args.pretrained_npz and args.feats_model:
        raise ValueError(
            "--pretrained_npz needs the pixels path; --feats_model consumes "
            "precomputed features and has no CNN src_embed to initialize")
    if not args.feats_model:
        raise NotImplementedError(
            "the pixels-path captioner (a DenseNet src_embed over frames, "
            "--pretrained_npz, --freeze_backbone, --backbone_from_id) is not "
            "ported yet (ROADMAP.md slice 6): pass --feats_model=<vision "
            "exp id>")


def make_datasets(args):
    """(train, val, test) captions-mode splits over ``--feats_model``
    features; val and test index into the train split's vocabulary, keep
    whole captions and return sample indices."""
    from tennis_torch.data.tennis_set import TennisSet

    common = dict(root=args.root, captions=True, every=args.every,
                  feats_model=args.feats_model or None)
    train = TennisSet(split="train", max_cap_len=args.tgt_max_len, **common)
    val = TennisSet(split="val", vocab=train.vocab, inference=True, **common)
    test = TennisSet(split="test", vocab=train.vocab, inference=True, **common)
    return train, val, test


def make_loader(args, dataset, split: str):
    """The bucketed loader of a split: the train split shuffled by
    ``--seed`` and bucketed on frames, val and test in order and bucketed
    on caption length; time axes padded to multiples of 8."""
    from tennis_torch.data.bucketing import BucketedCaptionLoader

    train = split == "train"
    return BucketedCaptionLoader(
        dataset, args.batch_size if train else args.test_batch_size,
        args.num_buckets, args.bucket_scheme, args.bucket_ratio,
        shuffle=train, seed=args.seed if train else 0,
        num_workers=args.num_workers, pad_multiple=8,
        key_element=0 if train else -1)


def feature_dim(dataset) -> int:
    return int(np.asarray(dataset[0][0]).shape[-1])


def make_translator(args, model, vocab):
    from tennis_torch.translation import BeamSearchTranslator

    return BeamSearchTranslator(
        model, bos_id=vocab[vocab.bos_token], eos_id=vocab[vocab.eos_token],
        beam_size=args.beam_size, alpha=args.lp_alpha, K=args.lp_k,
        max_length=args.tgt_max_len + 20)


def decode_split(translator, vocab, loader, device, on_batch=None):
    """Beam-decode every point of ``loader``'s split: the top hypotheses
    as token lists, in dataset order. ``on_batch(src, tgt, src_vl,
    tgt_vl)`` (device tensors) runs before each batch's decode."""
    from tennis_torch.data.loader import prefetch_to_device

    hyps, order = [], []
    for src, tgt, src_vl, tgt_vl, idxs in prefetch_to_device(
            iter(loader), device, moved=4):
        if on_batch is not None:
            on_batch(src, tgt, src_vl, tgt_vl)
        hyps.extend(translator.translate_tokens(src, src_vl, vocab))
        order.extend(np.asarray(idxs).tolist())
    ordered = [None] * len(hyps)
    for pos, ds_idx in enumerate(order):
        ordered[ds_idx] = hyps[pos]
    return ordered


def train(args: argparse.Namespace, datasets=None):
    """Train the captioner the flags describe from the newest readable
    epoch of ``models/captioning/experiments/<model_id>`` to ``--epochs``;
    returns the train state. ``datasets`` (train, val, test) replaces the
    on-disk splits: objects with the captions-mode ``TennisSet`` surface
    (``vocab``, ``get_captions``, ``get_data_lens``, items)."""
    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.data.vocab import load_embeddings
    from tennis_torch.inference import resolve_device
    from tennis_torch.metrics.nlg import nlg_metric_suite
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.captioning import get_comp_str, write_sentences
    from tennis_torch.utils.experiments import experiment_dir, \
        setup_logging, summary_writer

    refuse_unported(args)
    device = resolve_device(args.device)
    exp_dir = experiment_dir("captioning", args.model_id)
    setup_logging(exp_dir, vars(args))

    data_train, data_val, data_test = datasets or make_datasets(args)
    vocab = data_train.vocab
    log.info("vocab size %d", len(vocab))
    log.info(data_train.stats())

    val_tgt = data_val.get_captions(split=True)
    test_tgt = data_test.get_captions(split=True)
    write_sentences(val_tgt, os.path.join(exp_dir, "val_gt.txt"))
    write_sentences(test_tgt, os.path.join(exp_dir, "test_gt.txt"))

    loaders = {split: make_loader(args, ds, split) for split, ds in
               (("train", data_train), ("val", data_val), ("test", data_test))}
    if len(loaders["train"]) == 0:
        raise SystemExit("train loader produced zero batches: add training "
                         "captions")
    model = build_model(args, len(vocab), feature_dim(data_train),
                        generator=torch.Generator().manual_seed(args.seed))
    log.info("params: %.2fM", ckpt.param_count(model) / 1e6)

    emb_path = os.path.join(args.root, args.emb_file) if args.emb_file else None
    if emb_path and os.path.exists(emb_path):
        emb = load_embeddings(emb_path, vocab, args.emb_size)
        with torch.no_grad():
            model.tgt_embed.weight.copy_(torch.from_numpy(emb))
        log.info("loaded tgt embeddings from %s", emb_path)
    elif args.emb_file:
        log.warning("embedding file %s not found; training tgt_embed from "
                    "scratch", emb_path)
    model.to(device)

    lr = args.lr
    tx = adam_with_clip(args.clip, args.optimizer)
    state = create_seq2seq_state(model, tx, lr)
    start_epoch = ckpt.resume_state(exp_dir,
                                    lambda tree: state_from_flax(state, tree))
    if start_epoch > 0:
        # keep compounding the decay from the restored learning rate
        lr = state.opt_state.learning_rate
        log.info("resumed from epoch %d (lr %g)", start_epoch - 1, lr)
    train_step = make_seq2seq_train_step(state, masked_ce_loss)
    translator = make_translator(args, model, vocab)
    log.info("beam_size=%d alpha=%.2f K=%d", args.beam_size, args.lp_alpha,
             args.lp_k)

    def evaluate(split, tgt_sentences):
        """(mean teacher-forced loss, NLG suite, hypotheses in dataset
        order) of a split."""
        model.eval()
        losses = []

        def loss_of(src, tgt, src_vl, tgt_vl):
            with torch.no_grad():
                logits = model(src, tgt[:, :-1], src_vl, tgt_vl - 1)
                losses.append(masked_ce_loss(logits, tgt[:, 1:], tgt_vl - 1))

        hyps = decode_split(translator, vocab, loaders[split], device,
                            on_batch=loss_of)
        losses = torch.stack(losses).cpu().numpy().tolist()
        suite = nlg_metric_suite([[t] for t in tgt_sentences], hyps)
        return float(np.mean(losses)), suite, hyps

    tb = summary_writer(exp_dir)
    best_bleu = -1.0
    seed_rng = np.random.default_rng(args.seed + 1)
    try:
        with ckpt.AsyncCheckpointer() as writer:
            for epoch in range(start_epoch, args.epochs):
                loaders["train"].set_epoch(epoch)
                tic = time.time()
                n_tokens, n_batches = 0, 0
                for src, tgt, src_vl, tgt_vl in prefetch_to_device(
                        iter(loaders["train"]), device, moved=4):
                    loss = train_step(src, tgt, src_vl, tgt_vl,
                                      np.uint32(seed_rng.integers(2 ** 31)))
                    n_batches += 1
                    n_tokens += tgt_vl.sum()  # on the device: no wait
                    if n_batches % args.log_interval == 0 or n_batches == 1:
                        loss_v = float(loss)
                        wps = float(n_tokens) / max(time.time() - tic, 1e-6)
                        log.info("[Epoch %d][Batch %d] loss=%.4f ppl=%.2f "
                                 "%.1fK wps", epoch, n_batches, loss_v,
                                 np.exp(min(loss_v, 20)), wps / 1000)
                        if tb:
                            tb.add_scalar("train/loss", loss_v,
                                          epoch * 10000 + n_batches)
                    if 0 < args.max_batches <= n_batches:
                        break

                val_loss, val_suite, val_hyps = evaluate("val", val_tgt)
                test_loss, test_suite, test_hyps = evaluate("test", test_tgt)
                bleu4 = val_suite["Bleu_4"] * 100
                log.info("[Epoch %d] val loss=%.4f BLEU4=%.2f suite=%s "
                         "(%.1fs)", epoch, val_loss, bleu4,
                         {k: round(v, 4) for k, v in val_suite.items()},
                         time.time() - tic)
                if tb:
                    for k, v in val_suite.items():
                        tb.add_scalar(f"val/{k}", v, epoch)
                    for k, v in test_suite.items():
                        tb.add_scalar(f"test/{k}", v, epoch)
                    tb.add_text("val/captions",
                                get_comp_str(val_tgt[:8], val_hyps[:8]), epoch)
                write_sentences(val_hyps, os.path.join(
                    exp_dir, f"epoch{epoch}_val_out.txt"))
                write_sentences(test_hyps, os.path.join(
                    exp_dir, f"epoch{epoch}_test_out.txt"))
                # the decay of the last third, set before the epoch file so
                # that the saved rate is the one the next epoch trains with
                if epoch + 1 >= (args.epochs * 2) // 3:
                    lr *= args.lr_update_factor
                    state.opt_state.learning_rate = lr
                    log.info("lr decayed to %g", lr)
                tree = state_to_flax(state)
                writer.save(ckpt.epoch_path(exp_dir, epoch), tree)
                # the scores.txt row lands only after its epoch file
                writer.submit(
                    lambda e=epoch, s=bleu4: ckpt.append_score(exp_dir, e, s))
                if bleu4 > best_bleu:
                    best_bleu = bleu4
                    # no optimizer state: the evaluator reads the weights only
                    writer.save(os.path.join(exp_dir, "valid_best.params"),
                                {"batch_stats": tree["batch_stats"],
                                 "params": tree["params"]})
                    write_sentences(test_hyps, os.path.join(
                        exp_dir, "best_test_out.txt"))
                    log.info("new best BLEU4 %.2f at epoch %d", bleu4, epoch)
    finally:
        if tb:
            tb.close()
    return state


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
