"""Captioning trainer (counterpart of ``tennis_tpu/train_gnmt.py``),
features and pixels paths.

The flags are the JAX trainer's, with the same names and defaults, parsed
with argparse (``parse_args``; the serving loader reads a checkpoint's
``--gnmt_flag`` arguments through it), plus ``--device`` (``cuda`` by
default; asking for it without a GPU raises).

``train`` runs the JAX loop: the captions-mode ``TennisSet`` splits over
``--feats_model`` features or, without it, over frames (the pixels path:
the train split's frames through ``train_geometry`` from a
``ThreadLocalRng(--seed)``, val's and test's through ``test_geometry``
decoded at ``--data_shape + 32``, ``--frames_cache`` on every split; the
train split's vocabulary in each), three bucketed
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

The pixels path builds ``--backbone`` (a DenseNet, with ``--remat``, or a
ResNet-v2) in f32 as ``src_embed``, as the JAX driver does: its train step
augments the uint8 frames on the device and runs the backbone in train mode
(plain torch ops and cuDNN convolutions, which PyTorch runs in TF32 on the
card unless ``torch.backends.cudnn.allow_tf32`` is turned off; the
matrix products stay f32); its eval forward in the decodes runs every
DenseNet dense layer through the f32 dense-layer kernel on the card.
``--backbone_from_id`` grafts a vision experiment's newest ``backbone``
(parameters and statistics) onto ``src_embed``, checked for structure;
``--freeze_backbone`` leaves ``src_embed`` out of the clip and the update.
``--pretrained_npz`` loads a converted ``.npz`` into ``src_embed`` first
(:func:`load_pretrained_src_embed`), so a ``--backbone_from_id`` graft
overrides it, as in the JAX driver.

``--num_devices N`` (N > 1; the default ``-1`` is one device, as in the
JAX trainer) trains data-parallel on N ranks (N GPUs, or N gloo ranks with
``--device cpu``): every rank builds the same bucketed loader, whose batch
sizes are multiples of N, and takes its contiguous rows of each global
batch (padded to that batch's lengths); the gradients are averaged over
the ranks before the clip; the per-epoch decodes deal out each padded
batch's rows and gather the sentences; only rank 0 writes the
experiment's files.

Run: ``python -m tennis_torch.train_gnmt --model_id 0102 --feats_model 0006
--num_hidden 256``, or on the pixels path ``--backbone DenseNet121
--backbone_from_id 0006 --freeze_backbone --remat block`` without
``--feats_model`` (``--device cpu`` off the GPU).
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


def build_model(args: argparse.Namespace, vocab_size: int,
                feat_dim: int | None = None,
                generator: torch.Generator | None = None):
    """The ``NMTModel`` the flags describe (f32, CPU), with ``--dropout`` in
    its train mode: over ``feat_dim``-d features with ``--feats_model``,
    else with an f32 ``--backbone`` as ``src_embed`` (``--remat`` for a
    DenseNet), whose feature size sets the encoder's input."""
    from tennis_torch.models import backbone_feature_dim, get_backbone
    from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder

    src_embed = None
    if not args.feats_model:
        src_embed = get_backbone(
            args.backbone, dtype=torch.float32,
            remat=None if args.remat == "none" else args.remat,
            generator=generator)
        feat_dim = backbone_feature_dim(args.backbone, args.data_shape)
    encoder, decoder = get_gnmt_encoder_decoder(
        cell_type=args.cell_type, num_layers=args.num_layers,
        num_bi_layers=args.num_bi_layers, hidden_size=args.num_hidden,
        input_size=feat_dim, embed_size=args.emb_size, generator=generator,
        dropout=args.dropout)
    return NMTModel(vocab_size, encoder, decoder, embed_size=args.emb_size,
                    hidden_size=args.num_hidden, generator=generator,
                    src_embed=src_embed)


def refuse_jax_flag_sets(args: argparse.Namespace):
    """Raise ``ValueError`` for the flag sets the JAX driver refuses."""
    if args.pretrained_npz and args.feats_model:
        raise ValueError(
            "--pretrained_npz needs the pixels path; --feats_model consumes "
            "precomputed features and has no CNN src_embed to initialize")


def load_pretrained_src_embed(model, args) -> int:
    """Load the converted ``--pretrained_npz`` table into the pixels-path
    ``src_embed`` (the JAX driver's ImageNet init of its CNN); returns the
    number of arrays loaded, and raises ``ValueError`` when nothing
    matched."""
    from tennis_torch.models.convert import load_npz

    with np.load(args.pretrained_npz) as f:
        n = load_npz(model, dict(f), ["src_embed"])
    if n == 0:
        raise ValueError(
            f"no arrays from {args.pretrained_npz} matched src_embed — "
            f"wrong conversion for --backbone={args.backbone}?")
    log.info("loaded %d pretrained src_embed arrays from %s", n,
             args.pretrained_npz)
    return n


def make_datasets(args):
    """(train, val, test) captions-mode splits over ``--feats_model``
    features or, on the pixels path, over frames: the train split's through
    ``train_geometry`` (a ``ThreadLocalRng(--seed)``: the loader's workers
    are threads), val's and test's through ``test_geometry``, decoded at
    ``--data_shape + 32``; ``--frames_cache`` on every split. Val and test
    index into the train split's vocabulary, keep whole captions and
    return sample indices."""
    from tennis_torch.data import transforms as T
    from tennis_torch.data.tennis_set import TennisSet

    train_transform = test_transform = None
    if not args.feats_model:
        rng = T.ThreadLocalRng(args.seed)

        def train_transform(img):
            return T.train_geometry(img, args.data_shape, rng.get())

        def test_transform(img):
            return T.test_geometry(img, args.data_shape)

    common = dict(root=args.root, captions=True, every=args.every,
                  feats_model=args.feats_model or None,
                  frames_cache=args.frames_cache or None)
    decode_short = args.data_shape + 32
    train = TennisSet(split="train", max_cap_len=args.tgt_max_len,
                      transform=train_transform, **common)
    val = TennisSet(split="val", vocab=train.vocab, inference=True,
                    transform=test_transform, decode_short=decode_short,
                    **common)
    test = TennisSet(split="test", vocab=train.vocab, inference=True,
                     transform=test_transform, decode_short=decode_short,
                     **common)
    return train, val, test


def transplant_backbone(model, args):
    """Graft the ``backbone`` parameters and BN statistics of the newest
    epoch of the vision experiment ``--backbone_from_id`` onto ``src_embed``
    (the JAX driver's ``_transplant_backbone``). A donor without an epoch
    raises ``FileNotFoundError``, one whose trees differ from
    ``src_embed``'s ``ValueError``."""
    from tennis_torch.bridge import from_flax, to_flax
    from tennis_torch.train import _key_paths, read_donor
    from tennis_torch.utils.experiments import experiment_dir

    donor = read_donor(args.backbone_from_id)
    if donor is None:
        raise FileNotFoundError(
            f"no checkpoints under "
            f"{experiment_dir('vision', args.backbone_from_id)}")
    _, latest, raw = donor
    mine = to_flax(model.src_embed)
    params = raw.get("params", {}).get("backbone", {})
    stats = raw.get("batch_stats", {}).get("backbone", {})
    for what, got in (("params", params), ("batch_stats", stats)):
        if what == "batch_stats" and not got:
            continue  # the JAX driver grafts statistics only when it has any
        if _key_paths(got) != _key_paths(mine[what]):
            raise ValueError(
                f"backbone {what} from experiment {args.backbone_from_id} do "
                f"not match this --backbone={args.backbone}: "
                f"{sorted(_key_paths(got) ^ _key_paths(mine[what]))[:4]}")
    model.src_embed.load_state_dict(
        from_flax({"params": params, "batch_stats": stats}),
        strict=bool(stats))
    log.info("transplanted backbone from %s epoch %d", args.backbone_from_id,
             latest)


def make_loader(args, dataset, split: str, batch_multiple: int = 1):
    """The bucketed loader of a split: the train split shuffled by
    ``--seed`` and bucketed on frames, its batch sizes multiples of
    ``batch_multiple``; val and test in order and bucketed on caption
    length; time axes padded to multiples of 8."""
    from tennis_torch.data.bucketing import BucketedCaptionLoader

    train = split == "train"
    return BucketedCaptionLoader(
        dataset, args.batch_size if train else args.test_batch_size,
        args.num_buckets, args.bucket_scheme, args.bucket_ratio,
        shuffle=train, seed=args.seed if train else 0,
        num_workers=args.num_workers, pad_multiple=8,
        batch_multiple=batch_multiple if train else 1,
        key_element=0 if train else -1)


def feature_dim(dataset) -> int:
    """The feature size of a features-path split."""
    return int(np.asarray(dataset[0][0]).shape[-1])


def make_translator(args, model, vocab):
    from tennis_torch.translation import BeamSearchTranslator

    return BeamSearchTranslator(
        model, bos_id=vocab[vocab.bos_token], eos_id=vocab[vocab.eos_token],
        beam_size=args.beam_size, alpha=args.lp_alpha, K=args.lp_k,
        max_length=args.tgt_max_len + 20)


def rank_batches(loader):
    """The batches of ``loader`` as this rank takes them: as they are
    without a process group; else each padded to a multiple of the world
    size (``pad_batch``) with a weight of 1 a loader row and 0 a pad row
    after its four arrays, and this rank's contiguous rows of the arrays
    and the weights (``shard_rows``); the rest (the sample indices) whole."""
    from tennis_torch.parallel.distributed import current_world
    from tennis_torch.parallel.mesh import pad_batch, shard_rows

    world = current_world()
    for batch in iter(loader):
        if not world.grouped:
            yield batch
            continue
        arrays, rest = tuple(batch[:4]), tuple(batch[4:])
        (arrays), n = pad_batch(arrays, world.data_size)
        weights = (np.arange(arrays[0].shape[0]) < n).astype(np.float32)
        yield (*shard_rows((*arrays, weights), world.data_rank,
                           world.data_size),
               *rest)


def decode_split(translator, vocab, loader, device, on_batch=None):
    """Beam-decode every point of ``loader``'s split: the top hypotheses
    as token lists, in dataset order. ``on_batch(src, tgt, src_vl,
    tgt_vl)`` (device tensors; under a process group this rank's rows and,
    last, their weights, 0 on pad rows) runs before each batch's decode.
    Under a process group each rank decodes its rows of each batch
    (:func:`rank_batches`) and the translator gathers every rank's."""
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.parallel.distributed import grouped

    hyps, order = [], []
    for batch in prefetch_to_device(rank_batches(loader), device,
                                    moved=5 if grouped() else 4):
        src, src_vl, idxs = batch[0], batch[2], batch[-1]
        if on_batch is not None:
            on_batch(*batch[:-1])
        toks = translator.translate_tokens(src, src_vl, vocab)
        hyps.extend(toks[:len(idxs)])
        order.extend(np.asarray(idxs).tolist())
    ordered = [None] * len(hyps)
    for pos, ds_idx in enumerate(order):
        ordered[ds_idx] = hyps[pos]
    return ordered


def train(args: argparse.Namespace, datasets=None):
    """Train the captioner the flags describe from the newest readable
    epoch of ``models/captioning/experiments/<model_id>`` to ``--epochs``;
    returns the train state (rank 0's under ``--num_devices > 1``).
    ``datasets`` (train, val, test) replaces the on-disk splits: objects
    with the captions-mode ``TennisSet`` surface (``vocab``,
    ``get_captions``, ``get_data_lens``, items)."""
    from tennis_torch.parallel.distributed import rank_environment, \
        run_ranks

    refuse_jax_flag_sets(args)
    ranks, kw = rank_environment(args, max(args.num_devices, 1),
                                 args.batch_size)
    return run_ranks("tennis_torch.train_gnmt:run_rank", (args, datasets),
                     ranks, kw)


def run_rank(args: argparse.Namespace, datasets=None):
    """:func:`train` on this rank of the world."""
    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.data.vocab import load_embeddings
    from tennis_torch.inference import fold_densenets, resolve_device
    from tennis_torch.metrics.nlg import nlg_metric_suite
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.parallel.distributed import all_reduce_sum_, \
        current_world, main_rank_first
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.captioning import get_comp_str, write_sentences
    from tennis_torch.utils.experiments import experiment_dir, \
        setup_logging, summary_writer

    world = current_world(resolve_device(args.device))
    device = world.device
    main = world.is_main
    exp_dir = experiment_dir("captioning", args.model_id)
    if main:
        setup_logging(exp_dir, vars(args))

    data_train, data_val, data_test = datasets or make_datasets(args)
    vocab = data_train.vocab
    log.info("vocab size %d", len(vocab))
    log.info(data_train.stats())

    val_tgt = data_val.get_captions(split=True)
    test_tgt = data_test.get_captions(split=True)
    if main:
        write_sentences(val_tgt, os.path.join(exp_dir, "val_gt.txt"))
        write_sentences(test_tgt, os.path.join(exp_dir, "test_gt.txt"))

    loaders = {split: make_loader(args, ds, split, world.data_size)
               for split, ds in (("train", data_train), ("val", data_val),
                                 ("test", data_test))}
    if len(loaders["train"]) == 0:
        raise SystemExit("train loader produced zero batches: add training "
                         "captions")
    model = build_model(args, len(vocab),
                        feature_dim(data_train) if args.feats_model else None,
                        generator=torch.Generator().manual_seed(args.seed))
    log.info("params: %.2fM", ckpt.param_count(model) / 1e6)
    # the .npz first: a --backbone_from_id graft overrides it
    if not args.feats_model and args.pretrained_npz:
        load_pretrained_src_embed(model, args)
    if not args.feats_model and args.backbone_from_id:
        transplant_backbone(model, args)

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
    state = create_seq2seq_state(
        model, tx, lr, args.freeze_backbone and not args.feats_model)
    with main_rank_first(world):
        start_epoch = ckpt.resume_state(
            exp_dir, lambda tree: state_from_flax(state, tree))
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
        fold_densenets(model)
        losses = []

        def loss_of(src, tgt, src_vl, tgt_vl, weights=None):
            with torch.no_grad():
                logits = model(src, tgt[:, :-1], src_vl, tgt_vl - 1)
                if weights is None:
                    losses.append(masked_ce_loss(logits, tgt[:, 1:],
                                                 tgt_vl - 1))
                    return
                # this rank's weighted sum and weight, summed over the
                # ranks after the split: the batch's mean over its rows
                mean = masked_ce_loss(logits, tgt[:, 1:], tgt_vl - 1,
                                      sample_weights=weights)
                total = weights.sum()
                losses.append(torch.stack(
                    [mean * torch.clamp(total, min=1.0), total]))

        hyps = decode_split(translator, vocab, loaders[split], device,
                            on_batch=loss_of)
        losses = torch.stack(losses)
        if world.grouped:
            all_reduce_sum_([losses])
            losses = losses[:, 0] / losses[:, 1]
        losses = losses.cpu().numpy().tolist()
        suite = nlg_metric_suite([[t] for t in tgt_sentences], hyps)
        return float(np.mean(losses)), suite, hyps

    tb = summary_writer(exp_dir) if main else None
    best_bleu = -1.0
    seed_rng = np.random.default_rng(args.seed + 1)
    try:
        with ckpt.AsyncCheckpointer() as writer:
            for epoch in range(start_epoch, args.epochs):
                loaders["train"].set_epoch(epoch)
                tic = time.time()
                n_tokens, n_batches = 0, 0
                for src, tgt, src_vl, tgt_vl, *_ in prefetch_to_device(
                        rank_batches(loaders["train"]), device,
                        moved=4):
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
                if main:
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
                new_best = bleu4 > best_bleu
                best_bleu = max(best_bleu, bleu4)
                if not main:
                    continue
                tree = state_to_flax(state)
                writer.save(ckpt.epoch_path(exp_dir, epoch), tree)
                # the scores.txt row lands only after its epoch file
                writer.submit(
                    lambda e=epoch, s=bleu4: ckpt.append_score(exp_dir, e, s))
                if new_best:
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
