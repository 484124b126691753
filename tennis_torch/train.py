"""Event-classifier driver (counterpart of ``tennis_tpu/train.py``).

The flags are the JAX driver's, with the same names and defaults, parsed
with argparse (absl booleans take ``--name``, ``--name=false`` and
``--noname``), plus ``--device`` (``cuda`` by default; asking for it without
a GPU raises). Three invocations run:

- training (the default, :func:`fit`) of the model the flags compose
  (:func:`build_model`): a framewise classifier over a DenseNet or
  ResNet-v2 backbone (``resnet18_v2`` by default); R(2+1)D-34 over clips
  (``--backbone rdnet --window 8|32``, the 0031 row); the CNN-RNN
  (``--window > 1 --temp_pool gru|lstm``) over ``--feats_model`` features
  or over frame clips; the two-stream RGB + flow net (``--flow twos``, or
  ``only``); the 6-channel backbone (``--flow sixc``). The balanced train
  split (windows too) through the random train geometry
  (``ThreadLocalRng(seed + 1)``; the test geometry for clips and flow), a
  shuffled ``drop_last`` loader and the pinned prefetch, the device augment
  of single RGB frames (drawn per step from ``(seed + 123, step)``;
  ``device_prepare`` for clips and 6-channel frames, features as they
  are), the train-mode forward and backward in the compute dtype with f32
  parameters, momentum SGD with weight decay and the epoch step schedule
  (``--freeze_backbone``: every parameter under a ``backbone`` left as
  it is); after each epoch the val split through the eval step (on a GPU
  every dense layer in a dense-layer CUDA kernel), then the epoch file
  (the JAX ``TrainState`` layout, written atomically by a background
  writer) and its ``scores.txt`` row. A rerun resumes the newest readable
  epoch (an unreadable one is renamed ``.corrupt``), from either package.
  Training ends with the best epoch reloaded and the test split scored;
- ``--save_feats``: dump the backbone features of every sample of the
  train, val and test splits (the train split with its 255-frame context
  extension, no balancing and the test geometry) as f32 ``(F,)`` ``.npy``
  files under ``<root>/features/<model_id>/``, from the experiment's best
  epoch (``scores.txt``), else its newest readable epoch. An experiment
  with no checkpoint dumps from a fresh init drawn from ``--seed`` by the
  port's own generator, whose values differ from the JAX package's.
- ``--temp_pool max|mean``: the final test of a framewise-trained donor
  (``--feats_model``: its best epoch over its dumped features;
  ``--backbone_from_id``: its newest epoch over frames), its backbone
  features pooled over ``--window`` and its own head applied.

On a GPU every DenseNet dense layer of an evaluation runs in a dense-layer
CUDA kernel; ResNet-v2 and R(2+1)D run cuDNN convolutions, as the JAX
package runs XLA's; the train step runs plain torch ops, as the JAX package
trains through its flax module (the CNN-RNN's GRU too: the GRU kernel is the
captioner's decode's). ``--vis`` is accepted and does nothing, as in the
JAX trainer (``evaluate --vis`` renders). ``--pretrained_npz`` loads a
converted ``.npz`` (``python -m tennis_torch.models.convert``) at every
backbone mount of the model (:func:`pretrained_mounts`), after
``--backbone_from_id`` and before a resume, as the JAX driver does.

Data parallelism: ``--num_devices`` (``-1``, the default: every local GPU;
one rank with ``--device cpu``, where ``N`` runs N gloo ranks) starts one
process per rank (``parallel.distributed.launch``), and ``--multihost
--coordinator host:port --num_hosts H --host_id h`` makes this host h of H.
``--batch_size`` stays global: each rank takes its stripe of every global
batch, the BN statistics and the gradients are the global batch's, the
evaluations gather every rank's rows (``sharded_eval_iter``), and only
global rank 0 writes the experiment's files; ``--save_feats`` has each
rank write its own rows.

Run: ``python -m tennis_torch.train --model_id 0006 --backbone DenseNet121``
(add ``--save_feats`` for the dump; ``--device cpu`` off the GPU;
``--num_devices 2`` for two GPUs);
``--model_id 0031 --backbone rdnet --window 8 --data_shape 224`` for
R(2+1)D; ``--model_id
0042 --backbone DenseNet121 --feats_model 0006 --temp_pool gru --window 30``
for the CNN-RNN; ``--model_id 0010 --backbone DenseNet121 --flow twos`` for
the two-stream net.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

log = logging.getLogger(__name__)


def _bool(value: str) -> bool:
    if value.lower() in ("1", "true", "t", "yes"):
        return True
    if value.lower() in ("0", "false", "f", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def _list(value: str) -> list[str]:
    """A comma-separated list, as absl's ``DEFINE_list`` parses it."""
    return [v.strip() for v in value.split(",") if v.strip()]


def _add_bool(p: argparse.ArgumentParser, name: str, help_: str):
    p.add_argument(f"--{name}", type=_bool, nargs="?", const=True,
                   default=False, help=help_)
    p.add_argument(f"--no{name}", dest=name, action="store_false",
                   help=argparse.SUPPRESS)


def add_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX ``train.py`` flag surface, and ``--device``."""
    add = p.add_argument
    add("--root", default="data", help="Dataset root directory")
    add("--backbone", default="resnet18_v2", help="Backbone CNN name")
    add("--backbone_from_id", default=None,
        help="Load backbone weights from another experiment id")
    _add_bool(p, "freeze_backbone", "Freeze the backbone model")
    add("--model_id", default="0000", help="model identification string")
    add("--split_id", default="02", help="split id: 01 or 02")
    add("--log_interval", type=int, default=100,
        help="Logging mini-batch interval")
    add("--data_shape", type=int, default=512, help="Input crop side")
    add("--every", type=_list, default="1,1,1",
        help="Use every nth frame: [train, val, test]")
    add("--balance", type=_list, default="True,False,False",
        help="Balance classes per split")
    add("--window", type=int, default=1, help="Temporal window size")
    add("--padding", type=int, default=1,
        help="Padding around event boundaries (parity flag)")
    add("--stride", type=int, default=1, help="Temporal stride within a window")
    add("--batch_size", type=int, default=64, help="Global batch size")
    add("--epochs", type=int, default=20, help="Training epochs")
    add("--num_devices", "--num_gpus", dest="num_devices", type=int,
        default=-1, help="Devices for the data axis (-1 = all)")
    add("--num_workers", type=int, default=-1,
        help="Host loader threads (-1 = auto)")
    add("--lr", type=float, default=0.001, help="Learning rate")
    add("--lr_factor", type=float, default=0.75, help="LR step factor")
    add("--lr_steps", type=_list, default="10,20",
        help="Epochs at which the LR factor applies")
    add("--momentum", type=float, default=0.9, help="SGD momentum")
    add("--wd", type=float, default=0.0001, help="Weight decay")
    _add_bool(p, "vis", "Visualise test results")
    _add_bool(p, "save_feats", "Save backbone features as .npy")
    add("--feats_model", default=None, help="Load features from this model id")
    add("--flow", default="", choices=["", "only", "sixc", "twos"],
        help="'' | 'only' | 'sixc' | 'twos'")
    add("--temp_pool", default=None, help="mean, max, gru or lstm")
    add("--max_batches", type=int, default=-1,
        help="Limit batches per epoch (debug)")
    add("--pretrained_npz", default=None,
        help="Optional converted pretrained backbone weights (.npz)")
    add("--seed", type=int, default=0, help="Global RNG seed")
    add("--frames_cache", type=int, default=0,
        help="Read frames from the pre-resized data/frames_s<N> mirror "
             "(0 reads the original tree; missing cache files fall back "
             "per file)")
    add("--profile_steps", type=int, default=0,
        help="Trace this many train steps (training only), the port's "
             "spans on as tennis_torch/<name> ranges")
    _add_bool(p, "multihost", "Multi-host run (with --coordinator, "
              "--num_hosts, --host_id)")
    add("--coordinator", default=None,
        help="multihost coordinator address host:port")
    add("--num_hosts", type=int, default=None, help="multihost process count")
    add("--host_id", type=int, default=None, help="this process's index")
    add("--remat", default="none", choices=["none", "block", "hires", "growth"],
        help="Dense-block rematerialization (training memory; no effect in "
             "eval)")
    add("--device", default="cuda", choices=["cuda", "cpu"],
        help="Device the model runs on")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Event-classifier driver")
    return add_flags(p).parse_args(argv)


def refuse_feature_dump(model):
    """``--save_feats`` dumps a ``FrameModel``'s backbone features; any
    other model (a CNN-RNN, a two-stream net) raises ``ValueError``, as in
    the JAX driver."""
    from tennis_torch.models import FrameModel

    if not isinstance(model, FrameModel):
        raise ValueError("--save_feats needs a backbone-bearing model "
                         "(FrameModel); it cannot be combined with "
                         "--temp_pool/--feats_model configurations")


def make_datasets(args):
    """(train, val, test) sets; the train split is balanced only without
    ``--save_feats``."""
    from tennis_torch.data.tennis_set import TennisSet

    every = [int(s) for s in args.every]
    balance = [str(s).strip().lower() in ("true", "t") for s in args.balance]
    train_set = TennisSet(
        split="train", every=every[0],
        balance=balance[0] and not args.save_feats, balance_seed=args.seed,
        decode_short=(args.data_shape + 32 if (args.window > 1 or args.flow
                                               or args.save_feats) else None),
        **_common(args))
    val_set = make_eval_dataset(args, "val", every_n=every[1])
    test_set = make_eval_dataset(args, "test")
    return train_set, val_set, test_set


def _common(args) -> dict:
    return dict(root=args.root, split_id=args.split_id, padding=args.padding,
                stride=args.stride, window=args.window, model_id=args.model_id,
                flow=bool(args.flow), feats_model=args.feats_model or None,
                save_feats=args.save_feats,
                frames_cache=args.frames_cache or None)


def make_eval_dataset(args, split: str, every_n: int | None = None):
    """One split with test-time settings: no balancing, the test-split
    ``every`` unless overridden."""
    from tennis_torch.data.tennis_set import TennisSet

    every = [int(s) for s in args.every]
    return TennisSet(split=split, every=every[2] if every_n is None else every_n,
                     balance=False, decode_short=args.data_shape + 32,
                     **_common(args))


def _geometry_transform(args, train: bool):
    """Host-side geometry of raw frames; features pass through. The train
    split takes the random ``RandomResizedCrop`` (per-thread generators from
    ``--seed + 1``) unless ``--save_feats``, ``--window > 1`` or ``--flow``
    asks for the test geometry."""
    from tennis_torch.data import transforms as T

    rng = T.ThreadLocalRng(args.seed + (1 if train else 2))
    random_crop = (train and args.window == 1 and not args.flow
                   and not args.save_feats)

    def apply(sample):
        img, label, idx = sample
        if img.ndim == 2 or (img.ndim == 3 and img.shape[-1] in (3, 6)):
            img = T.train_geometry(img, args.data_shape, rng.get()) \
                if random_crop else T.test_geometry(img, args.data_shape)
        elif img.ndim == 4:  # (T, H, W, C) window clip
            img = np.stack([T.test_geometry(f, args.data_shape) for f in img])
        return img, label, idx

    return apply


def build_model(args, num_classes: int, feats: bool = False,
                dtype=torch.bfloat16):
    """The model the flags compose, as the JAX driver's ``build_model``
    does, drawn from ``--seed`` (CPU, f32 parameters, compute in ``dtype``:
    the drivers' bf16, or f32 for a comparison), every DenseNet with
    ``--remat``:

    - ``--temp_pool max|mean``: the framewise donor ``FrameModel`` that the
      pooled wrap loads (it trains nothing);
    - ``--backbone rdnet`` over clips: ``FrameModel(R21D-34)`` (``--window``
      8 or 32; ``--remat block`` checkpoints each residual block);
    - frames with ``--flow twos|only``: ``TwoStreamModel`` of two backbone
      streams (``only``: the flow stream alone);
    - ``--window > 1 --temp_pool gru|lstm``: ``CNNRNN`` (hidden 128) over
      ``feats`` (the backbone's feature width) or over clips through a
      head-less ``FrameModel``;
    - otherwise ``FrameModel(backbone, num_classes)``.

    ``--flow sixc`` makes every backbone above take 6 channels. Flag sets
    on which the JAX driver raises raise ``ValueError`` naming them:
    ``--remat`` with a ResNet, rdnet without ``--window 8|32`` or with
    ``--remat hires|growth``, feature input without a temporal model, and
    clips (``--window > 1``) into a framewise model."""
    from tennis_torch.inference import build_frame_model
    from tennis_torch.models import CNNRNN, FrameModel, TwoStreamModel, \
        backbone_feature_dim, get_backbone
    from tennis_torch.models.r21d import get_r21d

    remat = None if args.remat == "none" else args.remat
    rdnet = args.backbone.lower() == "rdnet"
    if remat and not (args.backbone.lower().startswith("densenet") or rdnet):
        raise ValueError("--remat supports DenseNet and rdnet backbones only")
    generator = torch.Generator().manual_seed(args.seed)
    channels = 6 if args.flow else 3

    def backbone(in_channels=channels):
        return get_backbone(args.backbone, in_channels=in_channels,
                            dtype=dtype, remat=remat, generator=generator)

    def frame_model():
        return build_frame_model(args.backbone, num_classes, args.data_shape,
                                 dtype=dtype, remat=remat,
                                 generator=generator, in_channels=channels)

    if args.temp_pool in ("max", "mean") and not feats:
        return frame_model()
    feature_dim = backbone_feature_dim(args.backbone, args.data_shape)
    if rdnet and not feats:
        if args.window not in (8, 32):
            raise ValueError("rdnet needs --window 8 or 32")
        if remat not in (None, "block"):
            raise ValueError("rdnet supports --remat block only (per "
                             "residual block); hires/growth are DenseNet "
                             "policies")
        return FrameModel(get_r21d(34, num_classes, t=args.window,
                                   dtype=dtype, remat=remat == "block",
                                   in_channels=channels, generator=generator),
                          num_classes, dtype=dtype, feature_dim=feature_dim,
                          generator=generator)
    if not feats and args.window > 1 and (
            args.flow in ("twos", "only")
            or args.temp_pool not in ("gru", "lstm")):
        raise ValueError(f"--window {args.window} feeds clips to a framewise "
                         f"{args.backbone} model: pass --temp_pool gru|lstm "
                         f"(or max|mean for a pooled test) without --flow "
                         f"twos|only, or --backbone rdnet")
    if not feats and args.flow in ("twos", "only"):
        rgb = None if args.flow == "only" else backbone(3)
        return TwoStreamModel(rgb, backbone(3), num_classes, dtype=dtype,
                              feature_dim=feature_dim, generator=generator)
    if args.window > 1 and args.temp_pool in ("gru", "lstm"):
        return CNNRNN(None if feats else FrameModel(backbone(), dtype=dtype),
                      num_classes, hidden_size=128, cell_type=args.temp_pool,
                      dtype=dtype, feature_dim=feature_dim,
                      generator=generator)
    if feats:
        raise ValueError("--feats_model requires --temp_pool "
                         "(gru/lstm/max/mean)")
    return frame_model()


def _metric_set(class_names):
    from tennis_torch.metrics import PRF1, Accuracy, TopKAccuracy

    return {
        "acc": Accuracy(),
        "acc_nb": Accuracy("accuracy_no_bg", ignore_labels=[0]),
        "acc_b": Accuracy("accuracy_bg",
                          ignore_labels=list(range(1, len(class_names)))),
        "top5": TopKAccuracy(5),
        "prf1": PRF1(class_names),
    }


def load_tree(model, tree: dict, path: str):
    """Load a checkpoint tree's ``params``/``batch_stats`` into ``model``;
    a tree of another architecture raises ``ValueError``."""
    from tennis_torch.bridge import load_flax

    try:
        load_flax(model, {"params": tree["params"],
                          "batch_stats": tree.get("batch_stats", {})})
    except (KeyError, RuntimeError) as e:
        raise ValueError(f"checkpoint {path} does not match the model "
                         f"(architecture or flag mismatch): {e}") from e


def load_epoch(model, exp_dir: str, epoch: int):
    from tennis_torch.utils import checkpoint as ckpt

    path = ckpt.epoch_path(exp_dir, epoch)
    load_tree(model, ckpt.load_raw(path), path)


def _key_paths(tree: dict, prefix=()) -> set:
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out |= _key_paths(v, prefix + (k,))
        else:
            out.add("/".join(prefix + (k,)))
    return out


def read_donor(from_id: str):
    """``(path, epoch, tree)`` of the newest epoch file of the vision
    experiment ``from_id`` (the donor of ``--backbone_from_id``), or None
    when it has none; ``tree`` as ``load_raw`` reads it."""
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir

    latest = ckpt.latest_epoch(experiment_dir("vision", from_id))
    if latest is None:
        return None
    path = ckpt.epoch_path(experiment_dir("vision", from_id), latest)
    return path, latest, ckpt.load_raw(path)


def _load_backbone_from(model, from_id: str):
    """Transplant the ``backbone`` parameters (not its BN statistics, as in
    the JAX driver) of ``from_id``'s newest epoch. The JAX driver restores
    the donor's whole file into this model's train state first, so a donor
    of another architecture raises there (flax's ``from_bytes``), and a
    model without a top-level ``backbone`` (a CNN-RNN, a two-stream net)
    raises on the transplant: here both raise ``ValueError`` naming the
    mismatch."""
    from tennis_torch.bridge import from_flax, to_flax
    from tennis_torch.utils.experiments import experiment_dir

    donor = read_donor(from_id)
    if donor is None:
        log.warning("no checkpoints in %s; backbone not transplanted",
                    experiment_dir("vision", from_id))
        return
    path, latest, raw = donor
    log.info("transplanting backbone from %s epoch %d", from_id, latest)
    mine = to_flax(model)
    for col in ("params", "batch_stats"):
        want, got = _key_paths(mine[col]), _key_paths(raw.get(col, {}))
        if want != got:
            raise ValueError(
                f"--backbone_from_id {from_id}: {path} is another "
                f"architecture ({col} keys differ: the model's "
                f"{sorted(want - got)[:3]}, the file's "
                f"{sorted(got - want)[:3]})")
    if "backbone" not in mine["params"]:
        raise ValueError(f"--backbone_from_id {from_id}: the model has no "
                         f"'backbone' to transplant (params "
                         f"{sorted(mine['params'])})")
    model.load_state_dict(
        from_flax({"params": {"backbone": raw["params"]["backbone"]}}),
        strict=False)


def pretrained_mounts(model) -> list[str]:
    """Parameter paths where a converted backbone table lands, by model
    family, as the JAX driver's ``_pretrained_mounts``: both streams of a
    two-stream net (``model_flow``, and ``model_rgb`` unless ``--flow
    only``), the wrapped ``FrameModel``'s backbone of a CNN-RNN or pooled
    wrap over pixels (``model/backbone``; none over features), else
    ``backbone`` (a ``FrameModel``, the rdnet wrap included)."""
    from tennis_torch.models import CNNRNN, TemporalPooling, TwoStreamModel

    if isinstance(model, TwoStreamModel):
        mounts = ["model_flow"]
        if model.model_rgb is not None:
            mounts.append("model_rgb")
        return mounts
    if isinstance(model, (CNNRNN, TemporalPooling)):
        return ["model/backbone"] if model.model is not None else []
    return ["backbone"]


def load_pretrained_backbone(model, npz_path: str, flow: str = ""):
    """Load converted pretrained weights (a flat ``.npz`` of '/'-joined
    flax paths with ``batch_stats::`` markers, as ``models/convert.py``
    writes it) into ``model`` at every mount of :func:`pretrained_mounts`;
    returns the number of arrays loaded. ``ValueError`` for ``--flow sixc``,
    for a model over features, and when nothing matched, with the JAX
    driver's messages."""
    from tennis_torch.models.convert import load_npz

    if flow == "sixc":
        raise ValueError(
            "--pretrained_npz is incompatible with --flow sixc: the 6-channel "
            "stem has no ImageNet counterpart and the reference trains sixc "
            "from scratch (reference train.py:202)"
        )
    mounts = pretrained_mounts(model)
    if not mounts:
        raise ValueError(
            "--pretrained_npz needs a pixel backbone; this feats-mode model "
            "has none (features were extracted by an earlier experiment)"
        )
    with np.load(npz_path) as f:
        n = load_npz(model, dict(f), mounts)
    if n == 0:
        raise ValueError(
            f"no arrays from {npz_path} matched the model at mounts {mounts} "
            "— wrong --arch conversion for this --backbone?"
        )
    log.info("loaded %d pretrained arrays from %s at %s", n, npz_path, mounts)
    return n


def _to_host(feats: torch.Tensor):
    """Start the copy of ``feats`` to the host: (host tensor, event or
    None). On a GPU it is a non-blocking copy into pinned memory on the
    compute stream, behind the forward that made ``feats``."""
    if feats.device.type != "cuda":
        return feats, None
    host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
    host.copy_(feats, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def save_features(extract, datasets, loaders, device) -> dict:
    """Dump ``extract``'s f32 features of every sample of each dataset as
    ``.npy`` at its ``save_feature_path``, through ``loaders[split]``.
    Under a process group each rank writes the rows of its loader stripe
    (no collective), less the stripe's wrap-padded duplicates, which
    another rank writes.

    Three things overlap: the copy of batch t+1 to the device (the prefetch
    threads), the forward of batch t, and the copy back and the writes of
    batch t-1 (a 4-thread writer pool); the host waits for batch t-1's copy
    only after batch t's forward is enqueued. Returns, per split, the files
    written, the seconds taken, the prefetch stats, ``copy_wait_s`` (time the
    host waited for features to reach it) and ``write_drain_s`` (time the
    writes lagged the last forward)."""
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.parallel.distributed import current_world

    world = current_world(device)

    def write_one(ds, feat, idx):
        path = ds.save_feature_path(int(idx))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, feat)

    report = {}
    for ds in datasets:
        split = ds._split
        tic = time.perf_counter()
        stats = {"files": 0, "copy_wait_s": 0.0, "prefetch": {}}
        pending, futures = None, []
        stripe_off = 0
        with ThreadPoolExecutor(4) as writer:

            def flush(item):
                (host, event), idxs = item
                t0 = time.perf_counter()
                if event is not None:
                    event.synchronize()
                stats["copy_wait_s"] += time.perf_counter() - t0
                for feat, idx in zip(host.numpy(), idxs):
                    futures.append(writer.submit(write_one, ds, feat, idx))
                stats["files"] += len(idxs)
                # surface write errors early; keep the list short
                while futures and futures[0].done():
                    futures.pop(0).result()

            for images, _, idxs in prefetch_to_device(
                    iter(loaders[split]), device, stats=stats["prefetch"]):
                staged = _to_host(extract(images))
                if world.grouped:  # this stripe's wrapped duplicates
                    pos = stripe_off + np.arange(len(idxs))
                    stripe_off += len(idxs)
                    idxs = np.asarray(idxs)[
                        world.data_rank + pos * world.data_size < len(ds)]
                if pending is not None:
                    flush(pending)
                pending = (staged, idxs)
            if pending is not None:
                flush(pending)
            t0 = time.perf_counter()
            for f in futures:
                f.result()
            stats["write_drain_s"] = time.perf_counter() - t0
        stats["seconds"] = time.perf_counter() - tic
        log.info("saved %d feature files for split %s", stats["files"], split)
        report[split] = stats
    return report


def eval_batches(loader, step, device):
    """``(out, labels, idxs)`` host blocks of ``step`` over ``loader``:
    ``eval_iter`` on one rank, ``sharded_eval_iter`` (every rank's rows,
    gathered) under a process group."""
    from tennis_torch.data.loader import eval_iter, sharded_eval_iter
    from tennis_torch.parallel.distributed import grouped

    if grouped():
        return sharded_eval_iter(loader, loader.batch_size,
                                 len(loader.dataset), step, device)
    return eval_iter(loader, step, device)


def _pooled_final_test(args, test_set, loader, device):
    """``--temp_pool max|mean``: no training. The framewise donor (best
    epoch of ``--feats_model``, else newest of ``--backbone_from_id``) has
    its backbone features pooled over the window and its own head applied."""
    from tennis_torch.inference import make_eval_step
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir

    if not (args.backbone_from_id or args.feats_model):
        raise ValueError("--temp_pool max|mean evaluates a pretrained net: "
                         "pass --feats_model or --backbone_from_id")
    if args.window <= 1:
        raise ValueError("--temp_pool max|mean needs --window > 1")
    inner = build_model(args, test_set.num_class)
    if args.feats_model:
        src_dir = experiment_dir("vision", args.feats_model)
        best = ckpt.best_epoch(src_dir)
        if best is None:
            raise FileNotFoundError(f"no scores.txt in {src_dir}")
        load_epoch(inner, src_dir, best[0])
        log.info("testing best donor epoch %d (score=%.4f) from %s", best[0],
                 best[1], args.feats_model)
    else:
        src_dir = experiment_dir("vision", args.backbone_from_id)
        latest = ckpt.latest_epoch(src_dir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints in {src_dir}")
        load_epoch(inner, src_dir, latest)
        log.info("testing donor epoch %d from %s", latest,
                 args.backbone_from_id)
    step = make_eval_step(inner, device, pool=args.temp_pool,
                          feats=bool(args.feats_model))
    metrics = _metric_set(test_set.classes)
    tic = time.time()
    for logits, labels, _ in eval_batches(loader, step, device):
        for m in metrics.values():
            m.update(labels, logits)
    for name, m in metrics.items():
        if name != "prf1":
            log.info("test %s=%.4f", *m.get())
    for name, value in metrics["prf1"].get():
        log.info("test %s=%.4f", name, value)
    log.info("confusion:\n%s", metrics["prf1"].confusion_str())
    log.info("# Samples: %d, Time Taken: %.1f", len(test_set), time.time() - tic)
    return metrics


def _profile_train_steps(step, n: int, out_dir: str, device):
    """``n`` calls of ``step`` under torch.profiler, with the port's spans
    on (:mod:`tennis_torch.utils.tracing`: the phases and BN passes are
    ranges ``tennis_torch/<name>`` in the trace) and off after; the trace
    (Chrome JSON) goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from tennis_torch.utils import tracing

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    was = tracing.enabled(True)
    try:
        with profile(activities=activities) as prof:
            for _ in range(n):
                loss, _ = step()
            float(loss)  # the steps' device work ends inside the trace
    finally:
        tracing.enabled(was)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_steps.json"))


def make_preprocess(args, dtype):
    """The train step's ``preprocess(images, generator, rows=None)``, the
    JAX step's: the device augment of uint8 single frames without
    ``--flow`` (a data-parallel rank's ``rows`` of the global batch's
    draws),
    ``device_prepare`` of any other uint8 input (clips flattened, 6-channel
    frames with the two-stream statistics), features as they are."""
    from tennis_torch.data.transforms import device_augment
    from tennis_torch.inference import prepare_input

    def preprocess(images, generator, rows=None):
        if images.dtype == torch.uint8 and images.ndim == 4 and not args.flow:
            return device_augment(images, generator, dtype, rows)
        return prepare_input(images, dtype)

    return preprocess


def fit(args, model, loaders: dict, exp_dir: str, device):
    """Train ``model`` (a ``FrameModel``, ``CNNRNN`` or ``TwoStreamModel``)
    over ``loaders["train"]`` from the newest readable epoch of ``exp_dir``
    to ``--epochs``, evaluate ``loaders["val"]`` after every epoch and
    ``loaders["test"]`` with the best epoch; returns ``(train state, test
    metric set)``.

    The loaders yield ``(inputs, labels, indices)``: uint8 frames (B, S,
    S, C) or clips (B, T, S, S, C), or f32 features (B, T, F); the train
    loader's dataset names the classes (``.classes``) and the loader takes
    ``set_epoch``. The step's preprocess is :func:`make_preprocess`'s.
    Each epoch: the train
    batches through the pinned prefetch and the train step (the loss and a
    train PRF1 sampled at
    ``--log_interval``; ``--max_batches`` ends the epoch early;
    ``--profile_steps`` traces that many steps at the second batch of the
    first epoch into ``<exp_dir>/tb/profile``, with the port's spans on as
    ranges ``tennis_torch/<name>``), then the val split through
    an eval step made anew (its BN operands folded from this epoch's
    weights), then the epoch file through the background writer, and its
    ``scores.txt`` row only after it.

    Under a process group the loaders are this rank's stripes:
    the step is data-parallel, the evaluations gather every rank's rows,
    rank 0 resumes first (it may quarantine a file) and alone writes the
    epoch files, ``scores.txt`` and the summaries, and the others wait for
    its writes before they read the best epoch."""
    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.inference import make_eval_step
    from tennis_torch.parallel.distributed import barrier, current_world, \
        fetch_global, main_rank_first
    from tennis_torch.parallel.train_step import create_train_state, \
        make_train_step, sgd_with_schedule
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import summary_writer

    world = current_world(device)
    classes = loaders["train"].dataset.classes
    model.to(device)
    steps_per_epoch = max(1, len(loaders["train"]))
    tx, _ = sgd_with_schedule(args.lr, args.momentum, args.wd,
                              [int(s) for s in args.lr_steps], args.lr_factor,
                              steps_per_epoch)
    state = create_train_state(model, tx, args.freeze_backbone)
    log.info("params: %.2fM", ckpt.param_count(model) / 1e6)
    with main_rank_first(world):
        start_epoch = ckpt.resume_state(
            exp_dir, lambda tree: state_from_flax(state, tree))
    if start_epoch > 0:
        log.info("resumed from epoch %d", start_epoch - 1)

    train_step = make_train_step(state, make_preprocess(args, model.dtype),
                                 rng_seed=args.seed + 123)

    def run_eval(split):
        step = make_eval_step(model, device)  # folds this epoch's weights
        metrics = _metric_set(classes)
        for logits, labels, _ in eval_batches(loaders[split], step, device):
            for m in metrics.values():
                m.update(labels, logits)
        model.train()
        return metrics

    tb = summary_writer(exp_dir) if world.is_main else None
    profile_left = args.profile_steps
    try:
        with ckpt.AsyncCheckpointer() as writer:
            for epoch in range(start_epoch, args.epochs):
                loaders["train"].set_epoch(epoch)
                tic = time.time()
                n_samples, n_batches = 0, 0
                train_metrics = _metric_set(classes)
                for images, labels, _ in prefetch_to_device(
                        iter(loaders["train"]), device):
                    if profile_left > 0 and n_batches == 1:
                        if world.is_main:
                            _profile_train_steps(
                                lambda: train_step(images, labels),
                                profile_left,
                                os.path.join(exp_dir, "tb", "profile"), device)
                            log.info("profiler trace written to "
                                     "%s/tb/profile", exp_dir)
                        else:  # the same steps, hence the same collectives
                            for _ in range(profile_left):
                                train_step(images, labels)
                        profile_left = 0
                    loss, logits = train_step(images, labels)
                    n_batches += 1
                    n_samples += len(labels) * world.data_size
                    if n_batches % args.log_interval == 0 or n_batches == 1:
                        loss_v = float(loss)
                        train_metrics["prf1"].update(
                            *fetch_global((np.asarray(labels), logits)))
                        rate = n_samples / max(time.time() - tic, 1e-6)
                        log.info("[Epoch %d][Batch %d] loss=%.4f %.1f "
                                 "samples/sec", epoch, n_batches, loss_v, rate)
                        if tb:
                            tb.add_scalar("train/loss", loss_v, state.step)
                            tb.add_scalar("train/samples_per_sec", rate,
                                          state.step)
                    if 0 < args.max_batches <= n_batches:
                        break

                train_f1 = train_metrics["prf1"].get_dict()["AVG_NB_f1"]
                if tb:
                    tb.add_scalar("train/AVG_NB_f1", train_f1, epoch)
                log.info("[Epoch %d] train AVG_NB_f1=%.4f (sampled at log "
                         "intervals)", epoch, train_f1)

                val_metrics = run_eval("val")
                score = val_metrics["prf1"].get_dict()["AVG_NB_f1"]
                accs = {name: round(m.get()[1], 4)
                        for name, m in val_metrics.items() if name != "prf1"}
                log.info("[Epoch %d] val AVG_NB_f1=%.4f %s (%.1fs)", epoch,
                         score, accs, time.time() - tic)
                if tb:
                    tb.add_scalar("val/AVG_NB_f1", score, epoch)
                if world.is_main:
                    writer.save(ckpt.epoch_path(exp_dir, epoch),
                                state_to_flax(state))
                    # the scores.txt row becomes durable only after its
                    # epoch file: a crash between hides an epoch, never
                    # dangles a row
                    writer.submit(lambda e=epoch, s=score:
                                  ckpt.append_score(exp_dir, e, s))
    finally:
        if tb:
            tb.close()

    barrier(world)  # rank 0's files are written
    best = ckpt.best_epoch(exp_dir)
    if best is not None:
        state_from_flax(state, ckpt.load_raw(ckpt.epoch_path(exp_dir, best[0])))
        log.info("loaded best epoch %d (AVG_NB_f1=%.4f)", best[0], best[1])
    test_metrics = run_eval("test")
    for name, m in test_metrics.items():
        if name != "prf1":
            log.info("test %s=%.4f", *m.get())
    for name, value in test_metrics["prf1"].get():
        log.info("test %s=%.4f", name, value)
    log.info("confusion:\n%s", test_metrics["prf1"].confusion_str())
    return state, test_metrics


def _num_workers(args, default: int) -> int:
    return args.num_workers if args.num_workers > 0 else default


def train_and_evaluate(args: argparse.Namespace):
    """Train (returns the train state), run ``--save_feats`` (returns the
    per-split dump report) or the ``--temp_pool max|mean`` final test
    (returns its metric set): in this process, or on every rank of a
    data-parallel run (then rank 0's result)."""
    from tennis_torch.parallel.distributed import rank_environment, \
        run_ranks

    if args.save_feats and args.temp_pool in ("max", "mean"):
        raise ValueError("--save_feats needs a backbone-bearing model "
                         "(FrameModel); it cannot be combined with "
                         "--temp_pool/--feats_model configurations")
    local, kw = rank_environment(args, batch_size=args.batch_size)
    return run_ranks("tennis_torch.train:run_rank", (args,), local, kw)


def run_rank(args: argparse.Namespace):
    """:func:`train_and_evaluate` on this rank of the world (the only one
    without a process group)."""
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import make_extract_features, resolve_device
    from tennis_torch.parallel.distributed import current_world, \
        host_batch_slice
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir, setup_logging

    pooled = args.temp_pool in ("max", "mean") and not args.save_feats
    training = not (args.save_feats or pooled)
    world = current_world(resolve_device(args.device))
    device = world.device
    exp_dir = experiment_dir("vision", args.model_id)
    if world.is_main:
        setup_logging(exp_dir, vars(args))
    feats = bool(args.feats_model)
    workers = _num_workers(args, os.cpu_count() or 8)
    host_batch = host_batch_slice(args.batch_size)

    def loader(ds, train, sgd=False):
        """Every sample in order, the ragged last batch kept; or, for SGD,
        shuffled with the last partial batch dropped; this rank's stripe
        of the global batches."""
        return DataLoader(ds, batch_size=host_batch, shuffle=sgd,
                          seed=args.seed, num_workers=workers, drop_last=sgd,
                          num_shards=world.data_size,
                          shard_id=world.data_rank,
                          transform=None if feats else
                          _geometry_transform(args, train))

    if pooled:
        test_set = make_eval_dataset(args, "test")
        log.info(test_set)
        return _pooled_final_test(args, test_set, loader(test_set, False),
                                  device)

    datasets = make_datasets(args)
    for ds in datasets:
        log.info(ds)
    model = build_model(args, datasets[0].num_class, feats)
    if args.save_feats:
        refuse_feature_dump(model)
    if args.backbone_from_id:
        _load_backbone_from(model, args.backbone_from_id)
    if args.pretrained_npz:
        load_pretrained_backbone(model, args.pretrained_npz, args.flow)
    if training:
        loaders = {ds._split: loader(ds, ds._split == "train",
                                     sgd=ds._split == "train")
                   for ds in datasets}
        return fit(args, model, loaders, exp_dir, device)[0]
    found = ckpt.latest_readable(exp_dir)
    if found is not None:
        epoch, tree = found
        load_tree(model, tree, ckpt.epoch_path(exp_dir, epoch))
        log.info("resumed from epoch %d", epoch)
    best = ckpt.best_epoch(exp_dir)
    if best is not None:
        load_epoch(model, exp_dir, best[0])
        log.info("dumping features from best epoch %d (score=%.4f)", best[0],
                 best[1])
    # every sample, in order, the ragged last batch kept
    loaders = {ds._split: loader(ds, ds._split == "train") for ds in datasets}
    return save_features(make_extract_features(model, device), datasets,
                         loaders, device)


def main(argv=None):
    return train_and_evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
