"""Checkpoint -> serving callables (counterpart of ``tennis_tpu/inference.py``).

Classifier: a vision experiment's best epoch (``best_or_latest``) is read
with ``load_raw``, its ``params``/``batch_stats`` go through the weight
bridge into ``FrameModel(backbone)`` (a DenseNet, whose BN operands are
folded once, or a ResNet-v2), and ``predict_probs`` maps a uint8 batch (B,
S, S, 3) to host (B, classes) softmax on the chosen device: uint8 upload ->
``device_prepare`` -> forward (a DenseNet's dense layers through the
dense-layer kernel; a ResNet's convolutions through cuDNN) -> softmax.
``make_extract_features`` is the same forward stopped at the backbone's
f32 features, for the feature dump.

Captioner: a captioning experiment's ``valid_best.params`` goes through the
bridge into the features-path ``NMTModel`` the ``--gnmt_flag`` arguments
describe, and ``caption_batch`` maps a float32 feature batch
(B, src_max_len, D) and valid lengths (B,) to B token lists by beam search
on the chosen device (every encoder GRU recurrence through the GRU kernel).
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from tennis_torch.utils.tracing import span

log = logging.getLogger(__name__)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Asking for CUDA without a card raises; there is no quiet fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but no GPU is available "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def build_frame_model(backbone: str, num_classes: int, data_shape: int,
                      dtype=torch.bfloat16, remat: str | None = None,
                      generator: torch.Generator | None = None,
                      in_channels: int = 3):
    """``FrameModel(get_backbone(backbone))`` with its head sized for square
    ``data_shape`` inputs of ``in_channels`` (6 for ``--flow sixc``);
    ``remat`` as the backbone takes it."""
    from tennis_torch.models import FrameModel, backbone_feature_dim, \
        get_backbone

    return FrameModel(get_backbone(backbone, in_channels=in_channels,
                                   dtype=dtype, remat=remat,
                                   generator=generator),
                      num_classes=num_classes, dtype=dtype,
                      feature_dim=backbone_feature_dim(backbone, data_shape),
                      generator=generator)


def load_classifier_state(backbone: str, model_id: str, data_shape: int,
                          root: str = "data"):
    """Restore a vision experiment's best epoch into (classes, model, info),
    the model on the CPU in f32 parameters."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.data.tennis_set import load_classes
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir

    classes = load_classes(root)
    model = build_frame_model(backbone, len(classes), data_shape)
    exp_dir = experiment_dir("vision", model_id)
    epoch, score = ckpt.best_or_latest(exp_dir)
    raw = ckpt.load_raw(ckpt.epoch_path(exp_dir, epoch))
    load_flax(model, {"params": raw["params"],
                      "batch_stats": raw["batch_stats"]})
    log.info("loaded epoch %d (score=%s) from %s", epoch, score, exp_dir)
    info = {"exp_dir": exp_dir, "epoch": epoch, "score": score}
    return classes, model, info


def make_predict_probs(model, device: torch.device):
    """Move ``model`` to ``device``, fold its BN operands once, and return
    ``predict_probs(uint8 (B, S, S, 3)) -> np.ndarray (B, classes)``; the
    frames a host array or a tensor (one already on ``device`` is not
    copied)."""
    step = make_eval_step(model, device)

    def predict_probs(images) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images, np.uint8)
        logits = step(images)
        return torch.softmax(logits, dim=-1).cpu().numpy()

    return predict_probs


def make_extract_features(model, device: torch.device):
    """Move ``model`` (a ``FrameModel``) to ``device``, fold its BN
    operands once if its backbone is a DenseNet, and return
    ``extract(uint8 (B, S, S, C) frames or (B, T, S, S, C) clips) -> f32
    (B, F)`` backbone features, a tensor on ``device``:
    :func:`prepare_input` -> ``model.features`` (a DenseNet's dense layers
    through the dense-layer kernels on a GPU; an R(2+1)D takes each clip
    whole). The input may be a tensor already on ``device`` or a host
    array. The two steps are the spans ``prepare`` and ``features``
    (:mod:`tennis_torch.utils.tracing`)."""
    from tennis_torch.models import DenseNet

    model = model.to(device).eval()
    if isinstance(model.backbone, DenseNet):
        model.backbone.fold()

    @torch.inference_mode()
    def extract(images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device)
        with span("prepare"):
            x = prepare_input(x, model.dtype)
        with span("features"):
            return model.features(x).float()

    return extract


def prepare_input(x: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 NHWC frames (B, S, S, C) or clips (B, T, S, S, C), C 3 or 6,
    -> ``device_prepare`` over the frames, in ``dtype``; features (any
    other dtype) as given."""
    from tennis_torch.data.transforms import device_prepare

    if x.dtype != torch.uint8:
        return x
    flat = x.reshape((-1,) + tuple(x.shape[-3:]))
    return device_prepare(flat, dtype).reshape(x.shape)


def fold_densenets(model):
    """Fold the BN operands of every DenseNet of ``model`` once (a frame
    model's backbone, a clip CNN-RNN's ``model.backbone``, a two-stream
    net's ``model_rgb``/``model_flow``, a captioner's ``src_embed``), for
    the eval forwards that follow; a train-mode forward drops the fold."""
    from tennis_torch.models import DenseNet

    for m in model.modules():
        if isinstance(m, DenseNet):
            m.fold()


def make_eval_step(model, device: torch.device, pool: str | None = None,
                   feats: bool = False):
    """Move ``model`` (a ``FrameModel``, ``CNNRNN`` or ``TwoStreamModel``)
    to ``device``, fold the BN operands of each of its DenseNets once, and
    return ``step(batch) -> f32 logits`` on ``device``: :func:`prepare_input`
    (uint8 frames or clips), then the eval forward (on a GPU every dense
    layer in a dense-layer kernel). With ``pool`` ("max" or "mean") the step
    is the ``TemporalPooling(wrap_head=True)`` wrap of a ``FrameModel``: the
    backbone features of each clip's frames in one forward (or, with
    ``feats``, (B, T, F) features as given) pooled over T, then the model's
    own head. The fold is of the weights at this call: after they change,
    make the step anew (the trainer does before every val and test pass; a
    train-mode forward also drops the fold, so a stale one is never
    reused)."""
    from tennis_torch.models import TemporalPooling

    model = model.to(device).eval()
    fold_densenets(model)
    net = model if pool is None else TemporalPooling(
        model, pool=pool, feats=feats, wrap_head=True)

    @torch.inference_mode()
    def step(batch) -> torch.Tensor:
        x = torch.as_tensor(batch).to(device)
        return net(prepare_input(x, model.dtype))

    return step


def load_classifier(backbone: str, model_id: str, data_shape: int,
                    root: str = "data", device: str = "cuda"):
    """Load a vision experiment's best epoch into a batched softmax scorer.

    Returns ``(classes, predict_probs, info)``; ``device`` is "cuda" unless
    the caller asks for "cpu".
    """
    device = resolve_device(device)
    classes, model, info = load_classifier_state(backbone, model_id,
                                                 data_shape, root)
    return classes, make_predict_probs(model, device), info


def load_captioner_state(model_id: str, root: str = "data", gnmt_argv=(),
                         src_max_len: int = 128):
    """Restore a captioning experiment's ``valid_best.params`` into
    ``(vocab, model, info)``, the model on the CPU in f32.

    Features path only. ``gnmt_argv`` carries the architecture flags the
    checkpoint was trained with (``--num_hidden=256 --feats_model=0006
    ...``), parsed by the train_gnmt flag surface. The token ids are
    positions in the train-split caption vocabulary; the first train point's
    first feature file pins the feature dim. ``info`` also records the
    decode settings the flags pin (beam size, length penalty, max length =
    tgt_max_len + 20).
    """
    from tennis_torch.bridge import load_flax
    from tennis_torch.data.tennis_set import CaptionIndex
    from tennis_torch.train_gnmt import build_model, parse_args
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils.experiments import experiment_dir

    args = parse_args([f"--root={root}", f"--model_id={model_id}",
                       *gnmt_argv])
    if not args.feats_model:
        raise ValueError("serving supports the features-path captioner only "
                         "(pass --gnmt_flag=--feats_model=<vision exp id>)")
    data_train = CaptionIndex(root, split="train", every=args.every,
                              max_cap_len=args.tgt_max_len,
                              feats_model=args.feats_model)
    vocab = data_train.vocab
    first = data_train.frames(0)[0]
    feat_dim = int(np.load(data_train.feature_path(0, first)).shape[-1])

    model = build_model(args, len(vocab), feat_dim)
    exp_dir = experiment_dir("captioning", model_id)
    best_path = os.path.join(exp_dir, "valid_best.params")
    raw = ckpt.load_raw(best_path)
    load_flax(model, {"params": raw["params"],
                      "batch_stats": raw.get("batch_stats", {})})
    log.info("loaded %s (vocab %d, feat_dim %d)", best_path, len(vocab),
             feat_dim)
    info = {"exp_dir": exp_dir, "vocab_size": len(vocab),
            "feat_dim": feat_dim, "src_max_len": src_max_len,
            "beam_size": args.beam_size, "lp_alpha": args.lp_alpha,
            "lp_k": args.lp_k, "max_length": args.tgt_max_len + 20}
    return vocab, model, info


def make_captioner(model, vocab, info: dict, device: torch.device):
    """Move ``model`` to ``device`` and return ``(translator,
    caption_batch)``: ``caption_batch(feats (B, T, D) f32, lengths (B,)
    int32) -> list of B token lists`` (the top beam, BOS/EOS stripped)."""
    from tennis_torch.translation import BeamSearchTranslator

    model = model.to(device).eval()
    translator = BeamSearchTranslator(
        model, bos_id=vocab[vocab.bos_token], eos_id=vocab[vocab.eos_token],
        beam_size=info["beam_size"], alpha=info["lp_alpha"], K=info["lp_k"],
        max_length=info["max_length"])

    def caption_batch(feats, lengths):
        return translator.translate_tokens(np.asarray(feats, np.float32),
                                           np.asarray(lengths, np.int32),
                                           vocab)

    return translator, caption_batch


def load_captioner(model_id: str, root: str = "data", gnmt_argv=(),
                   src_max_len: int = 128, device: str = "cuda"):
    """Load a captioning experiment into a live batched beam decoder.

    Returns ``(vocab, caption_batch, info)`` (see :func:`make_captioner`);
    ``device`` is "cuda" unless the caller asks for "cpu".
    """
    device = resolve_device(device)
    vocab, model, info = load_captioner_state(
        model_id, root=root, gnmt_argv=gnmt_argv, src_max_len=src_max_len)
    _, caption_batch = make_captioner(model, vocab, info, device)
    return vocab, caption_batch, info
