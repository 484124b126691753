"""Checkpoint -> batched softmax scorer for the serving path (counterpart of
``tennis_tpu/inference.py``; the captioner loader is not ported yet).

A vision experiment's best epoch (``best_or_latest``) is read with
``load_raw``, its ``params``/``batch_stats`` go through the weight bridge into
``FrameModel(DenseNet)``, the BN operands are folded once, and
``predict_probs`` maps a uint8 batch (B, S, S, 3) to host (B, classes) softmax
on the chosen device: uint8 upload -> ``device_prepare`` -> forward (every
dense layer through the dense-layer kernel) -> softmax.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

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
                      dtype=torch.bfloat16,
                      generator: torch.Generator | None = None):
    """``FrameModel(get_backbone(backbone))`` with its head sized for square
    ``data_shape`` inputs."""
    from tennis_torch.models import FrameModel, backbone_feature_dim, \
        get_backbone

    return FrameModel(get_backbone(backbone, dtype=dtype, generator=generator),
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
    ``predict_probs(uint8 (B, S, S, 3)) -> np.ndarray (B, classes)``."""
    from tennis_torch.data.transforms import device_prepare

    model = model.to(device).eval()
    model.backbone.fold()

    @torch.inference_mode()
    def predict_probs(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.uint8)).to(device)
        logits = model(device_prepare(x, model.dtype))
        return torch.softmax(logits, dim=-1).cpu().numpy()

    return predict_probs


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
