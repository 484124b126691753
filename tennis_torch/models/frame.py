"""Frame-level event-classification models (counterpart of
``tennis_tpu/models/frame.py``). Only :class:`FrameModel` and the time fold
are ported yet; ``TemporalPooling``, ``CNNRNN`` and ``TwoStreamModel`` wait
for the RNN substrate."""
from __future__ import annotations

import torch
from torch import nn

from tennis_torch.models.backbones.densenet import lecun_normal_


def time_distributed(model_fn, x, *args, **kwargs):
    """Apply ``model_fn`` over (B, T, ...) by folding time into batch."""
    B, T = x.shape[0], x.shape[1]
    y = model_fn(x.reshape((B * T,) + tuple(x.shape[2:])), *args, **kwargs)
    return y.reshape((B, T) + tuple(y.shape[1:]))


class TimeDistributed(nn.Module):
    """Module wrapper form of :func:`time_distributed`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, *args, **kwargs):
        return time_distributed(self.model, x, *args, **kwargs)


class FrameModel(nn.Module):
    """Backbone + optional Dense classification head (``classes``).

    ``num_classes > 0`` adds the head, computed in ``dtype`` with f32 logits
    out; otherwise the f32 backbone features are the output. ``features`` and
    ``head`` expose the two halves, as in the JAX module.
    """

    def __init__(self, backbone: nn.Module, num_classes: int = -1,
                 dtype=torch.bfloat16, feature_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.dtype = dtype
        if num_classes > 0:
            if feature_dim is None:
                raise ValueError("a classification head needs feature_dim")
            self.classes = nn.Linear(feature_dim, num_classes)
            lecun_normal_(self.classes.weight, feature_dim, generator)
            nn.init.zeros_(self.classes.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Trained classification head over (pooled) backbone features."""
        x = x.reshape(x.shape[0], -1)
        if self.num_classes <= 0:
            return x.float()
        w, b = self.classes.weight, self.classes.bias
        return nn.functional.linear(x.to(self.dtype), w.to(self.dtype),
                                    b.to(self.dtype)).float()
