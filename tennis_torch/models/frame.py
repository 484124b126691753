"""Frame-level event-classification models (counterpart of
``tennis_tpu/models/frame.py``): the time fold, :class:`FrameModel` and, for
eval, :class:`TemporalPooling`. ``CNNRNN`` and ``TwoStreamModel`` are not
ported yet."""
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
    ``head`` expose the two halves, as in the JAX module. ``train=True`` runs
    the backbone in train mode (batch statistics, under autograd).
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.head(self.features(x, train=train))

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.backbone(x, train=train)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Trained classification head over (pooled) backbone features."""
        x = x.reshape(x.shape[0], -1)
        if self.num_classes <= 0:
            return x.float()
        w, b = self.classes.weight, self.classes.bias
        return nn.functional.linear(x.to(self.dtype), w.to(self.dtype),
                                    b.to(self.dtype)).float()


class TemporalPooling(nn.Module):
    """Max/mean pool over the time axis of (B, T, ...) input, eval only.

    ``feats=True`` takes (B, T, F) features; otherwise ``model`` runs
    time-distributed first (one forward over the B*T folded frames). With
    ``wrap_head=True`` (the reference's ``num_classes == 0`` mode) the
    wrapped :class:`FrameModel`'s backbone features are pooled and its own
    trained head applied. Otherwise ``num_classes > 0`` adds a ``classes``
    head over the pooled features, computed in ``dtype`` with f32 out, named
    as flax names it so the weight bridge maps it.
    """

    def __init__(self, model: nn.Module | None = None, num_classes: int = -1,
                 pool: str = "max", feats: bool = False,
                 wrap_head: bool = False, dtype=torch.bfloat16,
                 feature_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if pool not in ("max", "mean"):
            raise ValueError(f"pool must be 'max' or 'mean', not {pool!r}")
        if wrap_head and model is None:
            raise ValueError("wrap_head pools a FrameModel's features")
        self.model = model
        self.num_classes = num_classes
        self.pool = pool
        self.feats = feats
        self.wrap_head = wrap_head
        self.dtype = dtype
        if num_classes > 0 and not wrap_head:
            if feature_dim is None:
                raise ValueError("a classification head needs feature_dim")
            self.classes = nn.Linear(feature_dim, num_classes)
            lecun_normal_(self.classes.weight, feature_dim, generator)
            nn.init.zeros_(self.classes.bias)

    def _pool(self, x):
        return x.mean(dim=1) if self.pool == "mean" else x.amax(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.wrap_head:
            if not self.feats:
                x = time_distributed(self.model.features, x)
            return self.model.head(self._pool(x))
        if not self.feats and self.model is not None:
            x = time_distributed(self.model, x)
        x = self._pool(x)
        if self.num_classes > 0:
            w, b = self.classes.weight, self.classes.bias
            x = nn.functional.linear(x.to(self.dtype), w.to(self.dtype),
                                     b.to(self.dtype))
        return x.float()
