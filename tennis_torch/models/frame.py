"""Frame-level and temporal event-classification models (counterpart of
``tennis_tpu/models/frame.py``): the time fold, :class:`FrameModel`, the
eval-mode :class:`TemporalPooling` wrap, :class:`CNNRNN` and
:class:`TwoStreamModel`. Submodules carry the flax names (``backbone``,
``model``, ``rnn``, ``model_rgb``, ``model_flow``, ``classes``), so the
weight bridge maps them 1:1."""
from __future__ import annotations

import torch
from torch import nn

from tennis_torch.models.backbones.densenet import lecun_normal_
from tennis_torch.ops.rnn import BiRNN


def _classes(feature_dim, num_classes, generator) -> nn.Linear:
    """A ``classes`` head: flax ``nn.Dense`` initialisation."""
    if feature_dim is None:
        raise ValueError("a classification head needs feature_dim")
    layer = nn.Linear(feature_dim, num_classes)
    lecun_normal_(layer.weight, feature_dim, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _head(layer: nn.Linear, x, dtype):
    """``layer(x)`` in ``dtype`` (flax ``Dense(dtype)``), f32 out."""
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                layer.bias.to(dtype)).float()


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
            self.classes = _classes(feature_dim, num_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.head(self.features(x, train=train))

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.backbone(x, train=train)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Trained classification head over (pooled) backbone features."""
        x = x.reshape(x.shape[0], -1)
        if self.num_classes <= 0:
            return x.float()
        return _head(self.classes, x, self.dtype)


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
            self.classes = _classes(feature_dim, num_classes, generator)

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
            return _head(self.classes, x, self.dtype)
        return x.float()


class CNNRNN(nn.Module):
    """Time-distributed model -> bidirectional GRU/LSTM -> max over time ->
    ``classes``, the JAX module's computation.

    ``model=None`` takes (B, T, F) features (``feature_dim`` F; the
    published 0042 configuration); otherwise ``model`` (a head-less
    :class:`FrameModel`) runs over the B*T frames of (B, T, S, S, C) clips
    in one forward, ``train`` passed on. The sequence is cast to ``dtype``,
    the :class:`BiRNN` (``rnn``, hidden ``hidden_size`` each way) runs in
    it, the max over T and the head too; the logits come out in f32."""

    def __init__(self, model: nn.Module | None = None, num_classes: int = -1,
                 hidden_size: int = 128, cell_type: str = "gru",
                 dtype=torch.bfloat16, feature_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if feature_dim is None:
            raise ValueError("CNNRNN needs feature_dim, the width of each "
                             "step's input")
        self.model = model
        self.num_classes = num_classes
        self.dtype = dtype
        self.rnn = BiRNN(cell_type, feature_dim, hidden_size, generator,
                         dtype=dtype)
        if num_classes > 0:
            self.classes = _classes(2 * hidden_size, num_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.model is not None:
            x = time_distributed(self.model, x, train=train)
        _, x = self.rnn(x.to(self.dtype))
        x = x.amax(dim=1)
        if self.num_classes > 0:
            return _head(self.classes, x, self.dtype)
        return x.float()


class TwoStreamModel(nn.Module):
    """Two-stream RGB + flow model over 6-channel NHWC input, the JAX
    module's computation: channels 0-2 through ``model_rgb``, 3-5 through
    ``model_flow`` (backbones; each ``feature_dim`` wide), the features
    concatenated (RGB first) and ``classes`` applied in ``dtype``, f32
    logits out. ``model_rgb=None`` is ``--flow only``: the flow features
    alone."""

    def __init__(self, model_rgb: nn.Module | None, model_flow: nn.Module,
                 num_classes: int, dtype=torch.bfloat16,
                 feature_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if feature_dim is None:
            raise ValueError("a classification head needs feature_dim")
        self.model_rgb = model_rgb
        self.model_flow = model_flow
        self.dtype = dtype
        streams = 1 if model_rgb is None else 2
        self.classes = _classes(streams * feature_dim, num_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        rgb, flow = x[..., :3], x[..., 3:6]
        feats = self.model_flow(flow, train=train)
        if self.model_rgb is not None:
            feats = torch.cat([self.model_rgb(rgb, train=train), feats], -1)
        return _head(self.classes, feats, self.dtype)
