"""Model zoo of the port: DenseNet backbones, the frame classifier and the
temporal and two-stream models over it."""

from tennis_torch.models.backbones import get_backbone, backbone_feature_dim
from tennis_torch.models.backbones.densenet import DenseNet, DenseNetSpec, \
    DENSENET_SPECS
from tennis_torch.models.frame import CNNRNN, FrameModel, TemporalPooling, \
    TimeDistributed, TwoStreamModel, time_distributed

__all__ = [
    "get_backbone",
    "backbone_feature_dim",
    "DenseNet",
    "DenseNetSpec",
    "DENSENET_SPECS",
    "CNNRNN",
    "FrameModel",
    "TemporalPooling",
    "TimeDistributed",
    "TwoStreamModel",
    "time_distributed",
]
