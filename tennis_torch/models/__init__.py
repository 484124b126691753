"""Model zoo of the port: DenseNet backbones and the frame classifier."""

from tennis_torch.models.backbones import get_backbone, backbone_feature_dim
from tennis_torch.models.backbones.densenet import DenseNet, DenseNetSpec, \
    DENSENET_SPECS
from tennis_torch.models.frame import FrameModel, TimeDistributed, \
    time_distributed

__all__ = [
    "get_backbone",
    "backbone_feature_dim",
    "DenseNet",
    "DenseNetSpec",
    "DENSENET_SPECS",
    "FrameModel",
    "TimeDistributed",
    "time_distributed",
]
