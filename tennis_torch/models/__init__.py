"""Model zoo of the port: DenseNet and ResNet-v2 backbones, R(2+1)D, the
frame classifier and the temporal and two-stream models over it."""

from tennis_torch.models.backbones import get_backbone, backbone_feature_dim
from tennis_torch.models.backbones.densenet import DenseNet, DenseNetSpec, \
    DENSENET_SPECS
from tennis_torch.models.backbones.resnet import ResNetV2, ResNetSpec, \
    RESNET_SPECS
from tennis_torch.models.frame import CNNRNN, FrameModel, TemporalPooling, \
    TimeDistributed, TwoStreamModel, time_distributed
from tennis_torch.models.r21d import R21D, R21DClassifier, get_r21d

__all__ = [
    "get_backbone",
    "backbone_feature_dim",
    "DenseNet",
    "DenseNetSpec",
    "DENSENET_SPECS",
    "ResNetV2",
    "ResNetSpec",
    "RESNET_SPECS",
    "R21D",
    "R21DClassifier",
    "get_r21d",
    "CNNRNN",
    "FrameModel",
    "TemporalPooling",
    "TimeDistributed",
    "TwoStreamModel",
    "time_distributed",
]
