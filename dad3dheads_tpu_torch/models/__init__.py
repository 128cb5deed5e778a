from .bifpn import BiFPN
from .dad3dnet import DAD3DNet, create_model, init_parameters, randomize_bn_stats
from .resnet import ENCODER_CHANNELS, ResNet50Stages

__all__ = [
    "BiFPN",
    "DAD3DNet",
    "create_model",
    "init_parameters",
    "randomize_bn_stats",
    "ENCODER_CHANNELS",
    "ResNet50Stages",
]
