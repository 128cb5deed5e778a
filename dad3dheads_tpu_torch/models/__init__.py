from .bifpn import BiFPN
from .dad3dnet import DAD3DNet, create_model, init_parameters, randomize_bn_stats
from .layers import (
    CONV_BLOCKS,
    PREDICTION_HEADS,
    ConvBlock,
    IdentityLayer,
    MaskPredictionHead,
    MixSepConv,
    PixelShuffleUpsample,
    SepConv,
    get_conv_block,
    get_mask_prediction_layer,
    pixel_shuffle,
)
from .mobilenet import MobileNetStages
from .resnet import ENCODER_CHANNELS, ResNet50Stages

__all__ = [
    "BiFPN",
    "DAD3DNet",
    "create_model",
    "init_parameters",
    "randomize_bn_stats",
    "ENCODER_CHANNELS",
    "MobileNetStages",
    "ResNet50Stages",
    "CONV_BLOCKS",
    "PREDICTION_HEADS",
    "ConvBlock",
    "SepConv",
    "MixSepConv",
    "PixelShuffleUpsample",
    "pixel_shuffle",
    "IdentityLayer",
    "MaskPredictionHead",
    "get_conv_block",
    "get_mask_prediction_layer",
]
