"""Layer zoo: separable conv blocks, pixel-shuffle upsampling, a prediction
head, and the block registries. Mirrors ``dad3dheads_tpu/models/layers.py``.

Modules take NCHW tensors (channels_last in memory, as the rest of the
port's models keep them). Unlike flax, a torch module is built with its
input channels, so each constructor takes ``in_c`` first. Every BatchNorm
is the port's (``models/resnet.py::BatchNorm2d``: flax's biased running
variance, momentum 0.1 in torch's convention, eps 1e-5).

Children: ``ConvBlock`` is ``conv``/``bn``; ``SepConv`` is ``dw_conv`` and
``pw_conv``, each with ``conv``/``bn`` (pytorchcv's unit names, so that
MobileNet's units are ``SepConv``s); ``MixSepConv`` is ``dw_convs.{i}`` and
``pw_conv``;
``PixelShuffleUpsample`` is ``conv``; ``MaskPredictionHead`` is
``blocks.{i}`` and ``logit``. ``weights.layer_name_map`` maps the flax
names (``Conv_0``, ``BatchNorm_0``, ...) onto these.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn

from .resnet import ConvBN


class ConvBlock(ConvBN):
    """Plain conv (symmetric padding k // 2, no bias) + BN + ReLU."""

    def __init__(self, in_c: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__(in_c, features, kernel, stride)


class SepConv(nn.Module):
    """Depthwise separable conv block: depthwise k x k + BN + ReLU, then
    pointwise 1x1 + BN + ReLU."""

    def __init__(self, in_c: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.dw_conv = ConvBN(in_c, in_c, kernel, stride, groups=in_c)
        self.pw_conv = ConvBlock(in_c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw_conv(self.dw_conv(x))


def mix_split(channels: int, groups: int) -> list:
    """``channels // groups`` channels a group, the remainder on the last."""
    split = [channels // groups] * groups
    split[-1] += channels - sum(split)
    return split


class MixSepConv(nn.Module):
    """Mixed-kernel separable conv: the channel groups run depthwise convs of
    different kernel sizes (3/5/7, no BN between), concatenated, then a
    pointwise merge + BN + ReLU."""

    def __init__(self, in_c: int, features: int, kernels: Sequence[int] = (3, 5, 7)):
        super().__init__()
        self.split = mix_split(in_c, len(kernels))
        self.dw_convs = nn.ModuleList(
            nn.Conv2d(c, c, k, padding=k // 2, groups=c, bias=False) for k, c in zip(kernels, self.split)
        )
        self.pw_conv = ConvBlock(in_c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = torch.split(x, self.split, dim=1)
        return self.pw_conv(torch.cat([conv(p) for conv, p in zip(self.dw_convs, parts)], dim=1))


def pixel_shuffle(x: torch.Tensor, upscale: int = 2) -> torch.Tensor:
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r) depth-to-space in the JAX
    package's channel order: output (h*r + i, w*r + j, c) reads input channel
    i*r*C + j*C + c (``F.pixel_shuffle`` reads c*r^2 + i*r + j; the two agree
    only for C = 1). Returns a channels_last tensor."""
    B, C, H, W = x.shape
    r = upscale
    if C % (r * r):
        raise ValueError(f"pixel_shuffle: {C} channels is no multiple of {r * r}")
    y = x.permute(0, 2, 3, 1).reshape(B, H, W, r, r, C // (r * r))
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H * r, W * r, C // (r * r))
    return y.permute(0, 3, 1, 2)


class PixelShuffleUpsample(nn.Module):
    """3x3 conv (with bias) to r^2 x features, then depth-to-space."""

    def __init__(self, in_c: int, features: int, upscale: int = 2):
        super().__init__()
        self.upscale = upscale
        self.conv = nn.Conv2d(in_c, features * upscale**2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.conv(x), self.upscale)


class IdentityLayer(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


CONV_BLOCKS: Dict[str, Callable[..., nn.Module]] = {
    "conv": ConvBlock,
    "sep_conv": SepConv,
    "mix_sep_conv": MixSepConv,
}


def get_conv_block(name: str) -> Callable[..., nn.Module]:
    return CONV_BLOCKS[name]


class MaskPredictionHead(nn.Module):
    """Configurable dense-prediction head: ``num_blocks`` conv blocks of
    ``num_filters`` then a 1x1 logit conv (zero bias)."""

    def __init__(self, in_c: int, num_classes: int, num_filters: int = 128, num_blocks: int = 2,
                 block: str = "sep_conv"):
        super().__init__()
        blk = get_conv_block(block)
        self.blocks = nn.Sequential(*(blk(in_c if i == 0 else num_filters, num_filters) for i in range(num_blocks)))
        self.logit = nn.Conv2d(num_filters if num_blocks else in_c, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit(self.blocks(x))


PREDICTION_HEADS: Dict[str, Callable[..., nn.Module]] = {
    "mask": MaskPredictionHead,
}


def get_mask_prediction_layer(name: str = "mask") -> Callable[..., nn.Module]:
    return PREDICTION_HEADS[name]
