"""DAD-3DNet: staged encoder (resnet50, mobilenet_w1 or swinv2_b_w16) + BiFPN
+ heatmap head + fusion + 3DMM heads. Mirrors ``dad3dheads_tpu/models/dad3dnet.py``
(which has the two CNN encoders; the SwinV2 encoder, ``models/swin.py``, is
the port's own).

Public layout is the reference's: NHWC images in; heatmap (B, H/4, W/4, 68),
413-dim 3DMM and (B, 68, 2) landmarks out. Inside, the NHWC input viewed as
NCHW is a channels_last tensor, so cuDNN runs channels_last throughout.

dtype "bfloat16" runs the trunk (encoder, BiFPN, heatmap conv, fusion) under
``torch.autocast(bfloat16)``; the three regression heads always run fp32.
dtype "float32" runs the whole forward in fp32 with TF32 off
(``precision.fp32_exact``), whatever the caller's settings.
Attribute names follow the reference's state-dict keys (``encoder.model.*``,
``bifpn.*``, ``head.heatmap``, ``fusion_layer.conv1x1``,
``{shape,pose,landmarks}.logit_image.{0,3}``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..constants import (
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
)

from ..precision import fp32_exact
from .bifpn import BiFPN, ChannelScale
from .mobilenet import MobileNetStages
from .resnet import ResNet50Stages
from .swin import SwinV2Stages

ENCODERS = {"resnet50": ResNet50Stages, "mobilenet_w1": MobileNetStages, "swinv2_b_w16": SwinV2Stages}

_DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resize_bilinear_align_corners(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear NCHW resize with align_corners=True, computed in fp32 and
    returned in the input dtype."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    with torch.autocast(x.device.type, enabled=False):
        out = F.interpolate(x.float(), size=tuple(hw), mode="bilinear", align_corners=True)
    return out.to(x.dtype)


class ClassificationHead(nn.Module):
    """Global average pool -> Linear(512) -> ReLU -> Dropout -> Linear."""

    def __init__(self, in_c: int, num_classes: int, linear_size: int = 512, dropout: float = 0.3):
        super().__init__()
        self.logit_image = nn.Sequential(
            nn.Linear(in_c, linear_size), nn.ReLU(), nn.Dropout(dropout), nn.Linear(linear_size, num_classes)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit_image(torch.mean(x, dim=(2, 3)))


class FusionLayer(nn.Module):
    """sigmoid(resized heatmap), concatenated with the stage-3 map and
    pyramid level 2, a 1x1 conv, multiplied back into the stage-3 map."""

    def __init__(self, in_c: int, output_filters: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_c, output_filters, 1)

    def forward(self, x, heatmap, bifpn_map):
        hm = torch.sigmoid(resize_bilinear_align_corners(heatmap, x.shape[-2:]))
        fmap = torch.cat([x, hm, bifpn_map], dim=1)
        return self.conv1x1(fmap) * x


class DAD3DNet(nn.Module):
    """The image -> (heatmap, 3DMM, landmarks) network on the ``backbone``
    encoder (``ENCODERS``: resnet50, mobilenet_w1 or swinv2_b_w16); the
    BiFPN, fusion and heads take their widths from its channel table."""

    def __init__(
        self,
        backbone: str = "resnet50",
        num_filters: int = 256,
        num_classes: int = 68,
        limit_value: float = 3.0,
        shape_output_size: int = 403,  # shape 300 + expression 100 + jaw 3
        pose_output_size: int = 10,  # rotation 6 + translation 3 + scale 1
        dropout: float = 0.3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if backbone not in ENCODERS:
            raise KeyError(f"unknown backbone {backbone!r}: one of {sorted(ENCODERS)}")
        self.backbone = backbone
        self.dtype = dtype
        self.num_classes = num_classes
        self.limit_value = limit_value
        self.encoder = ENCODERS[backbone]()
        ch = self.encoder.encoder_channels
        self.bifpn = BiFPN((ch["layer3"], ch["layer2"], ch["layer1"]), feature_size=num_filters)
        self.head = nn.ModuleDict({"heatmap": nn.Conv2d(num_filters, num_classes, 3, padding=1)})
        self.fusion_layer = FusionLayer(ch["layer1"] + num_classes + num_filters, ch["layer1"])
        self.shape = ClassificationHead(ch["layer0"], shape_output_size, dropout=dropout)
        self.pose = ClassificationHead(ch["layer0"], pose_output_size, dropout=dropout)
        self.landmarks = ClassificationHead(ch["layer0"], num_classes * 2, dropout=dropout)

    def _trunk_context(self, device_type: str):
        if self.dtype == torch.bfloat16:
            return torch.autocast(device_type, dtype=torch.bfloat16)
        return fp32_exact()

    def neck(self, feats):
        """BiFPN + heatmap head + fusion on the encoder taps (NCHW)."""
        pyramid = self.bifpn(feats[1:])
        heatmap = self.head["heatmap"](pyramid[0])
        fmap = self.fusion_layer(feats[-1], heatmap, pyramid[2])
        return heatmap, fmap

    def heads(self, heatmap: torch.Tensor, fmap: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The three fp32 regression heads over the final encoder map."""
        fmap = fmap.float()
        shape = torch.tanh(self.shape(fmap)) * self.limit_value
        pose = self.pose(fmap)
        landmarks = F.relu(self.landmarks(fmap))
        B = landmarks.shape[0]
        return {
            OUTPUT_LANDMARKS_HEATMAP: heatmap.float().permute(0, 2, 3, 1),
            OUTPUT_3DMM_PARAMS: torch.cat([shape, pose], dim=-1),
            OUTPUT_2D_LANDMARKS: landmarks.reshape(B, self.num_classes, 2),
        }

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized images (NHWC) in the trunk's dtype
        (``self.dtype``): fp32, or bf16, which the bf16 trunk reads as it is
        (fp32 input to the bf16 trunk is cast by autocast, to the same bits)."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        with self._trunk_context(x.device.type):
            feats = self.encoder.stages_backbone(x)
            heatmap, fmap = self.neck(feats)
            fmap = self.encoder.final_stage(fmap)
            with torch.autocast(x.device.type, enabled=False):
                return self.heads(heatmap, fmap)


def create_model(config: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None) -> DAD3DNet:
    """Build DAD-3DNet from the JAX package's model config keys and
    initialise its parameters with the JAX package's scheme from
    ``generator`` (a seeded CPU generator gives the same weights on every
    device; None uses torch's default RNG)."""
    config = config or {}
    dtype = config.get("dtype", torch.float32)
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    model = DAD3DNet(
        backbone=config.get("backbone", "resnet50"),
        num_filters=config.get("num_filters", 256),
        num_classes=config.get("num_classes", 68),
        limit_value=config.get("limit_value", 3.0),
        dropout=config.get("dropout", 0.3),
        dtype=dtype,
    )
    init_parameters(model, generator)
    return model.eval()


@torch.no_grad()
def init_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisation (flax's defaults), drawn from
    ``generator``: conv and dense kernels and the BiFPN depthwise scales
    lecun_normal (a normal truncated at two standard deviations, std
    sqrt(1 / fan_in) / 0.8796; fan_in = ``weight[0].numel()``, k*k for a
    depthwise kernel, as flax's (k, k, 1, C)), biases zero, BN identity, fusion weights one.
    The numbers differ from flax's (another generator); the distribution is
    the one the reference trains from. A SwinV2 encoder takes SwinV2's own
    initialisation (``SwinV2Stages.reset_parameters``), drawn first."""
    encoder = getattr(model, "encoder", None)
    own = set()
    if isinstance(encoder, SwinV2Stages):
        encoder.reset_parameters(generator)
        own = set(encoder.modules())
    for m in model.modules():
        if m in own:
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear, ChannelScale)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for name, p in model.named_parameters():
        if name.endswith((".w1", ".w2")):
            p.fill_(1.0)


@torch.no_grad()
def randomize_bn_stats(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Give every BatchNorm non-trivial statistics and affine parameters, so
    that random-weight runs exercise the BN lanes (fresh BN is the identity)."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=generator) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=generator) * 0.5 + 0.75)
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 0.5 + 0.75)
            m.bias.copy_(torch.randn(m.bias.shape, generator=generator) * 0.1)
