"""Staged MobileNet-w1 encoder for DAD-3DNet. Mirrors
``dad3dheads_tpu/models/mobilenet.py``: an init block (3x3/2 conv to 32
channels + BN + ReLU), then depthwise-separable stages of 1/2/2/6/2 units
with 64/128/256/512/1024 output channels; the first unit of stages 2-5
strides 2 (on its depthwise conv). Padding is the symmetric 1 of the JAX
package.

Stage grouping is the JAX package's: ``stages_backbone`` returns the outputs
of stages 1-4, the init block folded into the first, and ``final_stage``
runs stage 5. Attribute names follow the reference's pytorchcv keys
(``model.init_block.{conv,bn}``,
``model.stage{S}.unit{U}.{dw_conv,pw_conv}.{conv,bn}``), so a reference
state dict loads as is.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch
import torch.nn as nn

from .layers import SepConv
from .resnet import ENCODER_CHANNELS, ConvBN

MOBILENET_UNITS = (1, 2, 2, 6, 2)
MOBILENET_CHANNELS = (64, 128, 256, 512, 1024)


class MobileNetStages(nn.Module):
    encoder_channels = ENCODER_CHANNELS["mobilenet_w1"]

    def __init__(self):
        super().__init__()
        self.model = nn.ModuleDict({"init_block": ConvBN(3, 32, 3, 2)})
        in_c = 32
        for s, (units, out_c) in enumerate(zip(MOBILENET_UNITS, MOBILENET_CHANNELS), start=1):
            self.model[f"stage{s}"] = nn.Sequential(OrderedDict(
                (f"unit{u + 1}", SepConv(in_c if u == 0 else out_c, out_c, 3, 2 if s > 1 and u == 0 else 1))
                for u in range(units)
            ))
            in_c = out_c

    def stages_backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Run the init block and stages 1..4, returning the stages' outputs."""
        outs = [self.model["stage1"](self.model["init_block"](x))]
        for s in (2, 3, 4):
            outs.append(self.model[f"stage{s}"](outs[-1]))
        return outs

    def final_stage(self, x: torch.Tensor) -> torch.Tensor:
        return self.model["stage5"](x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = self.stages_backbone(x)
        outs.append(self.final_stage(outs[-1]))
        return outs
