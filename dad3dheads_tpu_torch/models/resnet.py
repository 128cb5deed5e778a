"""Staged ResNet-50 encoder for DAD-3DNet. Mirrors
``dad3dheads_tpu/models/resnet.py``: an init block (7x7/2 conv + BN + ReLU +
3x3/2 max pool), then bottleneck stages of 3/4/6/3 units with 256/512/1024/2048
output channels and strides 1/2/2/2 (stride on the 3x3 conv).

Modules take NCHW tensors (the network keeps them channels_last in memory).
Attribute names follow the reference's pytorchcv state-dict keys
(``model.init_block.conv.{conv,bn}``, ``model.stage{S}.unit{U}.body.conv{1,2,3}``,
``...unit1.identity_conv``), so a reference state dict loads as is.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; the reference's flax momentum 0.9


class GroupRef:
    """A ``torch.distributed`` process group held by a module: copies of the
    module share it (``copy.deepcopy`` cannot copy a ``ProcessGroup``)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward updates the running
    variance with the biased batch variance, as flax's ``BatchNorm`` does
    (torch folds in the unbiased one, n/(n-1) larger). Same parameters,
    buffers and state-dict keys; eval mode is untouched.

    The batch norm updates a copy of the running variance to
    (1-m) old + m u, u = b n/(n-1); the flax value (1-m) old + m b is that
    times (n-1)/n plus (1-m) old / n, a sum of two non-negative terms (no
    cancellation). The copy keeps the running variance that autograd saved
    for the backward unmodified.

    ``sync_group``: a ``torch.distributed`` process group of more than one
    rank (``parallel.set_sync_bn``) makes the train-mode statistics those of
    the group's global batch (``_global_batch_forward``); None (or a group
    of one) runs the local batch norm above."""

    _sync: Optional[GroupRef] = None

    @property
    def sync_group(self):
        return None if self._sync is None else self._sync.group

    @sync_group.setter
    def sync_group(self, group) -> None:
        self._sync = None if group is None else GroupRef(group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.sync_group is not None:
            return self._global_batch_forward(x)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(var, alpha=(n - 1) / n)
        return y

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the group's global batch, as the JAX step's BN
        reduces over the batch axis sharded across its mesh: the per-channel
        sums (and the element count) added over the group by a differentiable
        all-reduce give the global mean, whose backward carries the other
        ranks' terms; the squared deviations from that mean are summed the
        same way (two passes: E[x^2] - E[x]^2 cancels in fp32 on channels
        whose mean is large against their spread); normalised with the
        biased variance, in fp32, and returned in the input's dtype. The
        running statistics follow flax's rule with the global count:
        (1-m) old + m mean, (1-m) old + m var."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        xf = x.float()
        n = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), n]), group=self.sync_group)
        count = sums[c].detach()
        mean = sums[:c] / count
        d = xf - mean.view(1, c, 1, 1)
        var = all_reduce((d * d).sum(dim=(0, 2, 3)), group=self.sync_group) / count
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = d * scale.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean.detach(), alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var.detach(), alpha=self.momentum)
        return y.to(x.dtype)


# Per-backbone channel tables, keyed like the reference's backbone.yaml
# (layer0 = deepest), as the JAX package's ``ENCODER_CHANNELS``.
ENCODER_CHANNELS: Dict[str, Dict[str, int]] = {
    "resnet50": {"layer0": 2048, "layer1": 1024, "layer2": 512, "layer3": 256, "layer4": 64},
    "mobilenet_w1": {"layer0": 1024, "layer1": 512, "layer2": 256, "layer3": 128, "layer4": 64},
    "swinv2_b_w16": {"layer0": 1024, "layer1": 512, "layer2": 256, "layer3": 128, "layer4": 128},
}
RESNET50_UNITS = (3, 4, 6, 3)
RESNET50_CHANNELS = (256, 512, 1024, 2048)


class ConvBN(nn.Module):
    """Bias-free conv with explicit symmetric padding k // 2, BN, optional
    ReLU; ``groups=in_c`` makes it depthwise."""

    def __init__(
        self, in_c: int, out_c: int, kernel: int = 3, stride: int = 1, use_relu: bool = True, groups: int = 1
    ):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=kernel // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(out_c, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with a projection shortcut where the shape
    changes."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1):
        super().__init__()
        inner = out_c // 4
        self.body = nn.Module()
        self.body.conv1 = ConvBN(in_c, inner, 1)
        self.body.conv2 = ConvBN(inner, inner, 3, stride)
        self.body.conv3 = ConvBN(inner, out_c, 1, use_relu=False)
        self.identity_conv = (
            ConvBN(in_c, out_c, 1, stride, use_relu=False)
            if stride != 1 or in_c != out_c
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.body.conv3(self.body.conv2(self.body.conv1(x)))
        identity = x if self.identity_conv is None else self.identity_conv(x)
        return F.relu(y + identity)


class ResNetInitBlock(nn.Module):
    def __init__(self, out_c: int = 64):
        super().__init__()
        self.conv = ConvBN(3, out_c, 7, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv(x), 3, stride=2, padding=1)


class ResNetStage(nn.Sequential):
    """``num_units`` bottlenecks named unit1..unitN; the first one strides."""

    def __init__(self, in_c: int, out_c: int, num_units: int, stride: int):
        super().__init__()
        for u in range(num_units):
            self.add_module(
                f"unit{u + 1}", Bottleneck(in_c if u == 0 else out_c, out_c, stride if u == 0 else 1)
            )


class ResNet50Stages(nn.Module):
    """The five stages exposed separately: DAD-3DNet runs stages 0-3, branches
    through BiFPN + fusion, then runs stage 4 on the fused map."""

    encoder_channels = ENCODER_CHANNELS["resnet50"]

    def __init__(self):
        super().__init__()
        self.model = nn.ModuleDict({"init_block": ResNetInitBlock(64)})
        in_c = 64
        for s, (units, out_c) in enumerate(zip(RESNET50_UNITS, RESNET50_CHANNELS), start=1):
            self.model[f"stage{s}"] = ResNetStage(in_c, out_c, units, 1 if s == 1 else 2)
            in_c = out_c

    def stages_backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Run stages 0..3, returning each output."""
        outs = [self.model["init_block"](x)]
        for s in (1, 2, 3):
            outs.append(self.model[f"stage{s}"](outs[-1]))
        return outs

    def final_stage(self, x: torch.Tensor) -> torch.Tensor:
        return self.model["stage4"](x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = self.stages_backbone(x)
        outs.append(self.final_stage(outs[-1]))
        return outs
