"""BiFPN (bidirectional feature pyramid). Mirrors
``dad3dheads_tpu/models/bifpn.py``: lateral 1x1 convs on C2/C3/C4, p6 = 3x3/2
conv on C4, p7 = conv-BN-ReLU 3x3/2 on p6, then ``num_layers`` blocks with
ReLU-normalized fusion weights (w1 (2, 4) top-down, w2 (3, 4) bottom-up; divide,
then add eps) and depthwise-separable conv+BN+ReLU nodes.

Attribute names follow the reference's state-dict keys (``p3``..``p6``,
``p7.{conv,bn}``, ``bifpn.{k}.{node}.{depthwise,pointwise,bn}``, ``w1``/``w2``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm2d

BIFPN_BN_EPS = 4e-5
BIFPN_BN_MOMENTUM = 0.9997  # torch's convention; the reference's flax momentum 0.0003
BIFPN_NODES = ("p3_td", "p4_td", "p5_td", "p6_td", "p4_out", "p5_out", "p6_out", "p7_out")


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of an NCHW tensor with src = floor(dst * src_size /
    dst_size), the semantics of F.interpolate(mode="nearest"). A 2x
    downsample is the strided slice it amounts to."""
    H, W = x.shape[-2:]
    h, w = hw
    if (H, W) == (h, w):
        return x
    if H == 2 * h and W == 2 * w:
        return x[:, :, ::2, ::2]
    return F.interpolate(x, size=(h, w), mode="nearest")


class ChannelScale(nn.Module):
    """A 1x1 depthwise conv written as the per-channel multiply it is; the
    weight keeps the conv's (C, 1, 1, 1) shape and state-dict key."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, 1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.reshape(1, -1, 1, 1)


class DepthwiseSeparableConvBlock(nn.Module):
    """Depthwise 1x1 (a channel scale) + pointwise 1x1 + BN + ReLU."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.depthwise = ChannelScale(in_c)
        self.pointwise = nn.Conv2d(in_c, out_c, 1, bias=False)
        self.bn = BatchNorm2d(out_c, eps=BIFPN_BN_EPS, momentum=BIFPN_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.pointwise(self.depthwise(x))))


class ConvBNBlock(nn.Module):
    """Conv (with bias, symmetric padding k // 2) + BN + ReLU."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 3, stride: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=kernel // 2)
        self.bn = BatchNorm2d(out_c, eps=BIFPN_BN_EPS, momentum=BIFPN_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BiFPNBlock(nn.Module):
    def __init__(self, feature_size: int, epsilon: float = 1e-4):
        super().__init__()
        self.epsilon = epsilon
        self.w1 = nn.Parameter(torch.ones(2, 4))
        self.w2 = nn.Parameter(torch.ones(3, 4))
        for node in BIFPN_NODES:
            setattr(self, node, DepthwiseSeparableConvBlock(feature_size, feature_size))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        p3_x, p4_x, p5_x, p6_x, p7_x = inputs
        w1 = F.relu(self.w1)
        w11 = w1 / torch.sum(w1, dim=0) + self.epsilon
        w2 = F.relu(self.w2)
        w22 = w2 / torch.sum(w2, dim=0) + self.epsilon

        def fuse(ws, xs, ref):
            # fp32 weighted sum, as the reference's fp32 weights promote a
            # bf16 trunk's features; the node's pointwise conv casts back
            return sum(w * resize_nearest(x, ref.shape[-2:]).float() for w, x in zip(ws, xs))

        # top-down
        p7_td = p7_x
        p6_td = self.p6_td(fuse(w11[:, 0], (p6_x, p7_td), p6_x))
        p5_td = self.p5_td(fuse(w11[:, 1], (p5_x, p6_td), p5_x))
        p4_td = self.p4_td(fuse(w11[:, 2], (p4_x, p5_td), p4_x))
        p3_td = self.p3_td(fuse(w11[:, 3], (p3_x, p4_td), p3_x))

        # bottom-up
        p3_out = p3_td
        p4_out = self.p4_out(fuse(w22[:, 0], (p4_x, p4_td, p3_out), p4_x))
        p5_out = self.p5_out(fuse(w22[:, 1], (p5_x, p5_td, p4_out), p5_x))
        p6_out = self.p6_out(fuse(w22[:, 2], (p6_x, p6_td, p5_out), p6_x))
        p7_out = self.p7_out(fuse(w22[:, 3], (p7_x, p7_td, p6_out), p7_x))
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class BiFPN(nn.Module):
    """sizes: input channels of [C2, C3, C4] (shallow -> deep)."""

    def __init__(self, sizes: Sequence[int], feature_size: int = 128, num_layers: int = 2):
        super().__init__()
        self.sizes = tuple(sizes)
        f = feature_size
        self.p3 = nn.Conv2d(sizes[0], f, 1)
        self.p4 = nn.Conv2d(sizes[1], f, 1)
        self.p5 = nn.Conv2d(sizes[2], f, 1)
        self.p6 = nn.Conv2d(sizes[2], f, 3, stride=2, padding=1)
        self.p7 = ConvBNBlock(f, f, 3, 2)
        self.bifpn = nn.Sequential(*(BiFPNBlock(f) for _ in range(num_layers)))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        got = tuple(int(t.shape[1]) for t in inputs)
        if got != self.sizes:
            raise ValueError(f"BiFPN input channels {got} do not match sizes={self.sizes}")
        c2, c3, c4 = inputs
        p6_x = self.p6(c4)
        feats = [self.p3(c2), self.p4(c3), self.p5(c4), p6_x, self.p7(p6_x)]
        for block in self.bifpn:
            feats = block(feats)
        return feats
