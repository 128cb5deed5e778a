"""DAD-3DNet in plain PyTorch, fp32, as functions of a flat dict of tensors.

The frozen yardstick of the benchmark: it imports nothing of the program
under test. It follows the published DAD-3DNet (arXiv:2204.03688; PinataFarms
DAD-3DHeads ``model/resnet_regression.yaml`` and ``mobilenet_regression.yaml``):

- encoder: resnet50 (7x7/2 stem, BN, ReLU, 3x3/2 max pool, bottleneck stages
  of 3/4/6/3 units, 256/512/1024/2048 channels, the stride on the 3x3) or
  mobilenet_w1 (3x3/2 stem to 32 channels, depthwise-separable stages of
  1/2/2/6/2 units, 64..1024 channels, the first unit of stages 2-5 strided);
- a 2-block BiFPN of 256 filters on the outputs of encoder stages 1-3
  (resnet50) or 2-4 (mobilenet_w1): lateral 1x1 convs, p6 a 3x3/2 conv, p7 a
  3x3/2 conv + BN + ReLU, ReLU-normalised fusion weights (divide, then add
  1e-4), nodes of a per-channel scale, a 1x1 conv, BN (eps 4e-5) and ReLU;
- a 3x3 heatmap head on p3, the fusion layer (sigmoid of the heatmap resized
  bilinearly with aligned corners, concatenated with the deepest tapped map
  and p5, a 1x1 conv, multiplied into that map), the last encoder stage;
- three heads on the global mean: Linear(512), ReLU, Dropout(0.3), Linear,
  for 403 shape values (tanh times 3), 10 pose values and 68 landmarks (ReLU).

Parameter names are those of the published state dict, so one dict of
tensors can be handed to both sides. ``layout`` lists every tensor with its
shape and how it is initialised. ``forward`` takes ``quant``: a function
applied to both operands of every convolution of the trunk (encoder, BiFPN,
heatmap head, fusion), which is how the benchmark's control computes the
trunk in a lower precision than the configuration states. Train mode
normalises with the batch's statistics and draws the heads' dropout with
``torch.nn.functional.dropout`` in the order shape, pose, landmarks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BIFPN_BN_EPS = 4e-5
BIFPN_EPS = 1e-4
BIFPN_NODES = ("p3_td", "p4_td", "p5_td", "p6_td", "p4_out", "p5_out", "p6_out", "p7_out")
RESNET_UNITS, RESNET_CHANNELS = (3, 4, 6, 3), (256, 512, 1024, 2048)
MOBILENET_UNITS, MOBILENET_CHANNELS = (1, 2, 2, 6, 2), (64, 128, 256, 512, 1024)
# (tapped maps' channels, shallow to deep; final map's channels)
TAPS = {"resnet50": ((256, 512, 1024), 2048), "mobilenet_w1": ((128, 256, 512), 1024)}
HEADS = (("shape", 403), ("pose", 10), ("landmarks", 136))

Layout = List[Tuple[str, Tuple[int, ...], str]]
Tensors = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _bn(out: Layout, prefix: str, c: int) -> None:
    for name, kind in (("weight", "bn_weight"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                       ("running_var", "bn_var"), ("num_batches_tracked", "count")):
        out.append((f"{prefix}.{name}", () if kind == "count" else (c,), kind))


def _conv(out: Layout, prefix: str, cin: int, cout: int, k: int, bias: bool, groups: int = 1) -> None:
    out.append((f"{prefix}.weight", (cout, cin // groups, k, k), "lecun"))
    if bias:
        out.append((f"{prefix}.bias", (cout,), "zeros"))


def _conv_bn(out: Layout, prefix: str, cin: int, cout: int, k: int, groups: int = 1) -> None:
    _conv(out, f"{prefix}.conv", cin, cout, k, False, groups)
    _bn(out, f"{prefix}.bn", cout)


def layout(backbone: str, filters: int = 256, classes: int = 68) -> Layout:
    """(name, shape, init kind) of every parameter and buffer. Kinds:
    ``lecun`` (a normal truncated at two deviations, deviation
    sqrt(1 / fan_in) / 0.8796, fan_in the product of the shape after its
    first axis), ``zeros``, ``ones``, the BatchNorm's ``bn_weight``,
    ``bn_bias``, ``bn_mean``, ``bn_var``, and ``count`` (an int64 scalar)."""
    out: Layout = []
    enc = "encoder.model"
    if backbone == "resnet50":
        _conv_bn(out, f"{enc}.init_block.conv", 3, 64, 7)
        cin = 64
        for s, (units, cout) in enumerate(zip(RESNET_UNITS, RESNET_CHANNELS), start=1):
            for u in range(1, units + 1):
                p = f"{enc}.stage{s}.unit{u}"
                c = cin if u == 1 else cout
                _conv_bn(out, f"{p}.body.conv1", c, cout // 4, 1)
                _conv_bn(out, f"{p}.body.conv2", cout // 4, cout // 4, 3)
                _conv_bn(out, f"{p}.body.conv3", cout // 4, cout, 1)
                if u == 1:
                    _conv_bn(out, f"{p}.identity_conv", c, cout, 1)
            cin = cout
    elif backbone == "mobilenet_w1":
        _conv_bn(out, f"{enc}.init_block", 3, 32, 3)
        cin = 32
        for s, (units, cout) in enumerate(zip(MOBILENET_UNITS, MOBILENET_CHANNELS), start=1):
            for u in range(1, units + 1):
                p = f"{enc}.stage{s}.unit{u}"
                c = cin if u == 1 else cout
                _conv_bn(out, f"{p}.dw_conv", c, c, 3, groups=c)
                _conv_bn(out, f"{p}.pw_conv", c, cout, 1)
            cin = cout
    else:
        raise KeyError(f"unknown backbone {backbone!r}")
    (c2, c3, c4), final = TAPS[backbone]
    for name, cin in (("p3", c2), ("p4", c3), ("p5", c4)):
        _conv(out, f"bifpn.{name}", cin, filters, 1, True)
    _conv(out, "bifpn.p6", c4, filters, 3, True)
    _conv(out, "bifpn.p7.conv", filters, filters, 3, True)
    _bn(out, "bifpn.p7.bn", filters)
    for k in range(2):
        out += [(f"bifpn.bifpn.{k}.w1", (2, 4), "ones"), (f"bifpn.bifpn.{k}.w2", (3, 4), "ones")]
        for node in BIFPN_NODES:
            p = f"bifpn.bifpn.{k}.{node}"
            out.append((f"{p}.depthwise.weight", (filters, 1, 1, 1), "lecun"))
            _conv(out, f"{p}.pointwise", filters, filters, 1, False)
            _bn(out, f"{p}.bn", filters)
    _conv(out, "head.heatmap", filters, classes, 3, True)
    _conv(out, "fusion_layer.conv1x1", c4 + classes + filters, c4, 1, True)
    for head, n in HEADS:
        out += [(f"{head}.logit_image.0.weight", (512, final), "lecun"), (f"{head}.logit_image.0.bias", (512,), "zeros"),
                (f"{head}.logit_image.3.weight", (n, 512), "lecun"), (f"{head}.logit_image.3.bias", (n,), "zeros")]
    return out


class _Net:
    """One forward pass over the tensors ``P``."""

    def __init__(self, P: Tensors, train: bool, quant: Quant, stats: Optional[dict] = None):
        self.P, self.train, self.quant, self.stats = P, train, quant, stats

    def conv(self, x, prefix, stride=1, padding=0, groups=1):
        w, b = self.P[f"{prefix}.weight"], self.P.get(f"{prefix}.bias")
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv2d(x, w, b, stride, padding, 1, groups)

    def bn(self, x, prefix, eps=BN_EPS):
        P = self.P
        if self.train:  # the batch's statistics, the biased variance
            if self.stats is not None:
                with torch.no_grad():
                    self.stats[prefix] = (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False))
            return F.batch_norm(x, None, None, P[f"{prefix}.weight"], P[f"{prefix}.bias"], True, 0.0, eps)
        return F.batch_norm(x, P[f"{prefix}.running_mean"], P[f"{prefix}.running_var"], P[f"{prefix}.weight"],
                            P[f"{prefix}.bias"], False, 0.0, eps)

    def conv_bn(self, x, prefix, stride=1, relu=True, groups=1):
        k = self.P[f"{prefix}.conv.weight"].shape[-1]
        y = self.bn(self.conv(x, f"{prefix}.conv", stride, k // 2, groups), f"{prefix}.bn")
        return F.relu(y) if relu else y

    # -- encoders: the tapped maps (shallow to deep), then the last stage --
    def resnet_unit(self, x, p, stride):
        y = self.conv_bn(x, f"{p}.body.conv1")
        y = self.conv_bn(y, f"{p}.body.conv2", stride)
        y = self.conv_bn(y, f"{p}.body.conv3", relu=False)
        identity = self.conv_bn(x, f"{p}.identity_conv", stride, relu=False) if f"{p}.identity_conv.conv.weight" in self.P else x
        return F.relu(y + identity)

    def resnet_stage(self, x, s):
        for u in range(1, RESNET_UNITS[s - 1] + 1):
            x = self.resnet_unit(x, f"encoder.model.stage{s}.unit{u}", 2 if (u == 1 and s > 1) else 1)
        return x

    def mobilenet_stage(self, x, s):
        for u in range(1, MOBILENET_UNITS[s - 1] + 1):
            p = f"encoder.model.stage{s}.unit{u}"
            x = self.conv_bn(x, f"{p}.dw_conv", 2 if (u == 1 and s > 1) else 1, groups=x.shape[1])
            x = self.conv_bn(x, f"{p}.pw_conv")
        return x

    def encoder_taps(self, x, backbone):
        if backbone == "resnet50":
            x = F.max_pool2d(self.conv_bn(x, "encoder.model.init_block.conv", 2), 3, 2, 1)
            taps = []
            for s in (1, 2, 3):
                x = self.resnet_stage(x, s)
                taps.append(x)
            return taps
        x = self.mobilenet_stage(self.conv_bn(x, "encoder.model.init_block", 2), 1)
        taps = []
        for s in (2, 3, 4):
            x = self.mobilenet_stage(x, s)
            taps.append(x)
        return taps

    def final_stage(self, x, backbone):
        return self.resnet_stage(x, 4) if backbone == "resnet50" else self.mobilenet_stage(x, 5)

    # -- BiFPN --
    @staticmethod
    def nearest(x, ref):
        h, w = ref.shape[-2:]
        if tuple(x.shape[-2:]) == (h, w):
            return x
        return F.interpolate(x, size=(h, w), mode="nearest")

    def node(self, x, p):
        x = x * self.P[f"{p}.depthwise.weight"].reshape(1, -1, 1, 1)
        return F.relu(self.bn(self.conv(x, f"{p}.pointwise"), f"{p}.bn", BIFPN_BN_EPS))

    def bifpn_block(self, feats, k):
        P, p = self.P, f"bifpn.bifpn.{k}"
        w1 = F.relu(P[f"{p}.w1"])
        w1 = w1 / w1.sum(0) + BIFPN_EPS
        w2 = F.relu(P[f"{p}.w2"])
        w2 = w2 / w2.sum(0) + BIFPN_EPS

        def fuse(ws, xs, ref):
            return sum(w * self.nearest(x, ref) for w, x in zip(ws, xs))

        x3, x4, x5, x6, x7 = feats
        t6 = self.node(fuse(w1[:, 0], (x6, x7), x6), f"{p}.p6_td")
        t5 = self.node(fuse(w1[:, 1], (x5, t6), x5), f"{p}.p5_td")
        t4 = self.node(fuse(w1[:, 2], (x4, t5), x4), f"{p}.p4_td")
        t3 = self.node(fuse(w1[:, 3], (x3, t4), x3), f"{p}.p3_td")
        o4 = self.node(fuse(w2[:, 0], (x4, t4, t3), x4), f"{p}.p4_out")
        o5 = self.node(fuse(w2[:, 1], (x5, t5, o4), x5), f"{p}.p5_out")
        o6 = self.node(fuse(w2[:, 2], (x6, t6, o5), x6), f"{p}.p6_out")
        o7 = self.node(fuse(w2[:, 3], (x7, x7, o6), x7), f"{p}.p7_out")
        return [t3, o4, o5, o6, o7]

    def bifpn(self, taps):
        c2, c3, c4 = taps
        p6 = self.conv(c4, "bifpn.p6", 2, 1)
        p7 = F.relu(self.bn(self.conv(p6, "bifpn.p7.conv", 2, 1), "bifpn.p7.bn", BIFPN_BN_EPS))
        feats = [self.conv(c2, "bifpn.p3"), self.conv(c3, "bifpn.p4"), self.conv(c4, "bifpn.p5"), p6, p7]
        for k in range(2):
            feats = self.bifpn_block(feats, k)
        return feats

    def head(self, x, name):
        P, p = self.P, f"{name}.logit_image"
        h = F.relu(F.linear(x, P[f"{p}.0.weight"], P[f"{p}.0.bias"]))
        h = F.dropout(h, 0.3, training=self.train)
        return F.linear(h, P[f"{p}.3.weight"], P[f"{p}.3.bias"])

    def forward(self, images_nhwc, backbone):
        x = images_nhwc.permute(0, 3, 1, 2)
        taps = self.encoder_taps(x, backbone)
        pyramid = self.bifpn(taps)
        heatmap = self.conv(pyramid[0], "head.heatmap", 1, 1)
        deep = taps[-1]
        hm = torch.sigmoid(F.interpolate(heatmap, size=deep.shape[-2:], mode="bilinear", align_corners=True))
        fmap = self.conv(torch.cat([deep, hm, pyramid[2]], dim=1), "fusion_layer.conv1x1") * deep
        pooled = self.final_stage(fmap, backbone).mean(dim=(2, 3))
        shape = torch.tanh(self.head(pooled, "shape")) * 3.0
        pose = self.head(pooled, "pose")
        landmarks = F.relu(self.head(pooled, "landmarks")).reshape(pooled.shape[0], -1, 2)
        return {"heatmap": heatmap.permute(0, 2, 3, 1), "3dmm": torch.cat([shape, pose], dim=1), "landmarks": landmarks}


def forward(P: Tensors, images: torch.Tensor, backbone: str, train: bool = False, quant: Quant = None,
            stats: Optional[dict] = None) -> Tensors:
    """Normalised NHWC fp32 images -> {"heatmap" (B, H/4, W/4, 68) logits,
    "3dmm" (B, 413), "landmarks" (B, 68, 2) normalised to the image size}.
    In train mode ``stats``, when given, receives each BatchNorm's batch mean
    and biased variance by its name."""
    return _Net(P, train, quant, stats).forward(images, backbone)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> fp32 (x / 255 - mean) / std, ImageNet statistics."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std
