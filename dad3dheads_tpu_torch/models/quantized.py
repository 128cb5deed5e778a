"""int8 post-training-quantized inference of DAD-3DNet (resnet50). Port of
``dad3dheads_tpu/models/quantized.py``.

A functional mirror of the network that reads the port's own ``DAD3DNet``
modules and buffers: BatchNorm (and the BiFPN depthwise scales) folded into
each conv, kernels quantized per output channel, activations per tensor with
calibrated scales, int8 activations between the convs of the encoder and the
BiFPN. The heatmap head and the fusion conv are int8 convs with a dense
output; the three regression heads run through ``DAD3DNet.heads`` in fp32.
Tensors inside the mirror are NHWC, as in the JAX package; every conv site
goes through :func:`_quant_conv_generic`.

Modes:
  "fp"    - folded-BN float forward (parity and weight preparation)
  "calib" - the float forward that also records max |x| at every site
  "int8"  - the quantized forward on a calibrated amax table

The site names are the JAX package's, letter for letter
(``init_block/ConvBN_0/in``, ``stage2/Bottleneck_3/out``,
``bifpn/block1/p5_out/out``, ``heatmap_head/in``, ``fusion/out``, ...), so an
amax ``.npz`` written by either package serves in the other.

``dtype`` is the model's: the mirror casts where the JAX mirror casts and
runs under no autocast. A float conv of fp and calib mode takes its inputs in
``dtype`` and sums in fp32, then adds the fp32 bias and rounds to ``dtype``,
as the JAX mirror's ``preferred_element_type=float32`` conv does (a bf16
conv would round before the bias); the products of bf16 values are exact in
fp32. The whole mirror runs inside ``precision.fp32_exact``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import fp32_exact
from .bifpn import resize_nearest
from .quant import (
    QTensor,
    _amax_scale,
    add_relu_requant,
    conv_int8,
    dequantize,
    fold_bn,
    gemm_weight,
    quantize,
    quantize_weights_per_channel,
)

# stage layout of resnet50: (name, units); the first unit strides
_STAGES = (("stage1", 3), ("stage2", 4), ("stage3", 6), ("stage4", 3))
MODES = ("fp", "calib", "int8")

QParams = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class _Ctx:
    """Carries the mode, the amax table and the prepared kernels through
    the mirror."""

    def __init__(self, mode: str, amax: Optional[Dict[str, torch.Tensor]], dtype: torch.dtype,
                 qparams: Optional[QParams] = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.amax = dict(amax or {})
        self.dtype = dtype
        self.qparams = qparams  # site -> (gemm_weight int8, weight scale, bias)
        self.collect: Optional[QParams] = None  # prepare_int8_params
        self._scales: Dict[str, torch.Tensor] = {}

    def record(self, path: str, x: torch.Tensor) -> None:
        if self.mode == "calib":
            m = torch.amax(torch.abs(x.float()))
            self.amax[path] = torch.maximum(self.amax[path], m) if path in self.amax else m

    def scale(self, path: str) -> torch.Tensor:
        if path not in self._scales:
            self._scales[path] = _amax_scale(self.amax[path])
        return self._scales[path]


def _nchw(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """An NCHW function applied to an NHWC tensor."""
    return fn(x.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)


def _conv_fp(x, kernel, bias, stride: int, pad: int, relu: bool, dtype):
    y = _nchw(lambda t: F.conv2d(t, kernel.to(dtype).float(), stride=stride, padding=pad), x.to(dtype).float())
    y = y + bias
    return torch.clamp_min(y, 0.0).to(dtype) if relu else y.to(dtype)


def _quant_conv_generic(ctx: _Ctx, x, fold: Callable, k: int, stride: int, pad: int, relu: bool, path: str,
                        q_out: bool):
    """One conv site in any mode, given ``fold() -> (OIHW kernel, bias)``;
    the int8 mode reads the site's prepared kernel instead."""
    if ctx.mode in ("fp", "calib"):
        kernel, bias = fold()
        if ctx.collect is not None:
            kq, wscale = quantize_weights_per_channel(kernel)
            ctx.collect[path] = (gemm_weight(kq), wscale, bias.detach())
        ctx.record(f"{path}/in", x)
        y = _conv_fp(x, kernel, bias, stride, pad, relu, ctx.dtype)
        ctx.record(f"{path}/out", y)
        return y
    xq = x if isinstance(x, QTensor) else quantize(x, ctx.scale(f"{path}/in"))
    weight, wscale, bias = ctx.qparams[path]
    out_scale = ctx.scale(f"{path}/out") if q_out else None
    return conv_int8(xq, weight, k, wscale, bias, stride, pad, out_scale=out_scale, relu=relu, out_dtype=ctx.dtype)


def _folded(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """Conv + BN -> (folded kernel, bias); a conv bias goes in through the
    BN's per-channel multiplier."""
    kernel, bias = fold_bn(conv.weight.float(), bn.weight.float(), bn.bias.float(), bn.running_mean.float(),
                           bn.running_var.float(), bn.eps)
    if conv.bias is not None:
        # BN(conv + b) = conv * k' + (inv * b + bias'); inv = k' / k per out-channel
        bn_inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        bias = bias + bn_inv * conv.bias.float()
    return kernel, bias


def _convbn(ctx: _Ctx, x, block, path: str, q_out: bool = True):
    """One ``ConvBN`` (resnet.py). fp/calib: dense in and out. int8: QTensor
    or dense in, QTensor out."""
    k, stride = block.conv.kernel_size[0], block.conv.stride[0]
    return _quant_conv_generic(ctx, x, lambda: _folded(block.conv, block.bn), k, stride, k // 2, block.use_relu,
                               path, q_out)


def _bottleneck(ctx: _Ctx, x, unit, path: str):
    """resnet.py::Bottleneck mirror (1x1 -> 3x3/stride -> 1x1, residual)."""
    y = _convbn(ctx, x, unit.body.conv1, f"{path}/ConvBN_0")
    y = _convbn(ctx, y, unit.body.conv2, f"{path}/ConvBN_1")
    y = _convbn(ctx, y, unit.body.conv3, f"{path}/ConvBN_2")
    identity = x if unit.identity_conv is None else _convbn(ctx, x, unit.identity_conv, f"{path}/ConvBN_3")
    if ctx.mode in ("fp", "calib"):
        out = torch.clamp_min(y + identity, 0.0).to(ctx.dtype)
        ctx.record(f"{path}/out", out)
        return out
    return add_relu_requant(y, identity, ctx.scale(f"{path}/out"))


def _maxpool_3x3s2(x):
    """The init block's max pool. On int8 values directly (max is monotonic,
    the scale passes through), padded with -128 as the JAX package's int8
    ``reduce_window`` is; a float input pads with -inf."""
    if isinstance(x, QTensor):
        v = F.pad(x.values, (0, 0, 1, 1, 1, 1), value=-128)
        return QTensor(torch.amax(v.unfold(1, 3, 2).unfold(2, 3, 2), dim=(-2, -1)), x.scale)
    return _nchw(lambda t: F.max_pool2d(t, 3, stride=2, padding=1), x)


def _as_dense(ctx: _Ctx, x):
    return dequantize(x, ctx.dtype) if isinstance(x, QTensor) else x


def encoder_backbone(encoder, x, ctx: _Ctx) -> List[torch.Tensor]:
    """Stages 0..3 -> the four dense taps (``ResNet50Stages.stages_backbone``)."""
    h = _convbn(ctx, x, encoder["init_block"].conv, "init_block/ConvBN_0")
    h = _maxpool_3x3s2(h)
    taps = [_as_dense(ctx, h)]
    for name, units in _STAGES[:3]:
        for i in range(units):
            h = _bottleneck(ctx, h, encoder[name][i], f"{name}/Bottleneck_{i}")
        taps.append(_as_dense(ctx, h))
    return taps


def encoder_final(encoder, fmap, ctx: _Ctx) -> torch.Tensor:
    """Stage 4 on the fused map (``ResNet50Stages.final_stage``)."""
    name, units = _STAGES[3]
    h = fmap
    for i in range(units):
        h = _bottleneck(ctx, h, encoder[name][i], f"{name}/Bottleneck_{i}")
    return _as_dense(ctx, h)


def _resize_q(x, hw):
    """Nearest resize of a QTensor (same size: as is; 2x down: the strided
    slice of the int8 values) or of a dense tensor. An upsample dequantizes
    to bf16 first, in every dtype, as the JAX mirror does."""
    if not isinstance(x, QTensor):
        return _nchw(resize_nearest, x, hw)
    H, W = x.values.shape[1:3]
    h, w = hw
    if (H, W) == (h, w):
        return x
    if H == 2 * h and W == 2 * w:
        return QTensor(x.values[:, ::2, ::2], x.scale)
    return _nchw(resize_nearest, dequantize(x, torch.bfloat16), hw)


def _fuse_inputs(terms):
    """sum_i w_i * x_i over mixed QTensor / dense terms, in fp32."""
    acc = None
    for wgt, x in terms:
        xf = x.values.float() * x.scale if isinstance(x, QTensor) else x.float()
        acc = wgt * xf if acc is None else acc + wgt * xf
    return acc


def _dsc(ctx: _Ctx, fused, node, path: str):
    """``DepthwiseSeparableConvBlock`` mirror: the depthwise channel scale
    folds into the 1x1 pointwise kernel after BN is folded; one conv site."""

    def fold():
        kernel, bias = _folded(node.pointwise, node.bn)
        return kernel * node.depthwise.weight.float().reshape(1, -1, 1, 1), bias

    return _quant_conv_generic(ctx, fused, fold, 1, 1, 0, True, path, True)


def _lateral(ctx: _Ctx, x, conv, path: str):
    """A plain conv with bias (no BN, no ReLU): BiFPN's p3..p6."""
    k, stride = conv.kernel_size[0], conv.stride[0]
    return _quant_conv_generic(ctx, x, lambda: (conv.weight.float(), conv.bias.float()), k, stride, k // 2, False,
                               path, True)


def bifpn_forward(bifpn, taps, ctx: _Ctx):
    """``BiFPN`` mirror over the encoder taps [c2, c3, c4]."""
    c2, c3, c4 = taps
    p3 = _lateral(ctx, c2, bifpn.p3, "bifpn/p3")
    p4 = _lateral(ctx, c3, bifpn.p4, "bifpn/p4")
    p5 = _lateral(ctx, c4, bifpn.p5, "bifpn/p5")
    p6 = _lateral(ctx, c4, bifpn.p6, "bifpn/p6")
    p7 = _quant_conv_generic(ctx, p6, lambda: _folded(bifpn.p7.conv, bifpn.p7.bn), 3, 2, 1, True, "bifpn/p7", True)

    feats = [p3, p4, p5, p6, p7]
    for li, block in enumerate(bifpn.bifpn):
        w1 = torch.clamp_min(block.w1.float(), 0.0)
        w11 = w1 / torch.sum(w1, dim=0) + block.epsilon
        w2 = torch.clamp_min(block.w2.float(), 0.0)
        w22 = w2 / torch.sum(w2, dim=0) + block.epsilon
        p3_x, p4_x, p5_x, p6_x, p7_x = feats
        pre = f"bifpn/block{li}"

        def hw(t):
            return (t.values if isinstance(t, QTensor) else t).shape[1:3]

        def node(name, fused):
            return _dsc(ctx, fused, getattr(block, name), f"{pre}/{name}")

        p7_td = p7_x
        p6_td = node("p6_td", _fuse_inputs([(w11[0, 0], p6_x), (w11[1, 0], _resize_q(p7_td, hw(p6_x)))]))
        p5_td = node("p5_td", _fuse_inputs([(w11[0, 1], p5_x), (w11[1, 1], _resize_q(p6_td, hw(p5_x)))]))
        p4_td = node("p4_td", _fuse_inputs([(w11[0, 2], p4_x), (w11[1, 2], _resize_q(p5_td, hw(p4_x)))]))
        p3_td = node("p3_td", _fuse_inputs([(w11[0, 3], p3_x), (w11[1, 3], _resize_q(p4_td, hw(p3_x)))]))

        p3_out = p3_td
        p4_out = node("p4_out", _fuse_inputs([(w22[0, 0], p4_x), (w22[1, 0], p4_td),
                                              (w22[2, 0], _resize_q(p3_out, hw(p4_x)))]))
        p5_out = node("p5_out", _fuse_inputs([(w22[0, 1], p5_x), (w22[1, 1], p5_td),
                                              (w22[2, 1], _resize_q(p4_out, hw(p5_x)))]))
        p6_out = node("p6_out", _fuse_inputs([(w22[0, 2], p6_x), (w22[1, 2], p6_td),
                                              (w22[2, 2], _resize_q(p5_out, hw(p6_x)))]))
        p7_out = node("p7_out", _fuse_inputs([(w22[0, 3], p7_x), (w22[1, 3], p7_td),
                                              (w22[2, 3], _resize_q(p6_out, hw(p7_x)))]))
        feats = [p3_out, p4_out, p5_out, p6_out, p7_out]
    return feats


def _fusion_forward(ctx: _Ctx, model, tap, heatmap, p2):
    """``FusionLayer`` mirror: the bilinear heatmap resize and the sigmoid in
    fp32, the concat in ``ctx.dtype``, the 1x1 conv over the (1024 + 68 +
    256)-channel concat as an int8 site with a dense output, and the gate
    ``y * tap`` in ``ctx.dtype``."""
    tap = _as_dense(ctx, tap)
    # align_corners bilinear in fp32 (dad3dnet.resize_bilinear_align_corners
    # without its autocast guard: the mirror runs under none)
    hm = torch.sigmoid(_nchw(lambda t: F.interpolate(t, size=tuple(tap.shape[1:3]), mode="bilinear",
                                                     align_corners=True), heatmap.float()))
    fmap = torch.cat([tap.to(ctx.dtype), hm.to(ctx.dtype), p2.to(ctx.dtype)], dim=-1)
    conv = model.fusion_layer.conv1x1
    y = _quant_conv_generic(ctx, fmap, lambda: (conv.weight.float(), conv.bias.float()), 1, 1, 0, False, "fusion",
                            q_out=False)
    return y * tap


def quantized_forward_impl(model, x: torch.Tensor, ctx: _Ctx) -> Dict[str, torch.Tensor]:
    """The mirror body on an NHWC batch, parameterized by ``ctx``."""
    encoder = model.encoder.model
    taps = encoder_backbone(encoder, x.to(ctx.dtype), ctx)
    pyramid = bifpn_forward(model.bifpn, taps[1:], ctx)
    # the 3x3 heatmap head reads the int8 p3 level directly; dense output
    hk = model.head["heatmap"]
    heatmap = _quant_conv_generic(ctx, pyramid[0], lambda: (hk.weight.float(), hk.bias.float()), 3, 1, 1, False,
                                  "heatmap_head", q_out=False)
    p2 = _as_dense(ctx, pyramid[2])
    fmap = _fusion_forward(ctx, model, taps[-1], heatmap, p2)
    out = encoder_final(encoder, fmap, ctx)
    return model.heads(heatmap.permute(0, 3, 1, 2), out.permute(0, 3, 1, 2))


def check_backbone(backbone: str) -> None:
    """The int8 mirror covers the resnet50 flagship only, as the JAX
    package's does."""
    if backbone != "resnet50":
        raise ValueError(
            f"int8 inference (quant_amax) supports the resnet50 flagship only; got backbone={backbone!r}. "
            "Drop quant_amax or switch the model config to resnet50."
        )


def amax_tensors(amax, device) -> Dict[str, torch.Tensor]:
    """An amax table (a dict of numbers, numpy or torch scalars, or the path
    of its ``.npz``) as 0-d fp32 tensors on ``device``."""
    if isinstance(amax, (str, os.PathLike)):
        amax = load_amax(os.fspath(amax))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in amax.items()}


def quantized_forward(
    model,
    x: torch.Tensor,
    amax: Optional[Dict[str, torch.Tensor]] = None,
    mode: str = "int8",
    dtype: Optional[torch.dtype] = None,
    qparams: Optional[QParams] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Full DAD-3DNet forward with the encoder, BiFPN, heatmap head and
    fusion conv in int8 (or fp / calib) on normalized NHWC images; ``model``
    is the resnet50 ``DAD3DNet`` in eval mode, ``dtype`` the model's by
    default. Returns (outputs, amax): the updated table in calib mode, the
    given one otherwise. The int8 mode reads the folded int8 kernels of
    ``qparams`` (:func:`prepare_int8_params`, which runs here when they are
    not given), and no fp weight of the quantized sites."""
    check_backbone(model.backbone)
    dtype = dtype or model.dtype
    if mode == "int8" and qparams is None:
        qparams = prepare_int8_params(model, dtype, img_size=x.shape[1])
    ctx = _Ctx(mode, amax, dtype, qparams=qparams)
    # no grad-mode switch where it is off already: a traced one costs torch.export a pass
    with (torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()), fp32_exact():
        outputs = quantized_forward_impl(model, x, ctx)
    return outputs, ctx.amax


def _device(model) -> torch.device:
    return next(model.parameters()).device


def prepare_int8_params(model, dtype: Optional[torch.dtype] = None, img_size: int = 256) -> QParams:
    """Fold BN and per-channel-quantize every conv kernel once: {site:
    (int8 ``gemm_weight`` operand, weight scale, fp32 bias)}, to pass as
    ``qparams``."""
    check_backbone(model.backbone)
    dtype = dtype or model.dtype
    ctx = _Ctx("fp", None, dtype)
    ctx.collect = {}
    with torch.no_grad(), fp32_exact():
        quantized_forward_impl(model, torch.zeros((1, img_size, img_size, 3), dtype=dtype, device=_device(model)),
                               ctx)
    return ctx.collect


def calibrate(model, batches, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Run calibration batches (normalized NHWC images, numpy or torch),
    taking the per-site maximum of their amax records."""
    device = _device(model)
    amax: Dict[str, torch.Tensor] = {}
    for x in batches:
        _, cur = quantized_forward(model, torch.as_tensor(x).to(device), mode="calib", dtype=dtype)
        amax = cur if not amax else {k: torch.maximum(amax[k], cur[k]) for k in amax}
    return amax


def save_amax(amax: Dict[str, torch.Tensor], path: str) -> str:
    """Write the table as an ``.npz`` of 0-d float32 arrays (the JAX
    package's format); returns ``path``, suffix or not."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
                       for k, v in amax.items()})
    return path


def load_amax(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}
