"""DAD-3DNet on a SwinV2 encoder in plain PyTorch, fp32, as functions of a
flat dict of tensors: the frozen yardstick of the SwinV2 cells. It imports
nothing of the program under test.

The encoder follows the official ``models/swin_transformer_v2.py`` of
github.com/microsoft/Swin-Transformer (arXiv:2111.09883), here with the
settings of ``configs/swinv2/swinv2_base_patch4_window16_256.yaml`` given as
the configuration's ``swin`` entry (``embed_dim``, ``depths``, ``num_heads``,
``window_size``, ``patch_size``, ``mlp_ratio``; pretrained window 0):

- a patch_size x patch_size / patch_size conv, then a LayerNorm (eps 1e-5
  throughout);
- stages of blocks; a stage whose grid is no larger than the window takes
  the grid as its window and no shift, otherwise its odd blocks roll the
  grid by -window // 2 and add -100 between tokens of a window from
  different rolled regions;
- a block: qkv = x Wqkv + [q_bias, 0, v_bias]; per head
  (q / |q|) (k / |k|)^T times exp(min(logit_scale, log 100)); plus
  16 sigmoid(cpb_mlp(T))[index], T the (2w - 1)^2 relative offsets divided by
  w - 1, times 8, through sign(x) log2(|x| + 1) / 3, the MLP
  Linear(2, 512), ReLU, Linear(512, heads) without bias; the mask; a
  softmax; times v; the output projection; then x + LN1(that) and
  x + LN2(fc2(GELU(fc1(x)))) (res-post-norm, exact GELU);
- between stages, patch merging: x[0::2, 0::2], x[1::2, 0::2],
  x[0::2, 1::2], x[1::2, 1::2] concatenated, a bias-free linear to twice the
  channels, a LayerNorm;
- after the last stage a LayerNorm.

Under DAD-3DNet the outputs of stages 1-3 are the BiFPN's taps (C, 2C, 4C
channels) and the fused stride-16 map runs the last merging, stage 4 and the
final norm (8C). ``_SwinNet`` overrides only ``encoder_taps`` and
``final_stage`` of ``network._Net``: its BiFPN, fusion and heads are the
frozen ones. Departures from the official file: none in the forward pass
(stochastic depth is a training setting; a 1-token window divides its
coordinates by 1, where the official file would divide by 0).

Matrix products and the softmax are written out (``torch.matmul``,
exponentials over the row maximum); LayerNorm and GELU likewise. ``quant``
is applied to both operands of every convolution and matrix product of the
trunk: the encoder's linear layers, its two attention products and the
position-bias MLP, the BiFPN, heatmap head and fusion.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import network

LN_EPS = 1e-5
CPB_HIDDEN = 512
HEAD_LINEAR = 512
ENC = "encoder.model"


def spec_of(swin: dict) -> tuple:
    """(embed_dim, depths, heads, window, patch, mlp_ratio) of a configuration's ``swin`` entry."""
    return (int(swin["embed_dim"]), tuple(swin["depths"]), tuple(swin["num_heads"]), int(swin["window_size"]),
            int(swin["patch_size"]), int(swin["mlp_ratio"]))


def layout(swin: dict, filters: int = 256, classes: int = 68) -> network.Layout:
    """(name, shape, init kind) of every tensor of the SwinV2 DAD-3DNet.
    Encoder kinds, as the program initialises them: ``trunc02`` (a normal of
    deviation 0.02 truncated at two deviations), ``zeros``, ``uniform_fan_in``
    (uniform within 1 / sqrt(fan_in) of the conv weight of that name),
    ``ln_weight`` (1), ``ln_bias`` (0), ``postnorm_weight`` and
    ``postnorm_bias`` (the zeroed res-post-norm), ``qv_bias`` (0),
    ``logit_scale`` (log 10); the BiFPN, heatmap head, fusion and heads take
    ``network.layout``'s kinds at the SwinV2 taps' widths."""
    c, depths, heads, _, patch, ratio = spec_of(swin)
    out: network.Layout = [(f"{ENC}.patch_embed.proj.weight", (c, 3, patch, patch), "uniform_fan_in"),
                           (f"{ENC}.patch_embed.proj.bias", (c,), "uniform_fan_in"),
                           (f"{ENC}.patch_embed.norm.weight", (c,), "ln_weight"),
                           (f"{ENC}.patch_embed.norm.bias", (c,), "ln_bias")]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        dim = c * 2 ** i
        for j in range(depth):
            p = f"{ENC}.layers.{i}.blocks.{j}"
            out += [(f"{p}.attn.qkv.weight", (3 * dim, dim), "trunc02"),
                    (f"{p}.attn.q_bias", (dim,), "qv_bias"), (f"{p}.attn.v_bias", (dim,), "qv_bias"),
                    (f"{p}.attn.logit_scale", (h, 1, 1), "logit_scale"),
                    (f"{p}.attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2), "trunc02"),
                    (f"{p}.attn.cpb_mlp.0.bias", (CPB_HIDDEN,), "zeros"),
                    (f"{p}.attn.cpb_mlp.2.weight", (h, CPB_HIDDEN), "trunc02"),
                    (f"{p}.attn.proj.weight", (dim, dim), "trunc02"), (f"{p}.attn.proj.bias", (dim,), "zeros"),
                    (f"{p}.norm1.weight", (dim,), "postnorm_weight"), (f"{p}.norm1.bias", (dim,), "postnorm_bias"),
                    (f"{p}.mlp.fc1.weight", (ratio * dim, dim), "trunc02"), (f"{p}.mlp.fc1.bias", (ratio * dim,), "zeros"),
                    (f"{p}.mlp.fc2.weight", (dim, ratio * dim), "trunc02"), (f"{p}.mlp.fc2.bias", (dim,), "zeros"),
                    (f"{p}.norm2.weight", (dim,), "postnorm_weight"), (f"{p}.norm2.bias", (dim,), "postnorm_bias")]
        if i < len(depths) - 1:
            p = f"{ENC}.layers.{i}.downsample"
            out += [(f"{p}.reduction.weight", (2 * dim, 4 * dim), "trunc02"),
                    (f"{p}.norm.weight", (2 * dim,), "ln_weight"), (f"{p}.norm.bias", (2 * dim,), "ln_bias")]
    final = c * 2 ** (len(depths) - 1)
    out += [(f"{ENC}.norm.weight", (final,), "ln_weight"), (f"{ENC}.norm.bias", (final,), "ln_bias")]

    c2, c3, c4 = c, 2 * c, 4 * c
    for name, cin in (("p3", c2), ("p4", c3), ("p5", c4)):
        network._conv(out, f"bifpn.{name}", cin, filters, 1, True)
    network._conv(out, "bifpn.p6", c4, filters, 3, True)
    network._conv(out, "bifpn.p7.conv", filters, filters, 3, True)
    network._bn(out, "bifpn.p7.bn", filters)
    for k in range(2):
        out += [(f"bifpn.bifpn.{k}.w1", (2, 4), "ones"), (f"bifpn.bifpn.{k}.w2", (3, 4), "ones")]
        for node in network.BIFPN_NODES:
            p = f"bifpn.bifpn.{k}.{node}"
            out.append((f"{p}.depthwise.weight", (filters, 1, 1, 1), "lecun"))
            network._conv(out, f"{p}.pointwise", filters, filters, 1, False)
            network._bn(out, f"{p}.bn", filters)
    network._conv(out, "head.heatmap", filters, classes, 3, True)
    network._conv(out, "fusion_layer.conv1x1", c4 + classes + filters, c4, 1, True)
    for head, n in network.HEADS:
        out += [(f"{head}.logit_image.0.weight", (HEAD_LINEAR, final), "lecun"),
                (f"{head}.logit_image.0.bias", (HEAD_LINEAR,), "zeros"),
                (f"{head}.logit_image.3.weight", (n, HEAD_LINEAR), "lecun"), (f"{head}.logit_image.3.bias", (n,), "zeros")]
    return out


def windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * (H / w) * (W / w), w * w, C), row-major windows."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def unwindows(x: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    x = x.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_tables(w: int, device):
    """The (2w - 1)^2 x 2 log-spaced coordinate table and the w^2 x w^2
    index into it, as the official file builds them."""
    r = torch.arange(-(w - 1), w, dtype=torch.float32, device=device)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij")).permute(1, 2, 0).reshape(-1, 2)
    table = table / max(w - 1, 1) * 8
    table = torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / math.log2(8)
    coords = torch.stack(torch.meshgrid(torch.arange(w, device=device), torch.arange(w, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    index = (rel[:, :, 0] + w - 1) * (2 * w - 1) + rel[:, :, 1] + w - 1
    return table, index.reshape(-1)


def shift_mask(H: int, W: int, w: int, s: int, device) -> torch.Tensor:
    img = torch.zeros(1, H, W, 1, device=device)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    m = windows(img, w).reshape(-1, w * w)
    diff = m.unsqueeze(1) - m.unsqueeze(2)
    return torch.where(diff != 0, torch.full_like(diff, -100.0), torch.zeros_like(diff))


def softmax(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class _SwinNet(network._Net):
    """``network._Net`` with the SwinV2 encoder in place of the CNN's."""

    def __init__(self, P: network.Tensors, swin: dict, quant: network.Quant = None):
        super().__init__(P, False, quant)
        self.embed, self.depths, self.heads, self.window, self.patch, _ = spec_of(swin)

    def matmul(self, a, b):
        if self.quant is not None:
            a, b = self.quant(a), self.quant(b)
        return torch.matmul(a, b)

    def linear(self, x, prefix):
        y = self.matmul(x, self.P[f"{prefix}.weight"].t())
        b = self.P.get(f"{prefix}.bias")
        return y if b is None else y + b

    def layer_norm(self, x, prefix):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.P[f"{prefix}.weight"] + self.P[f"{prefix}.bias"]

    def attention(self, x, p, heads, w, mask):
        P = self.P
        B_, N, C = x.shape
        bias = torch.cat([P[f"{p}.q_bias"], torch.zeros_like(P[f"{p}.v_bias"]), P[f"{p}.v_bias"]])
        qkv = (self.linear(x, f"{p}.qkv") + bias).reshape(B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        attn = self.matmul(q, k.transpose(-2, -1))
        attn = attn * torch.exp(torch.clamp(P[f"{p}.logit_scale"], max=math.log(1.0 / 0.01)))
        table, index = relative_tables(w, x.device)
        t = F.relu(self.linear(table, f"{p}.cpb_mlp.0"))
        t = self.linear(t, f"{p}.cpb_mlp.2")
        attn = attn + (16 * torch.sigmoid(t[index].reshape(N, N, heads).permute(2, 0, 1))).unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, heads, N, N) + mask.unsqueeze(1).unsqueeze(0)).reshape(B_, heads, N, N)
        out = self.matmul(softmax(attn), v).transpose(1, 2).reshape(B_, N, C)
        return self.linear(out, f"{p}.proj")

    def stage(self, x, i):
        """Stage i (0-based) on (B, H, W, C) tokens."""
        B, H, W, C = x.shape
        w, s = (min(H, W), 0) if min(H, W) <= self.window else (self.window, self.window // 2)
        mask = shift_mask(H, W, w, s, x.device) if s else None
        for j in range(self.depths[i]):
            p = f"{ENC}.layers.{i}.blocks.{j}"
            shift = s if j % 2 else 0
            h = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
            h = unwindows(self.attention(windows(h, w), f"{p}.attn", self.heads[i], w, mask if shift else None),
                          w, B, H, W)
            if shift:
                h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
            x = x + self.layer_norm(h, f"{p}.norm1")
            x = x + self.layer_norm(self.linear(gelu(self.linear(x, f"{p}.mlp.fc1")), f"{p}.mlp.fc2"), f"{p}.norm2")
        return x

    def merge(self, x, i):
        """The patch merging held by stage i (0-based), which starts stage i + 1."""
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        p = f"{ENC}.layers.{i}.downsample"
        return self.layer_norm(self.linear(x, f"{p}.reduction"), f"{p}.norm")

    def encoder_taps(self, x, backbone):
        t = self.conv(x, f"{ENC}.patch_embed.proj", self.patch).permute(0, 2, 3, 1)
        t = self.layer_norm(t, f"{ENC}.patch_embed.norm")
        taps = []
        for i in range(3):
            if i > 0:
                t = self.merge(t, i - 1)
            t = self.stage(t, i)
            taps.append(t.permute(0, 3, 1, 2))
        return taps

    def final_stage(self, x, backbone):
        t = self.stage(self.merge(x.permute(0, 2, 3, 1), 2), 3)
        return self.layer_norm(t, f"{ENC}.norm").permute(0, 3, 1, 2)


def forward(P: network.Tensors, images: torch.Tensor, swin: dict, quant: network.Quant = None) -> Dict[str, torch.Tensor]:
    """Normalised NHWC fp32 images -> {"heatmap", "3dmm", "landmarks"}, as
    ``network.forward`` in eval mode."""
    return _SwinNet(P, swin, quant).forward(images, "swinv2")
