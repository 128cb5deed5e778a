"""Staged SwinV2 encoder for DAD-3DNet. Follows the official
``models/swin_transformer_v2.py`` of github.com/microsoft/Swin-Transformer
(Liu et al., "Swin Transformer V2", CVPR 2022, arXiv:2111.09883); the
registry's ``swinv2_b_w16`` is ``configs/swinv2/swinv2_base_patch4_window16_256.yaml``:
patch 4, embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32), window 16,
MLP ratio 4, q/v biases, pretrained window 0.

- Patch embedding: a 4x4/4 conv to ``embed_dim`` channels, then a LayerNorm
  (eps 1e-5 throughout).
- A block at an H x W grid takes ``window = min(H, W)`` and no shift where
  ``min(H, W) <= window``; otherwise its odd blocks shift by ``window // 2``
  (a roll by -shift, and -100 between the rolled regions of a window).
  Attention is scaled cosine attention: qkv = x Wqkv + [q_bias, 0, v_bias],
  s = normalize(q) normalize(k)^T exp(min(logit_scale, log 100)) per head,
  plus 16 sigmoid(cpb(T))[index], the continuous relative-position bias of
  an MLP (Linear(2, 512), ReLU, Linear(512, heads, no bias)) over the
  (2w - 1)^2 relative coordinates, each divided by w - 1, times 8, through
  sign(x) log2(|x| + 1) / log2(8); plus the shift mask; softmax; times v;
  the output projection. Res-post-norm: x + LN1(attn(x)), then
  x + LN2(MLP(x)), the MLP Linear(C, 4C), exact GELU, Linear(4C, C).
- Patch merging starts stages 2-4: the 2x2 neighbours x[0::2, 0::2],
  x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] concatenated (4C), a bias-free
  Linear(4C, 2C), LN(2C). As in the official file it is held by the stage
  before (``layers.{s-1}.downsample`` starts stage s + 1).

Departures from the official file: stochastic depth is 0 (a training
recipe's setting); a grid that a stage's window does not divide, or an odd
grid before a merge, raises (there is no padding path); a window of one
token (a 1 x 1 grid) divides its coordinates by 1, not 0.

The staged interface is DAD-3DNet's: ``stages_backbone`` returns the patch
embedding's output and the outputs of stages 1-3 (C, C, 2C, 4C channels at
strides 4, 4, 8, 16), ``final_stage`` merges the fused stride-16 map, runs
stage 4 and the final LayerNorm (8C at stride 32). Tokens live as NHWC
tensors; the taps are their NCHW views, the channels_last tensors the rest
of the network runs on.

Precision: under the bf16 trunk's autocast the linear layers and the
attention's products run in bf16; every LayerNorm, the cosine
normalisation, the logit scale and the relative-position bias (its MLP
included) run in fp32, so the residual stream is fp32; the bias and mask
are rounded to the trunk's type for the attention core,
``F.scaled_dot_product_attention`` with the logit scale folded into q and
``scale=1``. The fp32 trunk runs it all in fp32.

The relative-position index, the coordinate table and the shift masks
depend on the grid alone: non-persistent buffers of each stage, made at the
first forward at a grid (outside any CUDA-graph capture) and moved with the
module. The state dict holds the learned tensors alone, under the official
names (``patch_embed.{proj,norm}``, ``layers.{i}.blocks.{j}.{attn.{qkv,
q_bias,v_bias,logit_scale,cpb_mlp.0,cpb_mlp.2,proj},norm1,mlp.fc1,mlp.fc2,
norm2}``, ``layers.{i}.downsample.{reduction,norm}``, ``norm``).

Under a profiler each stage (its merging, its blocks and, after the last,
the final LayerNorm; the patch embedding, the first tap, is outside) is a
timed span ``dad3d.swin.stage`` (counts ``stage``, ``blocks``, ``tokens`` =
B H W, ``channels``), and each block's
attention core, from its qkv output to the output projection's input, a
timed span ``dad3d.swin.attention`` (counts ``tokens``, ``window_tokens``,
``channels``, ``heads``, ``windows`` a image, ``shift``, ``itemsize`` of
q, k and v). While a CUDA graph captures they are not timed.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..tracing import OFF, span

LN_EPS = 1e-5
LOGIT_SCALE_MAX = math.log(100.0)
LOGIT_SCALE_INIT = math.log(10.0)
CPB_HIDDEN = 512
BIAS_SCALE = 16.0
SHIFT_MASK = -100.0
INIT_STD = 0.02


class SwinSpec(NamedTuple):
    embed_dim: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]
    window: int
    patch: int = 4
    mlp_ratio: int = 4


SWINV2_B_W16 = SwinSpec(embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window=16)


def encoder_channels(spec: SwinSpec) -> Dict[str, int]:
    """DAD-3DNet's channel table (layer0 = deepest) of a SwinV2 encoder."""
    c = spec.embed_dim
    return {"layer0": 8 * c, "layer1": 4 * c, "layer2": 2 * c, "layer3": c, "layer4": c}


def _span(name: str, **counts: int):
    """``tracing.span`` with its device time, except while a CUDA graph
    captures (timing events cannot be recorded there). Off: one flag check."""
    s = span(name, **counts)
    if s is OFF or (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()):
        return s
    return span(name, timed=True, **counts)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm in fp32, whatever the autocast."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def _windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, w * w, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // w) * (W // w), w * w, C)


def _unwindows(x: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`_windows`."""
    x = x.view(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_index(w: int, device) -> torch.Tensor:
    """(w^2 * w^2,) int64: for each pair of a window's tokens, the row of
    their relative offset in the (2w - 1)^2 coordinate table."""
    coords = torch.stack(torch.meshgrid(torch.arange(w, device=device), torch.arange(w, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def coordinate_table(w: int, device) -> torch.Tensor:
    """((2w - 1)^2, 2) fp32: the relative offsets divided by w - 1, times 8,
    log-spaced: sign(x) log2(|x| + 1) / log2(8)."""
    r = torch.arange(-(w - 1), w, dtype=torch.float32, device=device)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)
    table = table / max(w - 1, 1) * 8.0
    return torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8.0)


def shift_mask(H: int, W: int, w: int, s: int, device) -> torch.Tensor:
    """(windows, w^2, w^2) fp32: -100 between tokens of a window that came
    from different regions of the rolled grid, 0 elsewhere."""
    region = torch.zeros(1, H, W, 1, device=device)
    n = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            region[:, hs, ws, :] = n
            n += 1
    ids = _windows(region, w).squeeze(-1)
    return (ids[:, None, :] != ids[:, :, None]).float() * SHIFT_MASK


class Geometry(NamedTuple):
    window: int
    shift: int  # of the stage's odd blocks
    index: torch.Tensor
    table: torch.Tensor
    mask: Optional[torch.Tensor]  # None where the stage's blocks do not shift


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), LOGIT_SCALE_INIT))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(inplace=True),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False))
        self.proj = nn.Linear(dim, dim)

    def position_bias(self, geo: Geometry) -> torch.Tensor:
        """(heads, N, N) fp32: 16 sigmoid(cpb(T))[index]."""
        n = geo.window * geo.window
        with torch.autocast(geo.table.device.type, enabled=False):
            table = self.cpb_mlp(geo.table)
        return BIAS_SCALE * torch.sigmoid(table[geo.index].view(n, n, self.heads).permute(2, 0, 1).contiguous())

    def forward(self, x: torch.Tensor, batch: int, geo: Geometry, shifted: bool) -> torch.Tensor:
        """x: (B * windows, N, C) window tokens -> the same, projected; the
        shift mask applies where ``shifted``."""
        BW, N, C = x.shape
        nW, h = BW // batch, self.heads
        qkv = F.linear(x, self.qkv.weight, torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias]))
        with _span("dad3d.swin.attention", tokens=BW * N, window_tokens=N, channels=C, heads=h, windows=nW,
                   shift=geo.shift if shifted else 0, itemsize=qkv.element_size()):
            # (3, B, windows, heads, N, d); the attention core sees windows x heads as its heads
            qkv = qkv.view(batch, nW, N, 3, h, C // h).permute(3, 0, 1, 4, 2, 5)
            q, k, v = (t.reshape(batch, nW * h, N, C // h).contiguous() for t in qkv)
            scale = torch.clamp(self.logit_scale, max=LOGIT_SCALE_MAX).exp().repeat(nW, 1, 1)
            q = (F.normalize(q.float(), dim=-1) * scale).to(v.dtype)
            k = F.normalize(k.float(), dim=-1).to(v.dtype)
            bias = self.position_bias(geo)
            bias = bias + geo.mask[:, None] if shifted else bias.expand(nW, h, N, N)
            # a mask of unit stride along keys, which the fused attention kernels need
            mask = bias.reshape(1, nW * h, N, N).to(v.dtype).contiguous()
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
            out = out.view(batch, nW, h, N, C // h).transpose(2, 3).reshape(BW, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.attn = WindowAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, geo: Geometry, shifted: bool) -> torch.Tensor:
        """x: (B, H, W, C), the fp32 residual stream."""
        B, H, W, _ = x.shape
        w, s = geo.window, geo.shift
        h = torch.roll(x, (-s, -s), dims=(1, 2)) if shifted else x
        h = _unwindows(self.attn(_windows(h, w), B, geo, shifted), w, B, H, W)
        if shifted:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + _ln(self.norm1, h)
        return x + _ln(self.norm2, self.mlp(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            raise ValueError(f"SwinV2 patch merging needs an even grid, got {H}x{W}")
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return _ln(self.norm, self.reduction(x))


class SwinStage(nn.Module):
    """One stage's blocks, and the merging that starts the next stage."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: int, merge: bool):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, mlp_ratio) for _ in range(depth))
        self.downsample = PatchMerging(dim) if merge else None

    def geometry(self, H: int, W: int, device) -> Geometry:
        """The stage's window, shift and tables at an H x W grid; the tables
        are made at the first call at that grid."""
        clipped = min(H, W) <= self.window
        w, shift = (min(H, W), 0) if clipped else (self.window, self.window // 2)
        if H % w or W % w:
            raise ValueError(f"SwinV2: a {H}x{W} grid is not a whole number of {w}x{w} windows; choose an "
                             f"image size at which every stage's grid is a multiple of its window")
        key = f"{H}x{W}"
        if f"index_{key}" not in self._buffers:
            if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"SwinV2: the tables of a {key} grid must be made before a CUDA graph captures: "
                                   "run one forward at this size first")
            self.register_buffer(f"index_{key}", relative_index(w, device), persistent=False)
            self.register_buffer(f"table_{key}", coordinate_table(w, device), persistent=False)
            if shift:
                self.register_buffer(f"mask_{key}", shift_mask(H, W, w, shift, device), persistent=False)
        return Geometry(w, shift, self._buffers[f"index_{key}"], self._buffers[f"table_{key}"],
                        self._buffers.get(f"mask_{key}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        geo = self.geometry(x.shape[1], x.shape[2], x.device)
        for j, block in enumerate(self.blocks):
            x = block(x, geo, bool(geo.shift and j % 2))
        return x


class SwinV2Stages(nn.Module):
    """The SwinV2 encoder with DAD-3DNet's staged interface (module
    docstring), built from a :class:`SwinSpec` (default: ``swinv2_b_w16``)."""

    def __init__(self, spec: SwinSpec = SWINV2_B_W16):
        super().__init__()
        self.spec = spec
        self.encoder_channels = encoder_channels(spec)
        c = spec.embed_dim
        self.model = nn.Module()
        self.model.patch_embed = nn.Module()
        self.model.patch_embed.proj = nn.Conv2d(3, c, spec.patch, stride=spec.patch)
        self.model.patch_embed.norm = nn.LayerNorm(c, eps=LN_EPS)
        self.model.layers = nn.ModuleList(
            SwinStage(c * 2 ** i, depth, heads, spec.window, spec.mlp_ratio, merge=i < len(spec.depths) - 1)
            for i, (depth, heads) in enumerate(zip(spec.depths, spec.heads)))
        self.model.norm = nn.LayerNorm(c * 2 ** (len(spec.depths) - 1), eps=LN_EPS)

    def _stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``s`` (1-based) on NHWC tokens: the merging that starts it
        (stages 2-4), its blocks (and the final LayerNorm after stage 4)."""
        layers = self.model.layers
        B, H, W, C = x.shape
        if s > 1:
            H, W, C = H // 2, W // 2, 2 * C
        with _span("dad3d.swin.stage", stage=s, blocks=len(layers[s - 1].blocks), tokens=B * H * W, channels=C):
            if s > 1:
                x = layers[s - 2].downsample(x)
            x = layers[s - 1](x)
            return _ln(self.model.norm, x) if s == len(layers) else x

    def stages_backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: NCHW images -> [patch embedding, stage 1, stage 2, stage 3],
        each an NCHW view of NHWC tokens."""
        t = self.model.patch_embed.proj(x).permute(0, 2, 3, 1)
        outs = [_ln(self.model.patch_embed.norm, t)]
        for s in (1, 2, 3):
            outs.append(self._stage(s, outs[-1]))
        return [o.permute(0, 3, 1, 2) for o in outs]

    def final_stage(self, x: torch.Tensor) -> torch.Tensor:
        """The fused stride-16 map (NCHW) -> stage 4 and the final norm (NCHW)."""
        return self._stage(4, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = self.stages_backbone(x)
        outs.append(self.final_stage(outs[-1]))
        return outs

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """SwinV2's published initialisation, drawn from ``generator``: linear
        weights a normal of deviation 0.02 truncated at two deviations, their
        biases zero; LayerNorms the identity, then every block's res-post-norm
        LayerNorms zeroed (``_init_respostnorm``); ``logit_scale`` log 10; q and
        v biases zero; the patch embedding's conv torch's default (weight and
        bias uniform within 1 / sqrt(fan_in))."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, 0.0, INIT_STD, -2 * INIT_STD, 2 * INIT_STD, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, WindowAttention):
                m.q_bias.zero_()
                m.v_bias.zero_()
                m.logit_scale.fill_(LOGIT_SCALE_INIT)
        for m in self.modules():
            if isinstance(m, SwinBlock):
                for norm in (m.norm1, m.norm2):
                    norm.weight.zero_()
                    norm.bias.zero_()

