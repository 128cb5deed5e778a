"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs of
a cell's call or step counted on the frozen reference, and each hand-written
kernel's bytes and operations from its launch shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W. A kernel's
bound is the larger of its bytes over the memory bandwidth and its
operations over its unit's peak, counting each input byte read once and each
output byte written once. The blendshape pair runs three TF32 products for
each fp32 product on the tensor cores (3xTF32), so its operations count
three times at the TF32 peak; the normalize kernel is bound by its bytes."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import flame as flame_ref
from .reference import network

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FP32, BF16, U8 = 4, 2, 1


def bound_s(bytes_moved: float, flops: float, peak_flops: float) -> float:
    return max(bytes_moved / PEAK_HBM_BYTES, flops / peak_flops)


def normalize_bound_s(batch: int, size: int, out_bytes: int) -> float:
    """uint8 (B, S, S, 3) read once, the normalized image written once; its
    two operations a value are far under any peak."""
    n = batch * size * size * 3
    return bound_s(n * (U8 + out_bytes), 2.0 * n, PEAK_FP32_FLOPS)


def blend_shapes_bound_s(batch: int, betas: int = 400, n: int = 15069) -> float:
    """betas (B, K) x dirs (K, N) + template (N) -> (B, N), fp32, 3xTF32."""
    moved = FP32 * (batch * betas + betas * n + n + batch * n)
    return bound_s(moved, 3 * 2.0 * batch * betas * n, PEAK_TF32_FLOPS)


def blend_shapes_bwd_bound_s(batch: int, betas: int = 400, n: int = 15069) -> float:
    """g (B, N) and dirs (K, N) -> d_betas (B, K) and d_template (N), 3xTF32
    for the product, the template's column sums beside it."""
    moved = FP32 * (batch * n + betas * n + batch * betas + n)
    return bound_s(moved, 3 * 2.0 * batch * betas * n + batch * n, PEAK_TF32_FLOPS)


def model_flops(model_config: dict, batch: int, size: int, train: bool) -> float:
    """FLOPs of one call (``train`` false: the network's forward and the FLAME
    decode) or one step (forward, decode, losses and backward) at these
    shapes, counted by ``torch.utils.flop_counter`` on the reference run on
    the meta device: matrix products and convolutions, 2 per multiply-add.
    The count is the model's work, whatever implements it."""
    lay = network.layout(model_config["backbone"], model_config["num_filters"], model_config["num_classes"])
    P = {n: torch.empty(s, device="meta", dtype=torch.int64 if k == "count" else torch.float32,
                        requires_grad=train and k not in ("count", "bn_mean", "bn_var"))
         for n, s, k in lay}
    flame = {"v_template": torch.empty(5023, 3, device="meta"), "shapedirs": torch.empty(5023, 3, 400, device="meta"),
             "posedirs": torch.empty(36, 5023 * 3, device="meta"), "j_regressor": torch.empty(5, 5023, device="meta"),
             "lbs_weights": torch.empty(5023, 5, device="meta")}
    images = torch.empty(batch, size, size, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        out = network.forward(P, images, model_config["backbone"], train=train)
        v0, v_rot, proj = flame_ref.decode(flame, out["3dmm"], size)
        if train:
            total = out["heatmap"].sum() + out["landmarks"].sum() + v0.sum() + proj.sum()
            total.backward()
    return float(counter.get_total_flops())


# hand-written kernels: op counter name -> (trace bucket, bound of one launch at a cell's shapes)
KernelBounds = Dict[str, tuple]


def serve_kernels(batch: int, size: int, trunk_bytes: int) -> KernelBounds:
    """One ``predict_batch`` call: the uint8 normalize into the trunk's type,
    one FLAME decode of the batch."""
    return {"normalize_images": ("kernel: normalize_images", normalize_bound_s(batch, size, trunk_bytes)),
            "blend_shapes_fused": ("kernel: blend_shapes_fused", blend_shapes_bound_s(batch))}


def train_kernels(batch: int, size: int) -> KernelBounds:
    """One train step: the uint8 normalize to fp32, the decode and its
    backward."""
    return {"normalize_images": ("kernel: normalize_images", normalize_bound_s(batch, size, FP32)),
            "blend_shapes_fused": ("kernel: blend_shapes_fused", blend_shapes_bound_s(batch)),
            "blend_shapes_fused_backward": ("kernel: blend_shapes_fused_backward", blend_shapes_bwd_bound_s(batch))}
