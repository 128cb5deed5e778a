"""Projection and normalization shared by the predictor, the losses and the
metrics. Mirrors ``dad3dheads_tpu/core/projection.py``."""

from __future__ import annotations

import torch


def normalize_to_cube(v: torch.Tensor) -> torch.Tensor:
    """Mesh vertices into the unit cube, anchored as the reference does:
    shift the per-axis min to 0, centre by half the per-axis max, divide by
    the largest coordinate. Accepts (V, 3) or (B, V, 3); returns (B, V, 3)."""
    if v.ndim == 2:
        v = v[None]
    v = v - torch.amin(v, dim=1, keepdim=True)
    v = v - 0.5 * torch.amax(v, dim=1, keepdim=True)
    return v / torch.amax(v, dim=(1, 2), keepdim=True)


def weak_perspective_project(
    vertices: torch.Tensor,
    scale_param: torch.Tensor,
    translation: torch.Tensor,
    image_size,
) -> torch.Tensor:
    """Rotated FLAME vertices (B, V, 3) + 3DMM scale (B, 1) / translation
    (B, 3) -> pixel coordinates (B, V, 3); slice [..., :2] for 2D.

    scale = clip(scale_param + 1, 1e-8), translation with its z zeroed,
    (v * s + t + 1) / 2 * image_size."""
    scale = torch.clamp(scale_param[:, None] + 1.0, min=1e-8)
    t = translation.clone()
    t[..., 2] = 0.0
    return (vertices * scale + t[:, None] + 1.0) / 2.0 * image_size


def heatmap_to_keypoints(heatmap_nhwc: torch.Tensor, stride: int = 4) -> torch.Tensor:
    """Per-channel argmax of a (B, H, W, C) heatmap -> (B, C, 2) xy pixel
    coordinates at input resolution (times the stride)."""
    B, H, W, C = heatmap_nhwc.shape
    idx = torch.argmax(heatmap_nhwc.reshape(B, H * W, C), dim=1)  # (B, C)
    return torch.stack([idx % W, idx // W], dim=-1).float() * float(stride)
