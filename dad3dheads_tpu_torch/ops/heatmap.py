"""Keypoint heatmap encoding (Gaussian splat) and decoding. Mirrors
``dad3dheads_tpu/ops/heatmap.py``, bit for bit: centres floored then
integer-divided by the stride, a Gaussian of sigma (2r+1)/6 on the integer
offset grid, cut off outside the (2r+1) box and where it underflows fp32's
eps, truncated to uint8 levels. One broadcast over (..., K, S, S) on the
device, so the train step can make its targets itself."""

from __future__ import annotations

import torch


def encode_heatmap(
    keypoints: torch.Tensor,
    presence: torch.Tensor,
    img_size: int = 256,
    stride: int = 4,
    radius: int = 5,
) -> torch.Tensor:
    """Keypoints (..., K, 2) xy in input pixels and presence (..., K) ->
    uint8 heatmaps (..., K, S, S), S = img_size // stride."""
    S = img_size // stride
    centers = torch.div(torch.floor(keypoints).to(torch.int32), stride, rounding_mode="floor").float()
    cx = centers[..., 0][..., None, None]
    cy = centers[..., 1][..., None, None]
    grid = torch.arange(S, dtype=torch.float32, device=keypoints.device)
    xs, ys = grid[None, :], grid[:, None]
    sigma = (2 * radius + 1) / 6.0
    dx = xs - cx
    dy = ys - cy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    inside = (dx.abs() <= radius) & (dy.abs() <= radius)
    g = torch.where(inside & (g >= torch.finfo(torch.float32).eps), g, torch.zeros((), device=g.device))
    g = g * presence[..., None, None].to(g.dtype)
    return torch.floor(g * 255.0).to(torch.uint8)


def decode_heatmap_uint8(heatmap_u8: torch.Tensor) -> torch.Tensor:
    """uint8 heatmap -> float32 in [0, 1] (the training-side dequantize)."""
    return heatmap_u8.float() / 255.0
