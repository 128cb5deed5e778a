"""Projection used by the predictor. Mirrors ``dad3dheads_tpu/core/projection.py``."""

from __future__ import annotations

import torch


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
