"""Projection and normalization shared by the predictor, the losses, the
metrics and the dataset tools. Mirrors ``dad3dheads_tpu/core/projection.py``."""

from __future__ import annotations

from typing import List, Tuple

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


def calculate_paddings(orig_h: int, orig_w: int) -> List[int]:
    """Symmetric square paddings [top, bottom, left, right] (Python ints)."""
    max_side = max(orig_h, orig_w)
    pad_top = int((max_side - orig_h) / 2)
    pad_bottom = max_side - orig_h - pad_top
    pad_left = int((max_side - orig_w) / 2)
    pad_right = max_side - orig_w - pad_left
    return [pad_top, pad_bottom, pad_left, pad_right]


def project_vertices_onto_image(
    vertices_world_homo: torch.Tensor,
    projection_matrix: torch.Tensor,
    height,
    crop_x,
    crop_y,
) -> torch.Tensor:
    """Homogeneous world vertices (N, 4) -> image-plane xy (N, 2) with the
    dataset's y-flip and crop-origin shift, in fp32."""
    v2d_homo = vertices_world_homo.float() @ projection_matrix.float().T
    v2d = v2d_homo[:, :2] / v2d_homo[:, 3:4]
    v2d = torch.stack([v2d[:, 0], torch.as_tensor(height, dtype=v2d.dtype, device=v2d.device) - v2d[:, 1]], dim=-1)
    crop = torch.stack([torch.as_tensor(crop_x), torch.as_tensor(crop_y)]).to(v2d.device, v2d.dtype)
    return v2d - crop


def landmarks_img_to_input(landmarks: torch.Tensor, paddings: Tuple[int, int, int, int], scale: float) -> torch.Tensor:
    """Undo the square pad + resize: network-space landmarks -> original
    image coordinates."""
    offset = torch.tensor([paddings[2], paddings[0]], dtype=landmarks.dtype, device=landmarks.device)
    return (landmarks - offset) / scale
