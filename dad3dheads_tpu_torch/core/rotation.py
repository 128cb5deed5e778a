"""Rotation math: 6DoF Gram-Schmidt rotations and axis-angle (Rodrigues),
batched, fp32. Mirrors ``dad3dheads_tpu/core/rotation.py``."""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm kept away from zero: sqrt(max(sum(v^2), eps^2)), so its
    gradient at v == 0 is zero instead of NaN."""
    sq = torch.sum(v * v, dim=dim, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))


def _normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return v / _safe_norm(v, dim=dim)


def rot_mat_from_6dof(v: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous 6D rotation -> (..., 3, 3) with columns [b1 b2 b3]."""
    if v.shape[-1] != 6:
        raise ValueError(f"expected (..., 6), got {tuple(v.shape)}")
    vx, vy = v[..., :3], v[..., 3:]
    b1 = _normalize(vx)
    b3 = _normalize(torch.linalg.cross(b1, vy, dim=-1))
    b2 = -torch.linalg.cross(b1, b3, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def rotate_vertices(R: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Apply (B, 3, 3) rotations to (B, V, 3) vertices: v' = R v per vertex.

    Written as a broadcast multiply-add rather than a matmul so that it stays
    exact fp32 whatever the process's TF32 matmul setting is."""
    return torch.sum(R[:, None, :, :] * vertices[:, :, None, :], dim=-1)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices."""
    angle = _safe_norm(aa, dim=-1)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return cos * eye + (1.0 - cos) * outer + sin * K
