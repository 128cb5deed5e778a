"""Rotation math: 6DoF Gram-Schmidt rotations, axis-angle (Rodrigues) and
roll/pitch/yaw, batched, fp32. Mirrors ``dad3dheads_tpu/core/rotation.py``."""

from __future__ import annotations

from typing import NamedTuple

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


class RPY(NamedTuple):
    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor


def mat_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) intrinsic xyz Euler angles
    (a, b, c) in radians with R = Rz(c) @ Ry(b) @ Rx(a)."""
    b = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def limit_angle(angle: torch.Tensor, pi: float = 180.0) -> torch.Tensor:
    """Wrap angles in degrees into (-pi, pi]."""
    return angle - 2.0 * pi * torch.round(angle / (2.0 * pi))


def calculate_rpy(rotation_6dof: torch.Tensor) -> RPY:
    """(B, 6) or (6,) 6DoF rotation -> roll, pitch, yaw in degrees, each (B,)."""
    R = rot_mat_from_6dof(torch.atleast_2d(rotation_6dof))
    ang = torch.rad2deg(mat_to_euler_xyz(R.transpose(-1, -2)))
    roll = limit_angle(ang[..., 2])
    pitch = limit_angle(ang[..., 0] - 180.0)
    yaw = limit_angle(ang[..., 1])
    return RPY(roll=roll, pitch=pitch, yaw=yaw)
