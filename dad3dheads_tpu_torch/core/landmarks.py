"""68-landmark barycentric embedding: 17 pose-dependent contour points
followed by 51 static points. Mirrors ``dad3dheads_tpu/core/landmarks.py``."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import assets

from .rotation import rodrigues


@dataclasses.dataclass
class LandmarkEmbedding:
    """Gather tables with the face indices already resolved to vertex ids."""

    static_vertex_ids: torch.Tensor  # (51, 3) int64
    static_bary: torch.Tensor  # (51, 3) f32
    dynamic_vertex_ids: torch.Tensor  # (79, 17, 3) int64
    dynamic_bary: torch.Tensor  # (79, 17, 3) f32

    @classmethod
    def load(
        cls, faces: Optional[np.ndarray] = None, device: torch.device | str = "cpu"
    ) -> "LandmarkEmbedding":
        emb = assets.load_landmark_embeddings()
        f = np.asarray(faces if faces is not None else assets.get_faces(), np.int64)
        return cls(
            static_vertex_ids=torch.as_tensor(f[emb["static_lmk_face_idx"]], device=device),
            static_bary=torch.as_tensor(emb["static_lmk_b_coords"], dtype=torch.float32, device=device),
            dynamic_vertex_ids=torch.as_tensor(f[emb["dynamic_lmk_face_idx"]], device=device),
            dynamic_bary=torch.as_tensor(emb["dynamic_lmk_b_coords"], dtype=torch.float32, device=device),
        )


def barycentric_points(
    vertices: torch.Tensor, vertex_ids: torch.Tensor, bary: torch.Tensor
) -> torch.Tensor:
    """vertices (B, V, 3), vertex_ids / bary (..., K, 3) -> (B, ..., K, 3)."""
    tri = vertices[:, vertex_ids]  # (B, ..., K, 3 verts, 3 xyz)
    return torch.sum(tri * bary[None, ..., None], dim=-2)


def dynamic_landmark_bin(full_pose: torch.Tensor) -> torch.Tensor:
    """Yaw bin (0..78) of the contour table from a (B, 15) axis-angle pose.

    The chain is [neck(1), global(0)]; yaw = -atan2(-R[2,0],
    sqrt(R[0,0]^2 + R[1,0]^2)) in degrees, clamped at +39, rounded half to
    even; negative yaw maps to bins 40..78 and anything below -39 to 78."""
    B = full_pose.shape[0]
    aa = full_pose.reshape(B, -1, 3)
    rel = torch.matmul(rodrigues(aa[:, 0]), rodrigues(aa[:, 1]))
    sy = torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2)
    y_deg = -torch.atan2(-rel[:, 2, 0], sy) * (180.0 / math.pi)
    y = torch.round(torch.clamp(y_deg, max=39.0)).to(torch.int64)
    neg_vals = torch.where(y < -39, torch.full_like(y, 78), 39 - y)
    return torch.where(y < 0, neg_vals, y)


def get_68_landmarks(
    vertices: torch.Tensor,
    embedding: Optional[LandmarkEmbedding] = None,
    full_pose: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mesh vertices (B, 5023, 3) -> 68 3D landmarks (B, 68, 3).

    ``full_pose`` selects the contour-yaw bin; None means zero pose (bin 0)."""
    if vertices.ndim == 2:
        vertices = vertices[None]
    emb = embedding if embedding is not None else LandmarkEmbedding.load(device=vertices.device)

    static = barycentric_points(vertices, emb.static_vertex_ids, emb.static_bary)

    B = vertices.shape[0]
    if full_pose is None:
        bins = torch.zeros((B,), dtype=torch.int64, device=vertices.device)
    else:
        bins = dynamic_landmark_bin(full_pose)
    dyn_ids = emb.dynamic_vertex_ids[bins]  # (B, 17, 3)
    dyn_bary = emb.dynamic_bary[bins]  # (B, 17, 3)
    batch = torch.arange(B, device=vertices.device)[:, None, None]
    dynamic = torch.sum(vertices[batch, dyn_ids] * dyn_bary[..., None], dim=-2)
    return torch.cat([dynamic, static], dim=1)
