"""PNCC (projected normalized coordinate code) rendering. Mirrors
``dad3dheads_tpu/render/pncc.py``: the predicted mesh is reprojected to image
space, z is flipped, and the face-without-ears triangles are rasterized with
per-vertex NCC colours (the template normalized to the unit cube over that
subset)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import assets
from ..core.head_mesh import HeadMesh
from .rasterizer import rasterize


def compute_ncc_color_codes(
    template_face: np.ndarray, subset_indexes: Optional[np.ndarray] = None
) -> np.ndarray:
    """Normalized coordinate codes: template vertices scaled to [0, 1] per
    axis over the (optional) vertex subset."""
    if template_face.ndim != 2 or template_face.shape[1] != 3:
        raise ValueError(f"template_face must be [N,3], got {template_face.shape}")
    sub = template_face[subset_indexes] if subset_indexes is not None else template_face
    u_min = sub.min(axis=0, keepdims=True)
    u_max = sub.max(axis=0, keepdims=True)
    return (template_face - u_min) / (u_max - u_min)


def pncc(
    img: np.ndarray,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    colors: torch.Tensor,
    with_bg_flag: bool = True,
) -> np.ndarray:
    """Render per-vertex NCC colours, on the vertices' device, over the image
    or over black; returns a uint8 numpy image of the image's shape."""
    bg = torch.from_numpy(np.ascontiguousarray(img))
    if not with_bg_flag:
        bg = torch.zeros_like(bg)
    return rasterize(vertices, faces, colors, bg=bg).cpu().numpy()


class PNCCEstimator:
    def __init__(self, head_mesh: Optional[HeadMesh] = None, device: torch.device | str = "cuda"):
        self.head_mesh = head_mesh if head_mesh is not None else HeadMesh(device=device)
        dev = self.head_mesh.device
        faces = assets.get_flame_indices("faces_wo_ears_remapped").astype(np.int32)
        v_template = self.head_mesh.model.v_template.cpu().numpy()
        colors = compute_ncc_color_codes(v_template, np.unique(faces)).astype(np.float32)
        self.faces_wo_ears = torch.from_numpy(faces).to(dev)
        self.colors = torch.from_numpy(colors).to(dev)

    def __call__(
        self, image: np.ndarray, predictions: Dict[str, Any], with_background: bool = False
    ) -> np.ndarray:
        mm = torch.as_tensor(np.asarray(predictions["3dmm_params"]), dtype=torch.float32)
        verts = self.head_mesh.reprojected_vertices(mm, to_2d=False)[0].clone()
        verts[:, 2] *= -1.0  # z-flip: the raster keeps the largest z as nearest
        return pncc(image, verts, self.faces_wo_ears, self.colors, with_background)
