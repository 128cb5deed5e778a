"""UV texture extraction: sample the source image at the projected mesh points
of each texel of a UV map. Mirrors ``dad3dheads_tpu/render/uv_texture.py``.

Every texel of a (res x res) UV map holds a (triangle id, barycentric
weights) pair; the texel's image point is that triangle's projected corners
mixed by the weights, and the image is sampled bilinearly there. The table
comes from a FLAME texture-space asset given by ``uv_data_path`` or
``DAD3D_UV_DATA_PATH``, in one of three forms:

  * an ``.npz`` with a precomputed table: ``tri_id`` (res, res) int32
    [-1 = empty] and ``bary`` (res, res, 3);
  * an ``.npz`` with the raw UV layout: ``vt`` (Vt, 2) texture coordinates in
    [0, 1] (OBJ convention, v up) and ``ft`` (F, 3) per-face texture-vertex
    indices, row-aligned with the mesh faces; the table is then built by
    rasterizing the UV-space triangles;
  * a FLAME template ``.obj`` with ``vt`` / ``f v/vt`` records.

Without one, a spherical unwrap of the template stands in. The tables are
rasterized on the creator's device (the rasterizer kernel on CUDA).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import assets
from ..core.head_mesh import HeadMesh
from .rasterizer import rasterize_buffers


def _rasterize_table(uv_verts: np.ndarray, faces: np.ndarray, resolution: int, device):
    _, tri_id, bary = rasterize_buffers(
        torch.from_numpy(uv_verts).to(device),
        torch.from_numpy(np.asarray(faces, np.int32)).to(device),
        resolution,
        resolution,
    )
    return tri_id.cpu().numpy(), bary.cpu().numpy()


def uv_embedding_from_layout(
    vt: np.ndarray, ft: np.ndarray, resolution: int = 256, device: torch.device | str = "cuda"
):
    """Per-texel (triangle, barycentric) table from a FLAME UV layout.

    ``vt`` are texture coordinates in [0, 1] (v grows upward), ``ft`` indexes
    ``vt`` per face corner, row-aligned with the mesh faces, so the triangle
    ids index the mesh ``faces``. UV charts do not overlap, so depth is a
    constant and the z-buffer reduces to coverage."""
    vt = np.asarray(vt, np.float32)
    u = vt[:, 0] * (resolution - 1)
    v = (1.0 - vt[:, 1]) * (resolution - 1)  # OBJ v-up -> image row-down
    uv_verts = np.stack([u, v, np.ones_like(u)], axis=1).astype(np.float32)
    return _rasterize_table(uv_verts, ft, resolution, device)


def parse_obj_uv_layout(path: str):
    """(vt, ft) from an OBJ file with ``vt`` and ``f v/vt`` records, or None
    when it carries no texture coordinates. Faces must be triangles, so that
    the table stays row-aligned with the mesh faces."""
    vts, fts = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "vt":
                vts.append((float(parts[1]), float(parts[2])))
            elif parts[0] == "f":
                if len(parts) != 4:
                    raise ValueError(
                        f"{path}: only triangular faces are supported for the "
                        f"UV layout (got a {len(parts) - 1}-gon); triangulate "
                        "the OBJ first"
                    )
                corner_ts = []
                for corner in parts[1:4]:
                    fields = corner.split("/")
                    if len(fields) < 2 or not fields[1]:
                        return None
                    corner_ts.append(int(fields[1]) - 1)  # OBJ is 1-indexed
                fts.append(corner_ts)
    if not vts or not fts:
        return None
    return np.asarray(vts, np.float32), np.asarray(fts, np.int64)


def spherical_uv_vertices(v_template: np.ndarray, resolution: int = 256) -> np.ndarray:
    """Texel-space (u, v, radius) fp32 vertices of a spherical unwrap of the
    template: azimuth to u, elevation to v, the nearest surface wins."""
    c = v_template - v_template.mean(0, keepdims=True)
    r = np.linalg.norm(c, axis=1) + 1e-12
    theta = np.arctan2(c[:, 0], c[:, 2] + 1e-12)  # azimuth
    phi = np.arcsin(np.clip(c[:, 1] / r, -1, 1))  # elevation
    u = (theta / np.pi + 1.0) / 2.0 * (resolution - 1)
    v = (phi / (np.pi / 2) + 1.0) / 2.0 * (resolution - 1)
    return np.stack([u, v, r], axis=1).astype(np.float32)


def spherical_uv_embedding(
    v_template: np.ndarray, faces: np.ndarray, resolution: int = 256, device: torch.device | str = "cuda"
):
    """Fallback per-texel (triangle, barycentric) table from a spherical
    unwrap of the template mesh (front hemisphere)."""
    return _rasterize_table(spherical_uv_vertices(v_template, resolution), faces, resolution, device)


def _check_rows(path: str, n_rows: int, n_faces: int) -> None:
    if n_rows != n_faces:
        raise ValueError(
            f"{path}: UV face table has {n_rows} rows but the mesh has {n_faces} "
            "faces; the layout must be row-aligned with the FLAME topology"
        )


class UVTextureCreator:
    def __init__(
        self,
        resolution: int = 256,
        head_mesh: Optional[HeadMesh] = None,
        uv_data_path: Optional[str] = None,
        device: torch.device | str = "cuda",
    ):
        self.resolution = resolution
        self.head_mesh = head_mesh if head_mesh is not None else HeadMesh(device=device)
        dev = self.head_mesh.device
        self.faces = assets.get_faces().astype(np.int32)

        uv_data_path = uv_data_path or os.environ.get("DAD3D_UV_DATA_PATH")
        if uv_data_path and os.path.isfile(uv_data_path):
            if uv_data_path.endswith(".obj"):
                layout = parse_obj_uv_layout(uv_data_path)
                if layout is None:
                    raise ValueError(
                        f"{uv_data_path} carries no per-corner texture "
                        "coordinates (vt / f v/vt records)"
                    )
                vt, ft = layout
                _check_rows(uv_data_path, len(ft), len(self.faces))
                self.tri_id, self.bary = uv_embedding_from_layout(vt, ft, resolution, dev)
            else:
                with np.load(uv_data_path) as z:
                    if "tri_id" in z:
                        self.tri_id, self.bary = z["tri_id"], z["bary"]
                        self.resolution = self.tri_id.shape[0]
                    else:
                        _check_rows(uv_data_path, len(z["ft"]), len(self.faces))
                        self.tri_id, self.bary = uv_embedding_from_layout(z["vt"], z["ft"], resolution, dev)
        else:
            v_template = self.head_mesh.model.v_template.cpu().numpy()
            self.tri_id, self.bary = spherical_uv_embedding(v_template, self.faces, resolution, dev)

    def _compute_texture_map(self, image: np.ndarray, projected: np.ndarray) -> np.ndarray:
        """Bilinear-sample the image at the barycentric-interpolated projected
        points of each covered texel."""
        h, w = image.shape[:2]
        covered = self.tri_id >= 0
        safe_tri = np.maximum(self.tri_id, 0)
        corners = projected[self.faces[safe_tri]]  # (R, R, 3, 2)
        pts = np.sum(corners * self.bary[..., None], axis=-2)  # (R, R, 2)

        x = np.clip(pts[..., 0], 0, w - 1.001)
        y = np.clip(pts[..., 1], 0, h - 1.001)
        x0, y0 = x.astype(np.int32), y.astype(np.int32)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
        img = image.astype(np.float32)
        tex = (
            img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy
        )
        tex[~covered] = 0
        return tex.astype(np.uint8)

    def __call__(self, image: np.ndarray, predictions: Dict[str, Any]) -> np.ndarray:
        mm = torch.as_tensor(np.asarray(predictions["3dmm_params"]), dtype=torch.float32)
        projected = self.head_mesh.reprojected_vertices(mm, to_2d=True)[0].cpu().numpy()
        # from the network's image_size frame to this image's frame
        scale = max(image.shape[:2]) / float(self.head_mesh.image_size)
        return self._compute_texture_map(image, projected * scale)
