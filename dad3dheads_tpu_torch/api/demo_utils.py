"""Demo processors and savers: the 10 output types of the demo CLI. Mirrors
``dad3dheads_tpu/api/demo_utils.py``.

Processors map (predictions, image) to a drawable or serializable result;
savers write ImageSaver (.png), MeshSaver (.obj, 1-indexed faces) and
JsonSaver (.json). cv2 is imported only where an image is drawn or written.
The two renderers run on ``device`` (the rasterizer kernel on CUDA).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import assets
from ..constants import FLAME_3DMM_ORDER, FLAME_CONSTS, flame_param_offset

POINT_COLOR = (255, 0, 0)
EDGE_COLOR = (39, 48, 218)
OPACITY = 0.6


def _cv2():
    import cv2

    return cv2


def draw_points(image: np.ndarray, points: np.ndarray) -> np.ndarray:
    radius = max(1, int(min(image.shape[:2]) * 0.005))
    cv2 = _cv2()
    for pt in np.asarray(points).astype(int):
        cv2.circle(image, (int(pt[0]), int(pt[1])), radius, POINT_COLOR, -1)
    return image


def draw_landmarks(predictions: Dict[str, Any], image: np.ndarray) -> np.ndarray:
    """68 2D landmarks as dots."""
    return draw_points(image, predictions["points"])


def draw_3d_landmarks(predictions: Dict[str, Any], image: np.ndarray, subset: str = "191") -> np.ndarray:
    """191- or 445-vertex keypoint subsets of the projected mesh."""
    if subset not in ("191", "445"):
        raise ValueError("subset must be '191' or '445'")
    idx = assets.load_keypoint_subset(f"keypoints_{subset}", exclude_cheeks=False)
    projected = np.asarray(predictions["projected_vertices"]).squeeze().astype(int)
    return draw_points(image, projected[idx])


def draw_mesh(predictions: Dict[str, Any], image: np.ndarray, subset: str = "head") -> np.ndarray:
    """Wireframe of the head/face mesh edges over the image."""
    if subset not in ("head", "face"):
        raise ValueError("subset must be 'head' or 'face'")
    cv2 = _cv2()
    mesh_vis = image.copy()
    output = image.copy()
    projected = np.asarray(predictions["projected_vertices"]).squeeze().astype(int)
    edges = assets.get_flame_indices(f"{subset}_edges")
    for pt1, pt2 in edges:
        cv2.line(mesh_vis, tuple(projected[pt1]), tuple(projected[pt2]), EDGE_COLOR, 1, cv2.LINE_AA)
    cv2.addWeighted(mesh_vis, OPACITY, output, 1 - OPACITY, 0, output)
    return mesh_vis


def draw_pose(predictions: Dict[str, Any], image: np.ndarray) -> np.ndarray:
    """Roll/pitch/yaw axis triad from the predicted 6DoF rotation."""
    from ..core.rotation import calculate_rpy

    cv2 = _cv2()
    off = flame_param_offset("rotation")
    rot6 = np.asarray(predictions["3dmm_params"], np.float32)[:, off : off + 6]
    rpy = calculate_rpy(torch.from_numpy(np.ascontiguousarray(rot6)))
    roll = np.radians(float(rpy.roll[0]))
    pitch = np.radians(float(rpy.pitch[0]))
    yaw = -np.radians(float(rpy.yaw[0]))  # screen yaw is mirrored

    # Display rotation M = Rx(pitch) @ Ry(yaw) @ Rz(roll); each arrow endpoint
    # is the screen (x, y) projection of a rotated basis vector, i.e. the
    # columns of M's first two rows.
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    M = rot_x @ rot_y @ rot_z

    center = np.array([image.shape[1] // 2, image.shape[0] // 2])
    size = image.shape[0] // 10
    endpoints = (size * M[:2, :]).T + center  # rows: x-, y-, z-axis tips

    thickness = max(1, int(image.shape[0] * 0.005))
    axis_colors = ((0, 0, 255), (0, 255, 0), (255, 0, 0))
    for (ex, ey), color in zip(endpoints, axis_colors):
        cv2.arrowedLine(image, tuple(center), (int(ex), int(ey)), color, thickness)
    return image


def get_pncc(predictions: Dict[str, Any], image: np.ndarray, device: torch.device | str = "cuda") -> np.ndarray:
    from ..render.pncc import PNCCEstimator

    return PNCCEstimator(device=device)(image, predictions)


def get_uv_texture(predictions: Dict[str, Any], image: np.ndarray, device: torch.device | str = "cuda") -> np.ndarray:
    from ..render.uv_texture import UVTextureCreator

    return UVTextureCreator(device=device)(image, predictions)


def get_mesh(predictions: Dict[str, Any], *args: Any) -> Tuple[np.ndarray, np.ndarray]:
    vertices = np.asarray(predictions["3d_vertices"])
    faces = assets.get_faces().astype(np.int64) + 1  # .obj is 1-indexed
    return vertices, faces


def get_flame_params(predictions: Dict[str, Any], *args: Any) -> Dict[str, List[float]]:
    mm = np.asarray(predictions["3dmm_params"])
    out: Dict[str, List[float]] = {}
    idx = 0
    for key in FLAME_3DMM_ORDER:
        size = FLAME_CONSTS.get(key, 0)
        out[key] = mm[0, idx : idx + size].tolist()
        idx += size
    return out


# -- savers ----------------------------------------------------------------


class ImageSaver:
    extension = ".png"

    def __call__(self, image: np.ndarray, output_path: str) -> None:
        cv2 = _cv2()
        cv2.imwrite(output_path, cv2.cvtColor(image, cv2.COLOR_BGR2RGB))


class MeshSaver:
    extension = ".obj"

    def __call__(self, mesh: Tuple[np.ndarray, np.ndarray], output_path: str) -> None:
        vertices, faces = mesh
        with open(output_path, "w") as f:
            for v in vertices:
                f.write("v %.8f %.8f %.8f\n" % tuple(v))
            for face in faces:
                f.write("f %d %d %d\n" % tuple(face))


class JsonSaver:
    extension = ".json"

    def __call__(self, flame_params: Dict[str, List[float]], output_path: str) -> None:
        with open(output_path, "w") as f:
            json.dump(flame_params, f)


def get_output_path(input_image_path: str, outputs_folder: str, type_of_output: str, extension: str) -> str:
    name = os.path.splitext(os.path.split(input_image_path)[1])[0]
    return os.path.join(outputs_folder, f"{name}_{type_of_output}{extension}")
