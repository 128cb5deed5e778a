from .flame import FlameModel, FlameParams, flame_decode
from .head_mesh import HeadMesh
from .landmarks import LandmarkEmbedding, get_68_landmarks
from .lbs import lbs
from .projection import (
    calculate_paddings,
    heatmap_to_keypoints,
    landmarks_img_to_input,
    normalize_to_cube,
    project_vertices_onto_image,
    weak_perspective_project,
)
from .rotation import calculate_rpy, rodrigues, rot_mat_from_6dof

__all__ = [
    "FlameModel",
    "FlameParams",
    "flame_decode",
    "HeadMesh",
    "LandmarkEmbedding",
    "get_68_landmarks",
    "lbs",
    "calculate_paddings",
    "heatmap_to_keypoints",
    "landmarks_img_to_input",
    "normalize_to_cube",
    "project_vertices_onto_image",
    "weak_perspective_project",
    "rodrigues",
    "rot_mat_from_6dof",
    "calculate_rpy",
]
