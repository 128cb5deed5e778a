"""Synthetic self-consistent training batches. Mirrors
``dad3dheads_tpu/data/synthetic.py``: random FLAME parameters are decoded,
projected, embedded into 68 landmarks and splatted into heatmaps by the
port's own geometry, so a run on them is an end-to-end learnability check
that needs no dataset.

The random part (:func:`random_3dmm` and the noise image) draws from a
``torch.Generator``; :func:`synthetic_targets` is the deterministic rest, so
that a test can feed it the same 3DMM vector and image as the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..constants import (
    INPUT_BBOX_KEY,
    INPUT_IMAGE_KEY,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
    flame_param_offset,
    total_3dmm_size,
)
from ..core.flame import FlameModel, FlameParams, flame_decode
from ..core.landmarks import LandmarkEmbedding, get_68_landmarks
from ..core.projection import weak_perspective_project
from ..core.rotation import rot_mat_from_6dof, rotate_vertices
from ..ops.heatmap import encode_heatmap


def random_3dmm(generator: torch.Generator, batch: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Plausible random packed 3DMM vectors (B, 413): N(0, 0.1) everywhere,
    the 6DoF rotation near the identity, translation N(0, 0.1) and the
    weak-perspective scale parameter around 4 (clipped to [2.5, 6]), so the
    head spans most of the image, as real face crops do."""
    o_rot, o_tr, o_sc = (flame_param_offset(k) for k in ("rotation", "translation", "scale"))

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    x = normal(batch, total_3dmm_size()) * 0.1
    x[:, o_rot : o_rot + 6] = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=device) + normal(batch, 6) * 0.1
    x[:, o_tr : o_tr + 3] = normal(batch, 3) * 0.1
    x[:, o_sc : o_sc + 1] = torch.clamp(4.0 + normal(batch, 1) * 0.7, 2.5, 6.0)
    return x


@torch.no_grad()
def synthetic_targets(
    params_3dmm: torch.Tensor,
    image: torch.Tensor,
    flame: FlameModel,
    embedding: LandmarkEmbedding,
    img_size: int = 256,
    stride: int = 4,
) -> Dict[str, torch.Tensor]:
    """The deterministic part: packed 3DMM (B, 413) and images (B, S, S, 3)
    -> one batch keyed with the standard schema (uint8 NHWC heatmaps, bool
    presence, landmarks normalized by the image size)."""
    params = FlameParams.from_3dmm(params_3dmm)
    v0 = flame_decode(flame, params, zero_rot=True)
    v_rot = rotate_vertices(rot_mat_from_6dof(params.rotation), v0)
    proj = weak_perspective_project(v_rot, params.scale, params.translation, img_size)

    lms_2d = get_68_landmarks(proj, embedding)[..., :2]
    presence = (lms_2d > 0).all(-1) & (lms_2d < img_size).all(-1)
    heatmap = encode_heatmap(lms_2d, presence, img_size, stride).permute(0, 2, 3, 1)
    B = params_3dmm.shape[0]
    return {
        INPUT_IMAGE_KEY: image,
        INPUT_BBOX_KEY: torch.tensor([[0.0, 0.0, float(img_size), float(img_size)]], device=image.device).expand(B, 4),
        TARGET_3D_MODEL_VERTICES: v0,
        TARGET_2D_FULL_LANDMARKS: proj[..., :2],
        TARGET_2D_LANDMARKS: lms_2d / img_size,
        TARGET_2D_LANDMARKS_PRESENCE: presence,
        TARGET_LANDMARKS_HEATMAP: heatmap.contiguous(),
    }


def synthetic_batch(
    generator: torch.Generator,
    flame: FlameModel,
    embedding: LandmarkEmbedding,
    batch: int,
    img_size: int = 256,
    stride: int = 4,
) -> Dict[str, torch.Tensor]:
    """One self-consistent batch on the generator's device: random 3DMM,
    N(0, 1) images, and their targets."""
    device = generator.device
    params_3dmm = random_3dmm(generator, batch, device)
    image = torch.randn((batch, img_size, img_size, 3), generator=generator, device=device)
    return synthetic_targets(params_3dmm, image, flame, embedding, img_size, stride)
