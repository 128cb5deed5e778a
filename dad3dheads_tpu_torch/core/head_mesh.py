"""HeadMesh: packed 3DMM vector -> 3D vertices / reprojected vertices.
Mirrors ``dad3dheads_tpu/core/head_mesh.py``, over the port's
``flame_decode`` (whose blendshape GEMM is the hand-written kernel) and
``weak_perspective_project``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..constants import FLAME_3DMM_ORDER, FLAME_CONSTS
from .flame import FlameModel, FlameParams, flame_decode
from .projection import weak_perspective_project


class HeadMesh:
    def __init__(
        self,
        flame_config: Optional[Dict[str, int]] = None,
        image_size: int = 256,
        model: Optional[FlameModel] = None,
        flame_path: Optional[str] = None,
        device: torch.device | str = "cuda",
    ):
        """``model``: a loaded FlameModel (its device is used); otherwise the
        FLAME arrays are loaded from ``flame_path`` onto ``device``."""
        self.flame_constants = dict(flame_config or FLAME_CONSTS)
        self.model = model if model is not None else FlameModel.load(flame_path, device=device)
        self.device = self.model.v_template.device
        self.image_size = image_size

    def flame_params(self, params_3dmm: torch.Tensor) -> FlameParams:
        return FlameParams.from_3dmm(params_3dmm, self.flame_constants)

    @torch.inference_mode()
    def vertices_3d(self, params_3dmm: torch.Tensor, zero_rotation: bool = False) -> torch.Tensor:
        """(B, 413) -> (B, V, 3) mesh vertices in model space."""
        params = self.flame_params(params_3dmm.to(self.device))
        return flame_decode(self.model, params, zero_rot=zero_rotation)

    @torch.inference_mode()
    def reprojected_vertices(self, params_3dmm: torch.Tensor, to_2d: bool = True) -> torch.Tensor:
        """(B, 413) -> (B, V, 2|3) vertices projected to image pixels with the
        weak-perspective model: v' = clamp(scale+1) * v + [tx, ty, 0], then
        [-1, 1] -> [0, image_size]."""
        params = self.flame_params(params_3dmm.to(self.device))
        vertices = flame_decode(self.model, params, zero_rot=False)
        projected = weak_perspective_project(vertices, params.scale, params.translation, self.image_size)
        return projected[..., :2] if to_2d else projected

    def adjust_3dmm_to_paddings(self, params_3dmm: torch.Tensor, paddings: Sequence[int]) -> torch.Tensor:
        """Shift the translation for [top, bottom, left, right] paddings
        (positive = image enlarged, negative = cropped)."""
        params = self.flame_params(params_3dmm)
        shift = (
            torch.tensor([[paddings[2], paddings[0], 0.0]], dtype=params_3dmm.dtype, device=params_3dmm.device)
            * 2.0
            / self.image_size
        )
        params = dataclasses.replace(params, translation=params.translation + shift)
        return torch.cat([getattr(params, key) for key in FLAME_3DMM_ORDER], dim=-1)
