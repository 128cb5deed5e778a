"""FaceMeshPredictor: images -> 68 landmarks + FLAME mesh + 3DMM params.
Port of the batch path of ``dad3dheads_tpu/api/predictor.py``.

``predict_batch`` is the main path: uint8 (B, S, S, 3) images go through the
normalize kernel, DAD-3DNet, the landmark/3DMM decode and the FLAME decode
(whose blendshape GEMM is the second kernel), and come back as numpy arrays
with the JAX predictor's keys, shapes and dtypes. ``__call__`` serves one
image of any size through the host resize/pad and readjusts the outputs to
the original image.

Weights come from a JAX-package ``.msgpack`` checkpoint, or, without one, from
a seeded ``torch.Generator`` (random weights, with a warning).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from dad3dheads_tpu.constants import (
    FLAME_CONSTS,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
)

from ..core.flame import FlameModel, FlameParams, flame_decode
from ..core.projection import weak_perspective_project
from ..core.rotation import rot_mat_from_6dof, rotate_vertices
from ..models import create_model
from ..ops.preprocess import (
    normalize_images,
    preprocess_image_np,
    readjust_3dmm_np,
    readjust_landmarks_np,
)
from ..weights import load_checkpoint

logger = logging.getLogger(__name__)

DEFAULT_CONFIG: Dict[str, Any] = {
    "img_size": 256,
    "stride": 4,
    "constants": dict(FLAME_CONSTS),
    "model": {"backbone": "resnet50", "num_filters": 256, "num_classes": 68, "limit_value": 3},
}


def decode_pipeline_outputs(out: Mapping[str, torch.Tensor], stride: int, img_size: int):
    """Model outputs -> {"landmarks" (B, 68, 2), "3dmm" (B, 413)} in the
    network frame: the regression head's normalized landmarks when present,
    else the heatmap argmax times the stride; clipped to [0, img_size]."""
    if OUTPUT_2D_LANDMARKS in out:
        landmarks = out[OUTPUT_2D_LANDMARKS] * float(img_size)
    else:
        heatmap = out[OUTPUT_LANDMARKS_HEATMAP]  # (B, H, W, C)
        B, H, W, C = heatmap.shape
        idx = torch.argmax(torch.sigmoid(heatmap).reshape(B, H * W, C), dim=1)
        landmarks = torch.stack([idx % W, idx // W], dim=-1).float() * stride
    return {
        "landmarks": torch.clamp(landmarks, 0, img_size),
        "3dmm": out[OUTPUT_3DMM_PARAMS],
    }


def decode_3dmm_to_mesh(flame: FlameModel, params_3dmm: torch.Tensor, consts, img_size: int):
    """3DMM params (B, P) -> (vertices_3d (B, V, 3), projected_2d (B, V, 2))."""
    params = FlameParams.from_3dmm(params_3dmm, dict(consts))
    v0 = flame_decode(flame, params, zero_rot=True)
    v = rotate_vertices(rot_mat_from_6dof(params.rotation), v0)
    proj = weak_perspective_project(v, params.scale, params.translation, img_size)
    return v, proj[..., :2]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class FaceMeshPredictor:
    def __init__(
        self,
        config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        flame_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        """``checkpoint_path``: a JAX-package ``.msgpack`` predictor checkpoint;
        None initialises random weights from ``torch.Generator`` seeded with
        ``seed``. ``device``: where the network and the FLAME decode run."""
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        self.device = torch.device(device)
        self._img_size = int(self.config["img_size"])
        self._stride = int(self.config.get("stride", 4))
        self._resize_mode = self.config.get("resize_mode", "longest_max_size")
        self.flame_constants = self.config["constants"]
        self.flame = FlameModel.load(flame_path, device=self.device)

        self.model = create_model(self.config["model"], torch.Generator().manual_seed(seed))
        self.loaded_checkpoint: Optional[str] = None
        if checkpoint_path is not None:
            load_checkpoint(self.model, checkpoint_path)
            self.loaded_checkpoint = checkpoint_path
            logger.info("loaded predictor checkpoint from %s", checkpoint_path)
        else:
            logger.warning("no checkpoint given: using random weights (seed %d)", seed)
        self.model = self.model.to(self.device).eval()

    @torch.inference_mode()
    def _run(self, x: torch.Tensor):
        """Normalized or uint8 NHWC batch on the device -> decoded outputs."""
        if x.dtype == torch.uint8:
            x = normalize_images(x)
        return decode_pipeline_outputs(self.model(x.float()), self._stride, self._img_size)

    @torch.inference_mode()
    def _decode_3dmm(self, params_3dmm: torch.Tensor):
        return decode_3dmm_to_mesh(self.flame, params_3dmm, self.flame_constants, self._img_size)

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """RGB uint8 (H, W, 3) -> prediction dict in original-image coords."""
        tensor, scale, paddings = preprocess_image_np(image, self._img_size, mode=self._resize_mode)
        dev = self._run(torch.from_numpy(np.ascontiguousarray(tensor[None])).to(self.device))
        landmarks = readjust_landmarks_np(_numpy(dev["landmarks"])[0], paddings, scale)
        pred_3dmm = readjust_3dmm_np(
            _numpy(dev["3dmm"]), paddings, scale, self._img_size, self.flame_constants
        )
        vertices_3d, projected = self._decode_3dmm(torch.from_numpy(pred_3dmm).to(self.device))
        return {
            "points": np.reshape(landmarks, (-1, 2)),
            "projected_vertices": _numpy(projected),
            "3d_vertices": _numpy(vertices_3d[0]),
            "3dmm_params": pred_3dmm,
        }

    def predict_batch(self, images: Union[np.ndarray, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Batched prediction on pre-sized square inputs (B, S, S, 3), uint8
        or fp32-normalized. Returns network-frame outputs as numpy arrays:
        points (B, 68, 2), projected_vertices (B, V, 2), 3d_vertices
        (B, V, 3), 3dmm_params (B, 413), all float32."""
        x = torch.as_tensor(images).to(self.device).contiguous()
        dev = self._run(x)
        vertices_3d, projected = self._decode_3dmm(dev["3dmm"])
        return {
            "points": _numpy(dev["landmarks"]),
            "projected_vertices": _numpy(projected),
            "3d_vertices": _numpy(vertices_3d),
            "3dmm_params": _numpy(dev["3dmm"]),
        }
