"""The training losses and the config-driven weighted aggregator. Mirrors
``dad3dheads_tpu/losses/__init__.py``.

The train step decodes FLAME once per step (:class:`SharedFlameDecode`): the
zero-rotation LBS output, its rotation and its weak-perspective projection
are computed a single time and every loss and metric reads them. Losses are
plain tensor functions; an ``epoch_start`` gate multiplies a criterion by 0
until its epoch, as the JAX package's traced ``where`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import assets
from ..constants import (
    OUTPUT_2D_LANDMARKS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
)
from ..core.flame import FlameModel, FlameParams, flame_decode
from ..core.projection import normalize_to_cube, weak_perspective_project
from ..core.rotation import rot_mat_from_6dof, rotate_vertices
from ..metrics import soft_iou

_EPS = 1e-6


# ---------------------------------------------------------------------------
# elementwise criteria: mean over all elements
# ---------------------------------------------------------------------------


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


CRITERIA: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l1": l1,
    "l2": l2,
    "smooth_l1": smooth_l1,
}


# ---------------------------------------------------------------------------
# the shared FLAME decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharedFlameDecode:
    """Everything the geometry losses and metrics need, decoded once.

    vertices_zero_rot: (B, V, 3) LBS output without the global rotation
    vertices_rot:      (B, V, 3) with the 6DoF rotation applied
    reprojected_2d:    (B, V, 2) weak-perspective projection to image pixels
    """

    vertices_zero_rot: torch.Tensor
    vertices_rot: torch.Tensor
    reprojected_2d: torch.Tensor


def shared_flame_decode_raw(
    model: FlameModel, params_3dmm: torch.Tensor, flame_constants: Dict[str, int], image_size: int
) -> SharedFlameDecode:
    params = FlameParams.from_3dmm(params_3dmm, flame_constants)
    v0 = flame_decode(model, params, zero_rot=True)
    v_rot = rotate_vertices(rot_mat_from_6dof(params.rotation.to(v0.dtype)), v0)
    proj = weak_perspective_project(v_rot, params.scale, params.translation, image_size)
    return SharedFlameDecode(vertices_zero_rot=v0, vertices_rot=v_rot, reprojected_2d=proj[..., :2])


# ---------------------------------------------------------------------------
# individual losses
# ---------------------------------------------------------------------------


def iou_loss(pred_heatmap_logits: torch.Tensor, target_heatmap: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU between sigmoid(pred) and target, NHWC (B, H, W, C); the
    same soft IoU as the logged ``heatmap_iou`` metric."""
    return 1.0 - soft_iou(torch.sigmoid(pred_heatmap_logits), target_heatmap, eps=_EPS)


def landmarks_loss_w_visibility(
    pred_landmarks: torch.Tensor,
    pred_presence: torch.Tensor,
    target_landmarks: torch.Tensor,
    target_presence: torch.Tensor,
    criterion: str = "smooth_l1",
) -> torch.Tensor:
    return CRITERIA[criterion](
        pred_landmarks * pred_presence[..., None],
        target_landmarks * target_presence[..., None],
    )


class SubsetWeights(NamedTuple):
    """(weight, vertex-index) pairs for subset-weighted vertex losses."""

    weights: Tuple[float, ...]
    indices: Tuple[Any, ...]  # np.ndarray index arrays

    @classmethod
    def from_config(cls, weights: Dict[str, float]) -> "SubsetWeights":
        return cls(
            weights=tuple(float(w) for w in weights.values()),
            indices=tuple(assets.get_flame_indices(name) for name in weights),
        )


DEFAULT_V3D_SUBSETS = {"head": 0.5, "face_w_ears": 0.75, "face": 1.0}
DEFAULT_REPROJ_SUBSETS = {"face": 0.5, "face_w_ears": 0.5}


def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def vertices_3d_loss(
    pred_vertices_zero_rot: torch.Tensor,
    target_vertices: torch.Tensor,
    subsets: SubsetWeights,
    criterion: str = "l2",
) -> torch.Tensor:
    """Weighted per-subset loss between unit-cube-normalized meshes."""
    crit = CRITERIA[criterion]
    total = 0.0
    for w, idx in zip(subsets.weights, subsets.indices):
        idx = _index(idx, pred_vertices_zero_rot.device)
        total = total + w * crit(
            normalize_to_cube(pred_vertices_zero_rot[:, idx]),
            normalize_to_cube(target_vertices[:, idx]),
        )
    return total


def reprojection_loss(
    reprojected_2d: torch.Tensor,
    target_full_landmarks: torch.Tensor,
    subsets: SubsetWeights,
    criterion: str = "smooth_l1",
) -> torch.Tensor:
    crit = CRITERIA[criterion]
    total = 0.0
    for w, idx in zip(subsets.weights, subsets.indices):
        idx = _index(idx, reprojected_2d.device)
        total = total + w * crit(reprojected_2d[:, idx], target_full_landmarks[:, idx])
    return total


# ---------------------------------------------------------------------------
# LossModule: config-driven aggregation
# ---------------------------------------------------------------------------

DEFAULT_LOSS_CONFIG: List[Dict[str, Any]] = [
    {"name": "heatmap_loss", "kind": "iou", "weight": 1.0, "epoch_start": 0},
    {
        "name": "vertices3d_loss",
        "kind": "vertices_3d",
        "criterion": "l2",
        "weight": 50.0,
        "epoch_start": 0,
        "subset_weights": DEFAULT_V3D_SUBSETS,
    },
    {
        "name": "reprojection_loss",
        "kind": "reprojection",
        "criterion": "smooth_l1",
        "weight": 0.05,
        "epoch_start": 0,
        "subset_weights": DEFAULT_REPROJ_SUBSETS,
    },
    {
        "name": "landmarks_loss",
        "kind": "landmarks_w_visibility",
        "criterion": "smooth_l1",
        "weight": 100.0,
        "epoch_start": 0,
    },
]


class LossModule:
    """Weighted multi-criterion aggregator with a per-criterion epoch gate.

    ``__call__(outputs, targets, shared, epoch)`` returns (total, {name:
    weighted loss}); a criterion whose ``epoch_start`` is later than
    ``epoch`` contributes 0. Reductions: "sum", "mean" (over the active
    criteria only) and "none" (the stacked values)."""

    def __init__(self, criterions: Optional[List[Dict[str, Any]]] = None, reduction: str = "sum"):
        self.config = criterions if criterions is not None else DEFAULT_LOSS_CONFIG
        self.reduction = reduction
        self._subsets = {}
        for c in self.config:
            if c["kind"] in ("vertices_3d", "reprojection"):
                default = DEFAULT_V3D_SUBSETS if c["kind"] == "vertices_3d" else DEFAULT_REPROJ_SUBSETS
                self._subsets[c["name"]] = SubsetWeights.from_config(c.get("subset_weights", default))
        self._on_device: Dict[Tuple[str, str], SubsetWeights] = {}

    def _subsets_on(self, name: str, device: torch.device) -> SubsetWeights:
        """The criterion's subsets with their indices uploaded once per device."""
        key = (name, str(device))
        if key not in self._on_device:
            s = self._subsets[name]
            self._on_device[key] = SubsetWeights(s.weights, tuple(_index(i, device) for i in s.indices))
        return self._on_device[key]

    def gates(self, epoch: int) -> Tuple[float, ...]:
        """Each criterion's gate at ``epoch``: 1.0 from its ``epoch_start``
        on, 0.0 before."""
        return tuple(1.0 if int(epoch) >= c.get("epoch_start", 0) else 0.0 for c in self.config)

    def __call__(
        self,
        outputs: Dict[str, torch.Tensor],
        targets: Dict[str, torch.Tensor],
        shared: SharedFlameDecode,
        epoch: int = 0,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        losses: Dict[str, torch.Tensor] = {}
        gates = self.gates(epoch)
        for c, gate in zip(self.config, gates):
            kind = c["kind"]
            if kind == "iou":
                val = iou_loss(outputs[OUTPUT_LANDMARKS_HEATMAP], targets[TARGET_LANDMARKS_HEATMAP])
            elif kind == "vertices_3d":
                val = vertices_3d_loss(
                    shared.vertices_zero_rot,
                    targets[TARGET_3D_MODEL_VERTICES],
                    self._subsets_on(c["name"], shared.vertices_zero_rot.device),
                    c.get("criterion", "l2"),
                )
            elif kind == "reprojection":
                val = reprojection_loss(
                    shared.reprojected_2d,
                    targets[TARGET_2D_FULL_LANDMARKS],
                    self._subsets_on(c["name"], shared.reprojected_2d.device),
                    c.get("criterion", "smooth_l1"),
                )
            elif kind == "landmarks_w_visibility":
                val = landmarks_loss_w_visibility(
                    outputs[OUTPUT_2D_LANDMARKS],
                    targets[TARGET_2D_LANDMARKS_PRESENCE],
                    targets[TARGET_2D_LANDMARKS],
                    targets[TARGET_2D_LANDMARKS_PRESENCE],
                    c.get("criterion", "smooth_l1"),
                )
            else:
                raise KeyError(kind)
            losses[c["name"]] = val * c.get("weight", 1.0) * gate

        stack = torch.stack(list(losses.values()))
        if self.reduction == "sum":
            total = stack.sum()
        elif self.reduction == "mean":
            # over the active criteria only, as the reference leaves the
            # not-yet-scheduled ones out of its stack
            total = stack.sum() / max(sum(gates), 1.0)
        elif self.reduction == "none":
            total = stack
        else:
            raise ValueError(self.reduction)
        return total, losses


__all__ = [
    "CRITERIA",
    "l1",
    "l2",
    "smooth_l1",
    "iou_loss",
    "landmarks_loss_w_visibility",
    "vertices_3d_loss",
    "reprojection_loss",
    "SubsetWeights",
    "SharedFlameDecode",
    "shared_flame_decode_raw",
    "LossModule",
    "DEFAULT_LOSS_CONFIG",
]
