"""The train and eval steps. Mirrors ``dad3dheads_tpu/train/step.py``: one
step is forward -> LossModule over one shared FLAME decode -> the metric
panel -> (train only) backward, global-norm clipping and an optimizer update
scaled by the linear warmup and the host's LR multiplier.

The FLAME decode runs in fp32 and its blendshape product differentiates
through the hand-written backward kernel on the card. The whole step,
backward included, runs with TF32 off (``precision.fp32_exact``), whatever
the caller's settings: an fp32 model in full fp32, a bf16 model with its
trunk under autocast and its heads, the geometry and the losses in fp32, as
in inference.

With a ``mesh`` under ``torch.distributed`` (``parallel.make_mesh``), the
step is the JAX package's step on a batch sharded over the mesh's data axis:
each rank takes its share of the global batch; every train-mode BatchNorm
computes the global batch's statistics (``parallel.set_sync_bn``, which
whoever builds the distributed model calls once: the ``Trainer`` does); after the
backward the gradients are averaged over the data group
(``parallel.all_reduce_gradients``), so that clipping and the update see the
global batch's gradient; the logs are the global batch's means. Head weights
split over the model group (``parallel.shard_heads``) enter the global norm
with their shards' squares summed. A world of one (or no mesh) runs the
one-process step unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import assets
from ..constants import (
    FLAME_CONSTS,
    INPUT_BBOX_KEY,
    INPUT_IMAGE_KEY,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_3DMM_PARAMS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_FULL_LANDMARKS,
    TARGET_2D_LANDMARKS,
    TARGET_2D_LANDMARKS_PRESENCE,
    TARGET_3D_MODEL_VERTICES,
    TARGET_LANDMARKS_HEATMAP,
)
from ..core.flame import FlameModel
from ..core.projection import heatmap_to_keypoints, normalize_to_cube
from ..losses import LossModule, SharedFlameDecode, shared_flame_decode_raw
from ..metrics import compute_step_metrics
from ..ops.heatmap import encode_heatmap
from ..ops.preprocess import normalize_images
from ..parallel import all_reduce_gradients, all_reduce_mean, data_group, sharded_parameters
from ..precision import fp32_exact
from .schedulers import warmup_factor
from .state import TrainState


def _prepare_targets(
    batch: Dict[str, torch.Tensor],
    img_size: int = 256,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
) -> Dict[str, torch.Tensor]:
    """Device-side input preparation: a batch without a heatmap gets one
    encoded from its normalized 2D landmarks (bit-equal to the host coder);
    a uint8 heatmap becomes fp32 in [0, 1]; uint8 images go through the
    normalize kernel; presence becomes fp32."""
    targets = dict(batch)
    if TARGET_LANDMARKS_HEATMAP not in targets:
        kp = targets[TARGET_2D_LANDMARKS].float() * img_size
        hm = encode_heatmap(kp, targets[TARGET_2D_LANDMARKS_PRESENCE], img_size, heatmap_stride, heatmap_radius)
        targets[TARGET_LANDMARKS_HEATMAP] = hm.permute(0, 2, 3, 1)  # (B, K, S, S) -> NHWC
    hm = targets[TARGET_LANDMARKS_HEATMAP]
    if hm.dtype == torch.uint8:
        targets[TARGET_LANDMARKS_HEATMAP] = hm.float() / 255.0
    if targets[INPUT_IMAGE_KEY].dtype == torch.uint8:
        targets[INPUT_IMAGE_KEY] = normalize_images(targets[INPUT_IMAGE_KEY].contiguous())
    targets[TARGET_2D_LANDMARKS_PRESENCE] = targets[TARGET_2D_LANDMARKS_PRESENCE].float()
    return targets


class _StepCommon:
    """What the train and eval steps share."""

    def __init__(
        self,
        loss_module: Optional[LossModule] = None,
        img_size: int = 256,
        heatmap_stride: int = 4,
        heatmap_radius: int = 5,
    ):
        self.loss_module = loss_module or LossModule()
        self.img_size = img_size
        self.heatmap_stride = heatmap_stride
        self.heatmap_radius = heatmap_radius
        self._face_idx = torch.as_tensor(assets.get_flame_indices("face"), dtype=torch.int64)

    def forward_and_loss(self, state: TrainState, flame: FlameModel, batch, train: bool):
        targets = _prepare_targets(batch, self.img_size, self.heatmap_stride, self.heatmap_radius)
        state.model.train(train)
        outputs = state.model(targets[INPUT_IMAGE_KEY])
        shared = shared_flame_decode_raw(flame, outputs[OUTPUT_3DMM_PARAMS], FLAME_CONSTS, self.img_size)
        total, loss_dict = self.loss_module(outputs, targets, shared, state.epoch)
        return total, outputs, shared, loss_dict, targets

    @torch.no_grad()
    def metrics(self, outputs, targets, shared: SharedFlameDecode) -> Dict[str, torch.Tensor]:
        presence = targets[TARGET_2D_LANDMARKS_PRESENCE][..., None]
        if OUTPUT_2D_LANDMARKS in outputs:
            pred_norm = outputs[OUTPUT_2D_LANDMARKS]
        else:  # heatmap-only variants: the argmax decode
            hm = outputs[OUTPUT_LANDMARKS_HEATMAP]
            pred_norm = heatmap_to_keypoints(hm, self.img_size // hm.shape[1]) / self.img_size
        fi = self._face_idx.to(shared.reprojected_2d.device)
        return compute_step_metrics(
            pred_landmarks=pred_norm * self.img_size * presence,
            target_landmarks=targets[TARGET_2D_LANDMARKS] * presence * self.img_size,
            pred_heatmap_probs=torch.sigmoid(outputs[OUTPUT_LANDMARKS_HEATMAP]),
            target_heatmap=targets[TARGET_LANDMARKS_HEATMAP],
            reprojected_2d_face=shared.reprojected_2d[:, fi],
            target_full_2d_face=targets[TARGET_2D_FULL_LANDMARKS][:, fi],
            pred_vertices_norm=normalize_to_cube(shared.vertices_zero_rot[:, fi]),
            target_vertices_norm=normalize_to_cube(targets[TARGET_3D_MODEL_VERTICES][:, fi]),
            bbox=targets[INPUT_BBOX_KEY].float(),
        )


def _detached(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in logs.items()}


def build_train_step(
    loss_module: Optional[LossModule] = None,
    img_size: int = 256,
    warmup_steps: int = 0,
    with_metrics: bool = True,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
    mesh=None,
) -> Callable:
    """Returns ``train_step(state, flame, batch, lr_mult=1.0) -> logs``,
    which updates ``state`` in place. ``lr_mult`` is the host's multiplier
    (plateau and epoch schedule); the linear warmup comes from
    ``state.step``. Logs are 0-d device tensors: ``loss``, the weighted
    losses, ``metrics/*`` (unless ``with_metrics`` is false, as when timing
    the step alone) and ``grad_norm`` (before clipping). With a distributed
    ``mesh``, ``batch`` is this rank's share of the global batch (module
    docstring)."""
    common = _StepCommon(loss_module, img_size, heatmap_stride, heatmap_radius)
    group = data_group(mesh)
    split_heads = mesh is not None and mesh.shape["model"] > 1

    def train_step(state: TrainState, flame: FlameModel, batch: Dict[str, torch.Tensor], lr_mult: float = 1.0):
        state.optimizer.zero_grad()
        with fp32_exact():
            total, outputs, shared, loss_dict, targets = common.forward_and_loss(state, flame, batch, True)
            total.backward()
        if group is not None:
            all_reduce_gradients(state.optimizer.params, group)
        grad_norm = state.optimizer.step(warmup_factor(state.step, warmup_steps) * float(lr_mult),
                                         sharded_parameters(state.model) if split_heads else None)
        state.step += 1
        logs = {"loss": total, **loss_dict}
        if with_metrics:
            logs.update({f"metrics/{k}": v for k, v in common.metrics(outputs, targets, shared).items()})
        logs["grad_norm"] = grad_norm
        logs = _detached(logs)
        return logs if group is None else all_reduce_mean(logs, group)

    return train_step


def build_eval_step(
    loss_module: Optional[LossModule] = None,
    img_size: int = 256,
    heatmap_stride: int = 4,
    heatmap_radius: int = 5,
    mesh=None,
) -> Callable:
    """Returns ``eval_step(state, flame, batch) -> logs`` (eval mode, no
    gradients); with a distributed ``mesh`` the logs are the global batch's
    means, so that every rank takes the same decisions on them."""
    common = _StepCommon(loss_module, img_size, heatmap_stride, heatmap_radius)
    group = data_group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, flame: FlameModel, batch: Dict[str, torch.Tensor]):
        with fp32_exact():
            total, outputs, shared, loss_dict, targets = common.forward_and_loss(state, flame, batch, False)
        logs = {"loss": total, **loss_dict}
        logs.update({f"metrics/{k}": v for k, v in common.metrics(outputs, targets, shared).items()})
        return logs if group is None else all_reduce_mean(logs, group)

    return eval_step
