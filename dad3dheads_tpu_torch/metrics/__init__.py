"""Evaluation metrics: keypoint NME, failure rate, soft IoU. Mirrors
``dad3dheads_tpu/metrics/__init__.py``. Per-batch tensor functions; the
Trainer's ``MetricAccumulator`` averages them over an epoch on the device."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _norm_distance(bbox: Optional[torch.Tensor], batch: int, device) -> torch.Tensor:
    """sqrt(w*h) per sample for 2D, or the constant 2.0 (unit cube) for 3D."""
    if bbox is None:
        return torch.full((batch,), 2.0, dtype=torch.float32, device=device)
    return torch.sqrt(bbox[:, 2] * bbox[:, 3])


def _mean_error(output_kp: torch.Tensor, target_kp: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.linalg.vector_norm(output_kp - target_kp, dim=-1), dim=-1)  # (B,)


def keypoints_nme(
    output_kp: torch.Tensor,
    target_kp: torch.Tensor,
    bbox: Optional[torch.Tensor] = None,
    weight: float = 100.0,
) -> torch.Tensor:
    """Normalized mean error x100 averaged over the batch.

    output_kp/target_kp: (B, K, dim); bbox: (B, 4) [x, y, w, h] or None (3D)."""
    nme = _mean_error(output_kp, target_kp) / _norm_distance(bbox, output_kp.shape[0], output_kp.device)
    return weight * torch.mean(nme)


def failure_rate(
    output_kp: torch.Tensor,
    target_kp: torch.Tensor,
    bbox: Optional[torch.Tensor] = None,
    threshold: float = 0.05,
    below: bool = True,
) -> torch.Tensor:
    """Fraction of samples whose normalized error is below (or beyond) the
    threshold."""
    err = _mean_error(output_kp, target_kp)
    nd = _norm_distance(bbox, output_kp.shape[0], output_kp.device)
    hit = err < threshold * nd if below else err > threshold * nd
    return torch.mean(hit.float())


def soft_iou(output: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Soft IoU between probability heatmaps, NHWC (B, H, W, C), averaged."""

    def op_sum(x):
        return torch.sum(x, dim=(1, 2))

    inter = op_sum(target * output)
    iou = (inter + eps) / (op_sum(target**2) + op_sum(output**2) - inter + eps)
    return torch.mean(iou)


def compute_step_metrics(
    pred_landmarks: torch.Tensor,
    target_landmarks: torch.Tensor,
    pred_heatmap_probs: torch.Tensor,
    target_heatmap: torch.Tensor,
    reprojected_2d_face: torch.Tensor,
    target_full_2d_face: torch.Tensor,
    pred_vertices_norm: torch.Tensor,
    target_vertices_norm: torch.Tensor,
    bbox: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """The metric panel logged per train/val step: 2D landmarks are
    presence-masked pixel coordinates; the reprojection and 3D metrics take
    the 'face' vertex subset; failure rates at 0.05 and 0.1."""
    return {
        "heatmap_iou": soft_iou(pred_heatmap_probs, target_heatmap),
        "nme_2d": keypoints_nme(pred_landmarks, target_landmarks, bbox),
        "fr_2d_005": failure_rate(pred_landmarks, target_landmarks, bbox, 0.05),
        "fr_2d_01": failure_rate(pred_landmarks, target_landmarks, bbox, 0.1),
        "reproject_nme_2d": keypoints_nme(reprojected_2d_face, target_full_2d_face, bbox),
        "reproject_fr_2d_005": failure_rate(reprojected_2d_face, target_full_2d_face, bbox, 0.05),
        "reproject_fr_2d_01": failure_rate(reprojected_2d_face, target_full_2d_face, bbox, 0.1),
        "nme_3d": keypoints_nme(pred_vertices_norm, target_vertices_norm, None),
        "fr_3d_005": failure_rate(pred_vertices_norm, target_vertices_norm, None, 0.05),
        "fr_3d_01": failure_rate(pred_vertices_norm, target_vertices_norm, None, 0.1),
    }


__all__ = ["keypoints_nme", "failure_rate", "soft_iou", "compute_step_metrics"]
