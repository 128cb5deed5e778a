"""Training visualization: pred-vs-GT image panels for TensorBoard. The
port's own copy of ``dad3dheads_tpu/train/visualization.py`` (numpy and cv2):
predicted and target landmarks drawn over the de-normalized input images,
and heatmap overlays, each tiled into a grid, logged every
``images_log_freq`` steps by ``Trainer.log_image_panels``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INPUT_IMAGE_KEY,
    OUTPUT_2D_LANDMARKS,
    OUTPUT_LANDMARKS_HEATMAP,
    TARGET_2D_LANDMARKS,
)

PRED_COLOR = (0, 255, 0)
GT_COLOR = (255, 0, 0)


def denormalize_image(x: np.ndarray, normalize: str = "imagenet") -> np.ndarray:
    """fp32 normalized (H, W, 3) -> uint8 RGB."""
    if normalize == "imagenet":
        x = x * np.asarray(IMAGENET_STD, np.float32) + np.asarray(IMAGENET_MEAN, np.float32)
    elif normalize == "mean":
        x = x * 0.5 + 0.5
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def draw_keypoints_panel(
    image: np.ndarray,
    pred_landmarks: Optional[np.ndarray] = None,
    gt_landmarks: Optional[np.ndarray] = None,
    radius: int = 2,
) -> np.ndarray:
    import cv2

    img = np.ascontiguousarray(image)
    if not img.flags.writeable:  # cv2 draws in place
        img = img.copy()
    if gt_landmarks is not None:
        for pt in gt_landmarks.astype(int):
            cv2.circle(img, (int(pt[0]), int(pt[1])), radius, GT_COLOR, -1)
    if pred_landmarks is not None:
        for pt in pred_landmarks.astype(int):
            cv2.circle(img, (int(pt[0]), int(pt[1])), radius, PRED_COLOR, -1)
    return img


def make_grid(images: np.ndarray, cols: int = 4) -> np.ndarray:
    """(N, H, W, 3) -> one tiled (rows*H, cols*W, 3) grid image."""
    n, h, w, c = images.shape
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = images[i]
    return grid


def _as_uint8(img: np.ndarray, normalize: str) -> np.ndarray:
    """Batches may carry uint8 images (device-side normalization path)."""
    return img if img.dtype == np.uint8 else denormalize_image(img, normalize)


def heatmap_overlay(
    image: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Blend the max-over-channels heatmap (red) onto a uint8 RGB image.

    An overlay on the input makes mislocalized peaks visible at a
    glance."""
    hm = heatmap.astype(np.float32)
    if hm.ndim == 3:  # (H, W, C) -> max over keypoint channels
        hm = hm.max(axis=-1)
    peak = hm.max()
    if peak > 0:
        hm = hm / peak
    import cv2

    hm = cv2.resize(hm, (image.shape[1], image.shape[0]))
    out = image.astype(np.float32)
    out[..., 0] = out[..., 0] * (1.0 - alpha * hm) + 255.0 * alpha * hm
    out[..., 1] *= 1.0 - alpha * hm
    out[..., 2] *= 1.0 - alpha * hm
    return np.clip(out, 0, 255).astype(np.uint8)


def heatmap_panel_from_batch(
    batch: Dict[str, np.ndarray],
    outputs: Dict[str, np.ndarray],
    max_images: int = 8,
    normalize: str = "imagenet",
) -> np.ndarray:
    """Grid of input images with the predicted heatmap (sigmoid, max over
    channels) blended in red."""
    imgs = np.asarray(batch[INPUT_IMAGE_KEY])[:max_images]
    logits = np.asarray(outputs[OUTPUT_LANDMARKS_HEATMAP])[:max_images]
    if logits.dtype == np.uint8:
        # the max-probability map scaled by 255, computed on the device
        # (Trainer.log_image_panels copies this, not the 68-channel logits)
        probs = logits.astype(np.float32) / 255.0
    else:
        probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
    panels = []
    for i in range(len(imgs)):
        panels.append(heatmap_overlay(_as_uint8(imgs[i], normalize), probs[i]))
    return make_grid(np.stack(panels))


def landmarks_panel_from_batch(
    batch: Dict[str, np.ndarray],
    outputs: Dict[str, np.ndarray],
    img_size: int = 256,
    max_images: int = 8,
    normalize: str = "imagenet",
) -> np.ndarray:
    """Grid of de-normalized inputs with GT (red) and predicted (green)
    landmarks drawn over them."""
    imgs = np.asarray(batch[INPUT_IMAGE_KEY])[:max_images]
    gt = np.asarray(batch[TARGET_2D_LANDMARKS])[:max_images] * img_size
    pred = np.asarray(outputs[OUTPUT_2D_LANDMARKS])[:max_images] * img_size
    panels = []
    for i in range(len(imgs)):
        img = _as_uint8(imgs[i], normalize)
        panels.append(draw_keypoints_panel(img, pred[i], gt[i]))
    return make_grid(np.stack(panels))
