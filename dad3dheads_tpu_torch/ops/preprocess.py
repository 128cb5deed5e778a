"""Image preprocessing: the uint8 -> normalized fp32 or bf16 kernel and the
host (numpy + cv2) resize/pad, keypoint and readjustment helpers.

Port of ``dad3dheads_tpu/ops/preprocess.py`` and of the normalize kernel of
``dad3dheads_tpu/ops/preprocess_pallas.py``. :func:`normalize_images`
calls the ``torch.library`` custom operator ``dad3d::normalize_u8``: on CUDA
tensors it launches the hand-written kernel of ``csrc/normalize.cu``; on CPU
tensors it runs :func:`normalize_images_reference`, the plain PyTorch
version; its fake implementation gives a trace the output's shape and type.
There is no other dispatch.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..constants import IMAGENET_MEAN, IMAGENET_STD, flame_param_offset

from . import cuda_lib


def normalize_scale_bias(normalize: str = "imagenet") -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel fp32 (scale, bias) with x/255/std - mean/std == x*scale +
    bias, rounded exactly as the Pallas kernel computes them."""
    if normalize == "imagenet":
        std = np.asarray(IMAGENET_STD, np.float32)
        mean = np.asarray(IMAGENET_MEAN, np.float32)
    elif normalize == "mean":
        std = np.full((3,), 0.5, np.float32)
        mean = np.full((3,), 0.5, np.float32)
    elif normalize == "none":
        std = np.ones((3,), np.float32)
        mean = np.zeros((3,), np.float32)
    else:
        raise KeyError(f"unknown normalize mode {normalize!r}")
    scale = np.float32(1.0) / (np.float32(255.0) * std)
    bias = -mean / std
    return scale.astype(np.float32), bias.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _affine_floats(normalize: str) -> Tuple[float, ...]:
    """scale[0..2], bias[0..2] as Python floats (exact fp32 values), the
    kernel's arguments, computed once per mode."""
    scale, bias = normalize_scale_bias(normalize)
    return (*map(float, scale), *map(float, bias))


def check_out_dtype(out_dtype: torch.dtype) -> None:
    """Raise unless ``out_dtype`` is one the preprocess kernels write."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def normalize_images_reference(
    images_u8: torch.Tensor, normalize: str = "imagenet", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, 3) uint8 -> x*scale + bias in fp32,
    then ``.to(out_dtype)`` (float32 or bfloat16)."""
    check_out_dtype(out_dtype)
    scale, bias = normalize_scale_bias(normalize)
    dev = images_u8.device
    out = images_u8.float() * torch.from_numpy(scale).to(dev) + torch.from_numpy(bias).to(dev)
    return out.to(out_dtype)


@torch.library.custom_op("dad3d::normalize_u8", mutates_args=(), device_types="cuda")
def _normalize_op(images_u8: torch.Tensor, normalize: str, out_dtype: torch.dtype) -> torch.Tensor:
    """On CUDA tensors the kernel, which takes a contiguous uint8 NHWC tensor
    and raises on anything else."""
    check_out_dtype(out_dtype)
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"expected uint8 images, got {images_u8.dtype}")
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    B, H, W, _ = images_u8.shape
    bf16 = out_dtype == torch.bfloat16
    out = torch.empty((B, H, W, 3), dtype=out_dtype, device=images_u8.device)
    device, stream = cuda_lib.launch_args(images_u8)
    code = cuda_lib.library().d3d_normalize_u8(
        images_u8.data_ptr(), out.data_ptr(), B, H, W, int(bf16), *_affine_floats(normalize), device, stream,
    )
    cuda_lib.check(code, "d3d_normalize_u8")
    normalize_images.launches += 1
    normalize_images.bf16_launches += bf16
    return out


@_normalize_op.register_kernel("cpu")
def _(images_u8, normalize, out_dtype):
    return normalize_images_reference(images_u8, normalize, out_dtype)


@_normalize_op.register_fake
def _(images_u8, normalize, out_dtype):
    check_out_dtype(out_dtype)
    return images_u8.new_empty(images_u8.shape, dtype=out_dtype)


def normalize_images(
    images_u8: torch.Tensor, normalize: str = "imagenet", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized (B, H, W, 3) ``out_dtype``: float32,
    or bfloat16 (the fp32 value rounded to nearest even, as ``.to`` rounds),
    the bf16 trunk's input.

    Any B, H, W. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which takes a contiguous uint8 NHWC tensor and raises on anything
    else. The NHWC result viewed as ``permute(0, 3, 1, 2)`` is a channels_last
    NCHW tensor, the CNN's input layout, with no copy."""
    if images_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"normalize_images runs on cpu or cuda tensors, got {images_u8.device}")
    check_out_dtype(out_dtype)
    return _normalize_op(images_u8, normalize, out_dtype)


normalize_images.launches = 0  # kernel launches (live or in an exported program); the CPU path does not count
normalize_images.bf16_launches = 0  # those of them with a bf16 output


# ---------------------------------------------------------------------------
# Host helpers (numpy + cv2), for single images of any size
# ---------------------------------------------------------------------------


def py3round(x: float) -> int:
    """Banker's rounding (python3 round), as albumentations rounds targets."""
    return int(round(x))


def longest_max_size_params(h: int, w: int, img_size: int) -> Tuple[float, int, int]:
    """scale, new_h, new_w for an aspect-preserving resize to the longest side."""
    scale = img_size / float(max(h, w))
    return scale, py3round(h * scale), py3round(w * scale)


def pad_offsets(new_h: int, new_w: int, img_size: int) -> List[int]:
    """Center paddings [top, bottom, left, right] to a square img_size."""
    pad_top = (img_size - new_h) // 2
    pad_bottom = img_size - new_h - pad_top
    pad_left = (img_size - new_w) // 2
    pad_right = img_size - new_w - pad_left
    return [pad_top, pad_bottom, pad_left, pad_right]


def preprocess_image_np(
    image: np.ndarray,
    img_size: int = 256,
    normalize: str = "imagenet",
    mode: str = "longest_max_size",
):
    """RGB uint8 (H, W, 3) -> (img_size, img_size, 3) network input.

    ``longest_max_size``: aspect-preserving resize + center square pad,
    returns (tensor, scalar scale, paddings [top, bottom, left, right]).
    ``resize``: plain resize, returns (tensor, [sx, sy], [0, 0, 0, 0]).
    ``normalize="none"`` keeps uint8."""
    import cv2

    h, w = image.shape[:2]
    if mode == "resize":
        scale = np.asarray([img_size / float(w), img_size / float(h)], np.float32)
        if (h, w) != (img_size, img_size):
            interp = cv2.INTER_AREA if float(scale.min()) < 1.0 else cv2.INTER_LINEAR
            image = cv2.resize(image, (img_size, img_size), interpolation=interp)
        pt = pb = pl = pr = 0
    elif mode == "longest_max_size":
        scale, new_h, new_w = longest_max_size_params(h, w, img_size)
        if (new_h, new_w) != (h, w):
            interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR
            image = cv2.resize(image, (new_w, new_h), interpolation=interp)
        pt, pb, pl, pr = pad_offsets(new_h, new_w, img_size)
        image = np.pad(image, ((pt, pb), (pl, pr), (0, 0)), mode="constant")
    else:
        raise KeyError(f"unknown resize mode {mode!r}")

    if normalize == "none":
        return image, scale, [pt, pb, pl, pr]
    x = image.astype(np.float32) / 255.0
    if normalize == "imagenet":
        x = (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    elif normalize == "mean":
        x = (x - 0.5) / 0.5
    return x, scale, [pt, pb, pl, pr]


def transform_keypoints_np(keypoints: np.ndarray, scale, paddings: List[int]) -> np.ndarray:
    """Map crop-space keypoints through the resize and pad: k*scale + (pl, pt)."""
    return keypoints * scale + np.asarray([paddings[2], paddings[0]], np.float32)


def readjust_landmarks_np(landmarks: np.ndarray, paddings: List[int], scale) -> np.ndarray:
    """Network-input landmarks -> original image coordinates, truncated to
    ints as the reference predictor does."""
    out = (landmarks - np.asarray([[paddings[2], paddings[0]]])) / scale
    return out.astype(int)


def readjust_3dmm_np(
    pred_3dmm: np.ndarray,
    paddings: List[int],
    scale,
    img_size: int = 256,
    constants=None,
) -> np.ndarray:
    """Map predicted scale/translation from network space back to the
    original image:
      scale'       = (scale + 1) / s - 1
      translation' = (translation + 1 - 2*[pl, pt, 0]/img) / s - 1
    With a per-axis [sx, sy] scale (resize mode), x/y translation divide per
    axis; z translation and the isotropic FLAME scale use sy."""
    t0 = flame_param_offset("translation", constants)
    s0 = flame_param_offset("scale", constants)
    out = np.array(pred_3dmm, copy=True)
    t = out[:, t0 : t0 + 3]
    sc = out[:, s0 : s0 + 1]
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        t_scale, s_scale = scale, scale
    else:
        t_scale = np.asarray([scale[0], scale[1], scale[1]], np.float32)
        s_scale = scale[1]
    shift = np.asarray([[paddings[2], paddings[0], 0.0]], np.float32) * 2.0 / img_size
    out[:, t0 : t0 + 3] = (t + 1.0 - shift) / t_scale - 1.0
    out[:, s0 : s0 + 1] = (sc + 1.0) / s_scale - 1.0
    return out
