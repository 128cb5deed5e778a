"""Device preprocess of full frames: uint8 frame + face box -> normalized
network input, crop, aspect-preserving resize, centre pad and normalize in
one kernel. Port of ``dad3dheads_tpu/ops/preprocess_device.py``.

The host only pastes each frame into one padded uint8 buffer
(:func:`pack_frames_host`). :func:`frame_scalars` turns the frame sizes and
boxes into the per-image table of crop window, resized extents, pads and cv2
mode flags, with the host path's banker's rounding reproduced in integer
arithmetic, so that the returned scales and paddings invert exactly on the
host. :func:`preprocess_frames_device` then runs ``ops.resample``'s kernel on
CUDA tensors, or its plain version on CPU tensors.

The JAX function's ``impl=`` and ``weights=`` options choose between its TPU
lowerings (XLA einsum, Pallas, split or single bf16 weights); they have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .resample import resample_normalize


def pack_frames_host(
    frames: Sequence[np.ndarray],
    bboxes,
    batch_size: int,
    bucket: int = 64,
    planar: bool = False,
    fixed_shape: Optional[Tuple[int, int]] = None,
):
    """Paste a chunk of variable-size uint8 frames into one padded buffer, the
    only host work of the frames path.

    Returns (buf, sizes (B, 2) int32 [h, w], boxes (B, 4) int32) with buf
    (B, Hmax, Wmax, 3) uint8, or channel-planar (B, Hmax, 3*Wmax) with
    ``planar=True`` (the kernel reads either). Hmax and Wmax round the chunk's
    largest frame up to ``bucket``, or are ``fixed_shape`` = (H, W), which
    every frame must fit. Rows past the chunk repeat its last frame."""
    count = len(frames)
    if not 0 < count <= batch_size:
        raise ValueError(f"need 1..{batch_size} frames, got {count}")
    if fixed_shape is not None:
        hmax, wmax = int(fixed_shape[0]), int(fixed_shape[1])
        bad = [f.shape[:2] for f in frames if f.shape[0] > hmax or f.shape[1] > wmax]
        if bad:
            raise ValueError(f"frames {bad} exceed fixed_shape {(hmax, wmax)}")
    else:
        hmax = ((max(f.shape[0] for f in frames) + bucket - 1) // bucket) * bucket
        wmax = ((max(f.shape[1] for f in frames) + bucket - 1) // bucket) * bucket
    if planar:
        buf = np.zeros((batch_size, hmax, 3 * wmax), np.uint8)
    else:
        buf = np.zeros((batch_size, hmax, wmax, 3), np.uint8)
    sizes = np.zeros((batch_size, 2), np.int32)
    boxes = np.zeros((batch_size, 4), np.int32)
    for j, f in enumerate(frames):
        if f.dtype != np.uint8:
            f = np.clip(np.round(f), 0, 255).astype(np.uint8)
        h, w = f.shape[:2]
        if planar:
            for c in range(3):
                buf[j, :h, c * wmax : c * wmax + w] = f[:, :, c]
        else:
            buf[j, :h, :w] = f
        sizes[j] = (h, w)
        boxes[j] = bboxes[j]
    for j in range(count, batch_size):
        buf[j] = buf[count - 1]
        sizes[j] = sizes[count - 1]
        boxes[j] = boxes[count - 1]
    return buf, sizes, boxes


def round_half_even_ratio(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Banker's rounding of the exact rational p/q (int32 tensors): python3's
    round(bh * scale) without a float."""
    n = torch.div(p, q, rounding_mode="floor")
    r = p - n * q
    up = (2 * r > q) | ((2 * r == q) & (n % 2 == 1))
    return n + up.to(torch.int32)


def frame_scalars(
    sizes: torch.Tensor, bboxes: torch.Tensor, img_size: int, mode: str = "longest_max_size"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame sizes (B, 2) [h, w] and boxes (B, 4) [x0, y0, x1, y1] ->
    (scalars (B, 10) int32, scales (B, 2) fp32 [sx, sy], paddings (B, 4)
    int32 [top, bottom, left, right]), on the boxes' device.

    Boxes are clamped to their frames, so a loose box never averages the
    buffer's zero padding into the resample. ``longest_max_size``:
    aspect-preserving resize and centre pad; ``resize``: a plain resize to
    the square. The scalars are [y0, bh, new_h, pad_top, x0, bw, new_w,
    pad_left, use_area, use_exact_area]."""
    bboxes = bboxes.to(torch.int32)
    h = sizes[:, 0].to(torch.int32)
    w = sizes[:, 1].to(torch.int32)
    x0 = torch.minimum(torch.clamp(bboxes[:, 0], min=0), w - 1)
    y0 = torch.minimum(torch.clamp(bboxes[:, 1], min=0), h - 1)
    bw = torch.minimum(torch.maximum(bboxes[:, 2], x0 + 1), w) - x0
    bh = torch.minimum(torch.maximum(bboxes[:, 3], y0 + 1), h) - y0
    B = bboxes.shape[0]

    if mode == "longest_max_size":
        long_side = torch.maximum(bh, bw)
        new_h = round_half_even_ratio(bh * img_size, long_side)
        new_w = round_half_even_ratio(bw * img_size, long_side)
        scale = img_size / long_side.float()
        scales = torch.stack([scale, scale], dim=-1)
        use_area = scale < 1.0
        use_exact_area = use_area  # aspect preserved: both axes shrink
        pad_top = torch.div(img_size - new_h, 2, rounding_mode="floor")
        pad_left = torch.div(img_size - new_w, 2, rounding_mode="floor")
        paddings = torch.stack(
            [pad_top, img_size - new_h - pad_top, pad_left, img_size - new_w - pad_left], dim=-1
        )
    elif mode == "resize":
        new_h = torch.full((B,), img_size, dtype=torch.int32, device=bboxes.device)
        new_w = new_h.clone()
        scales = torch.stack([img_size / bw.float(), img_size / bh.float()], dim=-1)
        use_area = scales.min(dim=-1).values < 1.0
        # cv2 runs the exact area algorithm only when neither axis enlarges;
        # with mixed scales it falls back to the generic 2-tap scheme
        use_exact_area = scales.max(dim=-1).values <= 1.0
        pad_top = torch.zeros((B,), dtype=torch.int32, device=bboxes.device)
        pad_left = pad_top
        paddings = torch.zeros((B, 4), dtype=torch.int32, device=bboxes.device)
    else:
        raise KeyError(f"unknown resize mode {mode!r}")

    scalars = torch.stack(
        [y0, bh, new_h, pad_top, x0, bw, new_w, pad_left,
         use_area.to(torch.int32), use_exact_area.to(torch.int32)],
        dim=-1,
    ).to(torch.int32)
    return scalars.contiguous(), scales, paddings.to(torch.int32)


def preprocess_frames_device(
    frames_u8: torch.Tensor,
    sizes: torch.Tensor,
    bboxes: torch.Tensor,
    img_size: int = 256,
    normalize: str = "imagenet",
    mode: str = "longest_max_size",
    layout: str = "nhwc",
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Preprocess a batch of padded full frames on their device.

    frames_u8: (B, Hmax, Wmax, 3) uint8 (``layout="nhwc"``) or channel-planar
    (B, Hmax, 3*Wmax) (``layout="planar"``); each frame fills the top-left
    (h, w) region. sizes: (B, 2) [h, w]; bboxes: (B, 4) [x0, y0, x1, y1],
    clamped to the frames ([0, 0, w, h] is the whole frame).

    Returns (images (B, S, S, 3) ``out_dtype``, scales (B, 2) fp32 [sx, sy],
    paddings (B, 4) int32 [top, bottom, left, right]), matching the host path
    (``ops.preprocess.preprocess_image_np`` on the cropped frame)."""
    expect_ndim = 3 if layout == "planar" else 4
    if layout not in ("planar", "nhwc") or frames_u8.ndim != expect_ndim:
        raise ValueError(f"layout {layout!r} with frames of shape {tuple(frames_u8.shape)}")
    dev = frames_u8.device
    # a frame never extends past the buffer, so no crop reads outside it (the
    # extents stay symbolic in an exported program)
    hmax, wmax = frames_u8.shape[1], frames_u8.shape[2] // 3 if layout == "planar" else frames_u8.shape[2]
    sizes = sizes.to(device=dev, dtype=torch.int32)
    sizes = torch.stack([torch.clamp(sizes[:, 0], max=hmax), torch.clamp(sizes[:, 1], max=wmax)], dim=-1)
    scalars, scales, paddings = frame_scalars(sizes, bboxes.to(dev), img_size, mode)
    images = resample_normalize(frames_u8.contiguous(), scalars, img_size, normalize, out_dtype)
    return images, scales, paddings
