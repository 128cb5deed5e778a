"""Crop + resize + normalize of uint8 frames: the device preprocess of the
frames serving path.

Port of ``resample_normalize_pallas`` (``dad3dheads_tpu/ops/preprocess_pallas.py``)
and of the dense resample of ``dad3dheads_tpu/ops/preprocess_device.py``.
:func:`resample_normalize` calls the ``torch.library`` custom operator
``dad3d::resample_normalize_u8``: on CUDA tensors it launches the
hand-written kernel of ``csrc/resample.cu``; on CPU tensors it runs
:func:`resample_normalize_reference`, the plain PyTorch version: per-image
weight matrices from :func:`axis_weights` and two fp32 contractions; its
fake implementation gives a trace the output's shape and type from the
frames' batch, ``img_size`` and ``out_dtype`` alone, so that an exported
program keeps its frame extents symbolic. There is no other dispatch.

The scalar table is (B, 10) int32 [y0, bh, new_h, pad_top, x0, bw, new_w,
pad_left, use_area, use_exact_area] (see ``preprocess_device.frame_scalars``).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .preprocess import check_out_dtype, normalize_scale_bias

NSCALARS = 10
# The kernel keeps each output row's source-row sums, 3 * Wmax floats, in
# shared memory: a band of rows per block within this budget (two rows at
# 1280 wide and one at 1920 timed fastest on the H100) and at most the H100's
# 227 KB for one row.
_SMEM_BUDGET = 40 * 1024
_SMEM_MAX = 232448
_MAX_BAND = 8


def resample_plan(wmax: int) -> tuple[int, int]:
    """(band, shared bytes) of the kernel for frames ``wmax`` pixels wide:
    ``band`` output rows per block, each holding the row sums of a whole
    source row, 3 * wmax fp32. It depends on the buffer's width alone, so it
    covers any crop and scale factor the scalar table can hold; raises when
    one row does not fit."""
    row = 3 * 4 * int(wmax)
    if row > _SMEM_MAX:
        raise ValueError(f"frames {wmax} wide need {row} bytes of shared memory a row; the kernel has {_SMEM_MAX}")
    band = max(1, min(_MAX_BAND, _SMEM_BUDGET // row))
    return band, band * row


def axis_weights(
    src_max: int,
    out_size: int,
    crop_lo: torch.Tensor,
    crop_len: torch.Tensor,
    new_len: torch.Tensor,
    pad_lo: torch.Tensor,
    use_area: torch.Tensor,
    use_exact_area: torch.Tensor,
) -> torch.Tensor:
    """(B, out_size, src_max) fp32 resample matrices for one axis; every
    argument is a (B,) tensor.

    Row y holds the source weights of output pixel y: zero outside the padded
    window; inside, one of cv2's three schemes, chosen per image: exact
    INTER_AREA box overlap (both axes shrink), cv2's generic 2-tap area
    fallback (INTER_AREA with an axis that enlarges), INTER_LINEAR half-pixel
    taps (upscale). The same fp32 arithmetic, in the same order, as
    ``_axis_weights`` of the JAX package."""
    dev = crop_lo.device

    def col(t: torch.Tensor) -> torch.Tensor:
        return t[:, None, None]

    dst = torch.arange(out_size, dtype=torch.int32, device=dev)[None, :, None]
    src_f = torch.arange(src_max, dtype=torch.int32, device=dev)[None, None, :].float()
    r = (dst - col(pad_lo)).float()  # position within the resized crop
    new_len_f = col(new_len).float()
    valid = (r >= 0) & (r < new_len_f)

    crop_lo_f = col(crop_lo).float()
    f = col(crop_len).float() / torch.clamp(new_len_f, min=1.0)
    hi_idx = col(crop_len).float() - 1.0

    def clip(v: torch.Tensor) -> torch.Tensor:
        return torch.minimum(torch.clamp(v, min=0.0), hi_idx)

    # exact INTER_AREA: overlap of source pixel [s, s+1) with the box
    # [lo + r*f, lo + (r+1)*f), normalized by the box length f
    box_lo = crop_lo_f + r * f
    box_hi = box_lo + f
    w_area = torch.clamp(torch.minimum(src_f + 1.0, box_hi) - torch.maximum(src_f, box_lo), min=0.0) / f

    # generic 2-tap area: s0 = floor(r*f); fx = (r+1) - (s0+1)/f; one tap when fx <= 0
    s0 = torch.floor(r * f)
    fx = (r + 1.0) - (s0 + 1.0) / f
    fx = torch.where(fx <= 0.0, torch.zeros_like(fx), fx)
    g0 = crop_lo_f + clip(s0)
    g1 = crop_lo_f + clip(s0 + 1.0)
    w_gen = (1.0 - fx) * (src_f == g0).float() + fx * (src_f == g1).float()

    # INTER_LINEAR: half-pixel source position, two taps, crop-edge clamp
    pos = r * f + 0.5 * f - 0.5
    l0 = torch.floor(pos)
    frac = pos - l0
    t0 = crop_lo_f + clip(l0)
    t1 = crop_lo_f + clip(l0 + 1.0)
    w_lin = (1.0 - frac) * (src_f == t0).float() + frac * (src_f == t1).float()

    w = torch.where(col(use_area), torch.where(col(use_exact_area), w_area, w_gen), w_lin)
    return torch.where(valid, w, torch.zeros_like(w))


def _frame_dims(frames: torch.Tensor) -> tuple[int, int, int, bool]:
    """(B, Hmax, Wmax, planar) of a planar (B, Hmax, 3*Wmax) or NHWC
    (B, Hmax, Wmax, 3) uint8 frame buffer."""
    if frames.ndim == 3:
        B, Hmax, W3 = frames.shape
        if W3 % 3:
            raise ValueError(f"planar frames need a last axis of 3*Wmax, got {tuple(frames.shape)}")
        return B, Hmax, W3 // 3, True
    if frames.ndim == 4 and frames.shape[-1] == 3:
        B, Hmax, Wmax, _ = frames.shape
        return B, Hmax, Wmax, False
    raise ValueError(f"expected (B, Hmax, 3*Wmax) or (B, Hmax, Wmax, 3) frames, got {tuple(frames.shape)}")


def resample_normalize_reference(
    frames: torch.Tensor,
    scalars: torch.Tensor,
    img_size: int = 256,
    normalize: str = "imagenet",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version: dense per-image weight matrices and two fp32
    contractions, then x*scale + bias; (B, S, S, 3) ``out_dtype``."""
    B, Hmax, Wmax, planar = _frame_dims(frames)
    s = scalars.to(device=frames.device, dtype=torch.int32)
    use_area, use_exact = s[:, 8] != 0, s[:, 9] != 0
    wy = axis_weights(Hmax, img_size, s[:, 0], s[:, 1], s[:, 2], s[:, 3], use_area, use_exact)
    wx = axis_weights(Wmax, img_size, s[:, 4], s[:, 5], s[:, 6], s[:, 7], use_area, use_exact)
    x = frames.reshape(B, Hmax, 3, Wmax).permute(0, 1, 3, 2) if planar else frames
    x = x.float()
    out = torch.einsum("byh,bhwc->bywc", wy, x)
    out = torch.einsum("bxw,bywc->byxc", wx, out)
    scale, bias = normalize_scale_bias(normalize)
    out = out * torch.from_numpy(scale).to(out.device) + torch.from_numpy(bias).to(out.device)
    return out.to(out_dtype)


@torch.library.custom_op("dad3d::resample_normalize_u8", mutates_args=(), device_types="cuda")
def _resample_op(
    frames: torch.Tensor, scalars: torch.Tensor, img_size: int, normalize: str, out_dtype: torch.dtype
) -> torch.Tensor:
    """On CUDA tensors the kernel, which takes contiguous tensors on one
    device, frames up to 19,370 pixels wide (:func:`resample_plan`, read off
    the real width here, where it is a number), and raises on anything
    else."""
    B, Hmax, Wmax, planar = _frame_dims(frames)
    if frames.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")
    if scalars.device != frames.device or scalars.dtype != torch.int32 or tuple(scalars.shape) != (B, NSCALARS):
        raise ValueError(
            f"scalars: expected int32 ({B}, {NSCALARS}) on {frames.device}, "
            f"got {scalars.dtype} {tuple(scalars.shape)} on {scalars.device}"
        )
    if not (frames.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("frames and scalars must be contiguous")
    check_out_dtype(out_dtype)
    band, _ = resample_plan(Wmax)
    scale, bias = normalize_scale_bias(normalize)
    S = int(img_size)
    out = torch.empty((B, S, S, 3), dtype=out_dtype, device=frames.device)
    device, stream = cuda_lib.launch_args(frames)
    code = cuda_lib.library().d3d_resample_normalize_u8(
        frames.data_ptr(), scalars.data_ptr(), out.data_ptr(),
        B, Hmax, Wmax, S, int(planar), int(out_dtype == torch.bfloat16), band,
        *(float(v) for v in scale), *(float(v) for v in bias), device, stream,
    )
    cuda_lib.check(code, "d3d_resample_normalize_u8")
    resample_normalize.launches += 1
    return out


@_resample_op.register_kernel("cpu")
def _(frames, scalars, img_size, normalize, out_dtype):
    # the kernel's layout, whatever order the contractions leave
    return resample_normalize_reference(frames, scalars, img_size, normalize, out_dtype).contiguous()


@_resample_op.register_fake
def _(frames, scalars, img_size, normalize, out_dtype):
    check_out_dtype(out_dtype)
    return frames.new_empty((frames.shape[0], img_size, img_size, 3), dtype=out_dtype)


def resample_normalize(
    frames: torch.Tensor,
    scalars: torch.Tensor,
    img_size: int = 256,
    normalize: str = "imagenet",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 frames, channel-planar (B, Hmax, 3*Wmax) or NHWC (B, Hmax, Wmax,
    3), + (B, 10) int32 scalars -> normalized (B, S, S, 3) ``out_dtype``
    (float32 or bfloat16), S = ``img_size``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes contiguous tensors on one device, frames up to 19,370 pixels wide
    (:func:`resample_plan`), and raises on anything else. The scalars must
    describe crops inside each frame (``frame_scalars`` clamps the boxes
    so)."""
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resample_normalize runs on cpu or cuda tensors, got {frames.device}")
    _frame_dims(frames)
    return _resample_op(frames, scalars, int(img_size), normalize, out_dtype)


resample_normalize.launches = 0  # kernel launches (live or in an exported program); the CPU path does not count
