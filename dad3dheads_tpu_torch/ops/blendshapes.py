"""Fused FLAME blendshapes: v_shaped = betas @ shapedirs + v_template, and
its gradient.

Port of ``dad3dheads_tpu/ops/blendshapes.py`` (the Pallas forward and its
custom VJP). :func:`blend_shapes_fused` is differentiable: a
``torch.autograd.Function`` whose forward is :func:`blend_shapes_fused_forward`
and whose backward is :func:`blend_shapes_fused_backward`. On CUDA tensors
each launches its hand-written kernel (``csrc/blendshapes.cu``: a GEMM on the
tensor cores to fp32 accuracy (3xTF32, ``csrc/tf32x3.cuh``) with the template
add fused; ``csrc/blendshapes_bwd.cu``: a deterministic 3xTF32 split-K GEMM
for d_betas with d_template from the same read of the gradient, and an fp32
tiled GEMM for d_shapedirs); on CPU tensors each runs its plain PyTorch
version. There is no other dispatch.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_lib

# the d_betas kernel of csrc/blendshapes_bwd.cu
_BWD_TILE_ROWS = 64  # rows of g per output tile
_BWD_TILE_COLS = 80  # rows of dirs per output tile
_BWD_STEP = 32  # contraction step: a split-K chunk is a multiple of it
_BWD_BLOCKS_PER_SM = 2  # its shared-memory ring fits twice in an SM
_BWD_TMPL_ROWS = 4  # d_template partials per tile of g (one per warp)


def blend_shapes_fused_reference(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: betas (B, L) @ shapedirs (L, V*3) + template
    (V, 3) -> (B, V, 3), in the dtype of shapedirs (fp32 in the port)."""
    B, V = betas.shape[0], v_template.shape[0]
    out = torch.matmul(betas.to(shapedirs_flat.dtype), shapedirs_flat) + v_template.reshape(1, -1)
    return out.reshape(B, V, 3)


def blend_shapes_fused_backward_reference(
    g: torch.Tensor,
    betas: torch.Tensor,
    shapedirs_flat: torch.Tensor,
    needs: Sequence[bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward: g (B, N) -> (d_betas (B, L),
    d_shapedirs (L, N), d_template (N,)), each None where ``needs`` says so."""
    d_betas = torch.matmul(g, shapedirs_flat.T) if needs[0] else None
    d_dirs = torch.matmul(betas.T, g) if needs[1] else None
    d_tmpl = g.sum(0) if needs[2] else None
    return d_betas, d_dirs, d_tmpl


def _check(tensors, device: torch.device, row_strided: Sequence[str] = ()) -> None:
    """Device, dtype and shape of each (name, tensor, shape); contiguity,
    except that a matrix named in ``row_strided`` may have its rows further
    apart than its width (a view of a padded buffer)."""
    for name, t, shape in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if name in row_strided:
            if t.stride(1) != 1 or _row_stride(t) < t.shape[1]:
                raise ValueError(f"{name} must have unit column stride and rows at least {t.shape[1]} apart")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _row_stride(t: torch.Tensor) -> int:
    """Elements between the rows of a matrix (its width when it has one row)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def blend_shapes_fused_forward(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """The forward alone, (B, L) x (L, V*3) + (V, 3) -> (B, V, 3).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes fp32 tensors on one device, contiguous except that the rows of
    shapedirs_flat may lie further apart (FlameModel pads them to 16-byte
    alignment), and raises on anything else."""
    if betas.device.type == "cpu":
        return blend_shapes_fused_reference(betas, shapedirs_flat, v_template)
    if betas.device.type != "cuda":
        raise ValueError(f"blend_shapes_fused runs on cpu or cuda tensors, got {betas.device}")
    B, L = betas.shape
    V = v_template.shape[0]
    N = V * 3
    _check(
        (("betas", betas, (B, L)), ("shapedirs_flat", shapedirs_flat, (L, N)), ("v_template", v_template, (V, 3))),
        betas.device,
        row_strided=("shapedirs_flat",),
    )
    out = torch.empty((B, N), dtype=torch.float32, device=betas.device)
    device, stream = cuda_lib.launch_args(betas)
    code = cuda_lib.library().d3d_blend_shapes_f32(
        betas.data_ptr(), shapedirs_flat.data_ptr(), v_template.data_ptr(), out.data_ptr(),
        B, L, N, _row_stride(shapedirs_flat), device, stream,
    )
    cuda_lib.check(code, "d3d_blend_shapes_f32")
    blend_shapes_fused.launches += 1
    return out.reshape(B, V, 3)


def split_k_chunk(B: int, L: int, N: int, sms: int) -> int:
    """Length of N that one split-K block of the backward covers: as few and
    long chunks as keep every one of the card's ``sms`` SMs busy (the grid
    within one wave of two blocks per SM), a multiple of the kernel's step."""
    tiles = -(-L // _BWD_TILE_COLS) * -(-B // _BWD_TILE_ROWS)
    chunks = max(1, _BWD_BLOCKS_PER_SM * sms // tiles)
    per_chunk = -(-N // chunks)
    return -(-per_chunk // _BWD_STEP) * _BWD_STEP


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def blend_shapes_fused_backward(
    g: torch.Tensor,
    betas: torch.Tensor,
    shapedirs_flat: torch.Tensor,
    needs: Sequence[bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gradients of betas @ shapedirs + template given g = dL/dout (B, N):
    (d_betas (B, L), d_shapedirs (L, N), d_template (N,)), each None where
    ``needs`` says so.

    CPU tensors take the plain version. CUDA tensors launch the kernel (fp32,
    contiguous but for the row strides of g and shapedirs_flat), which
    computes d_betas and d_template in every launch and d_shapedirs only when
    it is asked for; fixed summation order, so the same inputs give the same
    bits."""
    if g.device.type == "cpu":
        return blend_shapes_fused_backward_reference(g, betas, shapedirs_flat, needs)
    if g.device.type != "cuda":
        raise ValueError(f"blend_shapes_fused runs on cpu or cuda tensors, got {g.device}")
    B, N = g.shape
    L = shapedirs_flat.shape[0]
    _check(
        (("g", g, (B, N)), ("betas", betas, (B, L)), ("shapedirs_flat", shapedirs_flat, (L, N))),
        g.device,
        row_strided=("g", "shapedirs_flat"),
    )
    device, stream = cuda_lib.launch_args(g)
    chunk = split_k_chunk(B, L, N, _sm_count(device))
    chunks = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=g.device)
    partial = torch.empty((chunks, B, L), **f32)
    tmpl_partial = torch.empty((_BWD_TMPL_ROWS * -(-B // _BWD_TILE_ROWS), N), **f32)
    d_betas = torch.empty((B, L), **f32)
    d_tmpl = torch.empty((N,), **f32)
    d_dirs = torch.empty((L, N), **f32) if needs[1] else None
    code = cuda_lib.library().d3d_blend_shapes_bwd_f32(
        g.data_ptr(), shapedirs_flat.data_ptr(), betas.data_ptr(), partial.data_ptr(),
        tmpl_partial.data_ptr(), d_betas.data_ptr(), d_tmpl.data_ptr(),
        d_dirs.data_ptr() if d_dirs is not None else None,
        B, L, N, _row_stride(g), _row_stride(shapedirs_flat), chunk, device, stream,
    )
    cuda_lib.check(code, "d3d_blend_shapes_bwd_f32")
    blend_shapes_fused_backward.launches += 1
    return (d_betas if needs[0] else None), d_dirs, (d_tmpl if needs[2] else None)


class _BlendShapesFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, betas, shapedirs_flat, v_template):
        ctx.save_for_backward(betas, shapedirs_flat)
        return blend_shapes_fused_forward(betas, shapedirs_flat, v_template)

    @staticmethod
    def backward(ctx, grad):
        betas, shapedirs_flat = ctx.saved_tensors
        g = grad.reshape(betas.shape[0], -1).contiguous()
        d_betas, d_dirs, d_tmpl = blend_shapes_fused_backward(g, betas, shapedirs_flat, ctx.needs_input_grad)
        return d_betas, d_dirs, (d_tmpl.reshape(-1, 3) if d_tmpl is not None else None)


def blend_shapes_fused(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """betas (B, L) x shapedirs_flat (L, V*3) + v_template (V, 3) -> (B, V, 3),
    differentiable in all three inputs (forward and backward each a kernel on
    CUDA tensors, the plain version on CPU tensors)."""
    return _BlendShapesFused.apply(betas, shapedirs_flat, v_template)


# kernel launches (one per wrapper call on a CUDA tensor); the CPU path does not count
blend_shapes_fused.launches = 0
blend_shapes_fused_backward.launches = 0
