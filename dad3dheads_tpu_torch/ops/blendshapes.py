"""Fused FLAME blendshapes: v_shaped = betas @ shapedirs + v_template, and
its gradient.

Port of ``dad3dheads_tpu/ops/blendshapes.py`` (the Pallas forward and its
custom VJP). Both are ``torch.library`` custom operators, ``dad3d::blend_shapes``
and ``dad3d::blend_shapes_bwd``, so that ``torch.export`` keeps each as one
node of its graph. :func:`blend_shapes_fused` calls the forward, which is
differentiable through the op's registered autograd, whose backward is the
backward op. On CUDA tensors each op launches its hand-written kernel
(``csrc/blendshapes.cu``: a GEMM on the tensor cores to fp32 accuracy
(3xTF32, ``csrc/tf32x3.cuh``) with the template add fused;
``csrc/blendshapes_bwd.cu``: a deterministic 3xTF32 split-K GEMM for d_betas
with d_template from the same read of the gradient, and an fp32 tiled GEMM
for d_shapedirs); on CPU tensors each runs its plain PyTorch version; its fake
implementation gives the outputs' shapes to a trace. There is no other
dispatch.
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


@torch.library.custom_op("dad3d::blend_shapes", mutates_args=(), device_types="cuda")
def _blend_shapes_op(betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor) -> torch.Tensor:
    """The forward alone, (B, L) x (L, V*3) + (V, 3) -> (B, V, 3): on CUDA
    tensors the kernel, which takes fp32 tensors on one device, contiguous
    except that the rows of shapedirs_flat may lie further apart (FlameModel
    pads them to 16-byte alignment), and raises on anything else."""
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


@_blend_shapes_op.register_kernel("cpu")
def _(betas, shapedirs_flat, v_template):
    return blend_shapes_fused_reference(betas, shapedirs_flat, v_template)


@_blend_shapes_op.register_fake
def _(betas, shapedirs_flat, v_template):
    return betas.new_empty((betas.shape[0], v_template.shape[0], 3), dtype=shapedirs_flat.dtype)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blend_shapes_fused runs on cpu or cuda tensors, got {t.device}")


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


@torch.library.custom_op("dad3d::blend_shapes_bwd", mutates_args=(), device_types="cuda")
def _blend_shapes_bwd_op(
    g: torch.Tensor, betas: torch.Tensor, shapedirs_flat: torch.Tensor, need_dirs: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_betas (B, L), d_shapedirs (L, N), or (0,) unless ``need_dirs``,
    d_template (N,)) from g (B, N): on CUDA tensors the kernel (fp32,
    contiguous but for the row strides of g and shapedirs_flat), which
    computes d_betas and d_template in every launch and d_shapedirs only when
    it is asked for; fixed summation order, so the same inputs give the same
    bits."""
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
    d_dirs = torch.empty((L, N) if need_dirs else (0,), **f32)
    code = cuda_lib.library().d3d_blend_shapes_bwd_f32(
        g.data_ptr(), shapedirs_flat.data_ptr(), betas.data_ptr(), partial.data_ptr(),
        tmpl_partial.data_ptr(), d_betas.data_ptr(), d_tmpl.data_ptr(),
        d_dirs.data_ptr() if need_dirs else None,
        B, L, N, _row_stride(g), _row_stride(shapedirs_flat), chunk, device, stream,
    )
    cuda_lib.check(code, "d3d_blend_shapes_bwd_f32")
    blend_shapes_fused_backward.launches += 1
    return d_betas, d_dirs, d_tmpl


@_blend_shapes_bwd_op.register_kernel("cpu")
def _(g, betas, shapedirs_flat, need_dirs):
    d_betas, d_dirs, d_tmpl = blend_shapes_fused_backward_reference(g, betas, shapedirs_flat, (True, need_dirs, True))
    return d_betas, (d_dirs if need_dirs else g.new_empty((0,))), d_tmpl


@_blend_shapes_bwd_op.register_fake
def _(g, betas, shapedirs_flat, need_dirs):
    B, N = g.shape
    L = shapedirs_flat.shape[0]
    return g.new_empty((B, L)), g.new_empty((L, N) if need_dirs else (0,)), g.new_empty((N,))


def blend_shapes_fused_backward(
    g: torch.Tensor,
    betas: torch.Tensor,
    shapedirs_flat: torch.Tensor,
    needs: Sequence[bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gradients of betas @ shapedirs + template given g = dL/dout (B, N):
    (d_betas (B, L), d_shapedirs (L, N), d_template (N,)), each None where
    ``needs`` says so. The ``dad3d::blend_shapes_bwd`` op: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check_device(g)
    d_betas, d_dirs, d_tmpl = _blend_shapes_bwd_op(g, betas, shapedirs_flat, bool(needs[1]))
    return (d_betas if needs[0] else None), (d_dirs if needs[1] else None), (d_tmpl if needs[2] else None)


def _setup_context(ctx, inputs, output):
    betas, shapedirs_flat, _ = inputs
    ctx.save_for_backward(betas, shapedirs_flat)


def _backward(ctx, grad):
    betas, shapedirs_flat = ctx.saved_tensors
    g = grad.reshape(betas.shape[0], -1).contiguous()
    d_betas, d_dirs, d_tmpl = blend_shapes_fused_backward(g, betas, shapedirs_flat, ctx.needs_input_grad)
    return d_betas, d_dirs, (d_tmpl.reshape(-1, 3) if d_tmpl is not None else None)


_blend_shapes_op.register_autograd(_backward, setup_context=_setup_context)


def blend_shapes_fused(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """betas (B, L) x shapedirs_flat (L, V*3) + v_template (V, 3) -> (B, V, 3),
    differentiable in all three inputs: the ``dad3d::blend_shapes`` op, whose
    forward and backward are each a kernel on CUDA tensors and the plain
    version on CPU tensors."""
    _check_device(betas)
    return _blend_shapes_op(betas, shapedirs_flat, v_template)


# kernel launches (one per op call on CUDA tensors, in a live call or an exported
# program); the CPU path does not count
blend_shapes_fused.launches = 0
blend_shapes_fused_backward.launches = 0
