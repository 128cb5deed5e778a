"""Fused FLAME blendshapes: v_shaped = betas @ shapedirs + v_template.

Port of ``dad3dheads_tpu/ops/blendshapes.py``. On CUDA tensors
:func:`blend_shapes_fused` launches the hand-written kernel of
``csrc/blendshapes.cu`` (an exact-fp32 tiled GEMM with the template add fused
into its epilogue); on CPU tensors it runs :func:`blend_shapes_fused_reference`,
the plain PyTorch version of the same function. There is no other dispatch.

Forward only: the backward (two fp32 matmuls and a column sum, the JAX
package's custom VJP) lands with the training port.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def blend_shapes_fused_reference(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: betas (B, L) @ shapedirs (L, V*3) + template
    (V, 3) -> (B, V, 3), fp32."""
    B, V = betas.shape[0], v_template.shape[0]
    out = torch.matmul(betas.float(), shapedirs_flat) + v_template.reshape(1, -1)
    return out.reshape(B, V, 3)


def blend_shapes_fused(
    betas: torch.Tensor, shapedirs_flat: torch.Tensor, v_template: torch.Tensor
) -> torch.Tensor:
    """betas (B, L) x shapedirs_flat (L, V*3) + v_template (V, 3) -> (B, V, 3).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes contiguous fp32 tensors on one device and raises on anything else."""
    if betas.device.type == "cpu":
        return blend_shapes_fused_reference(betas, shapedirs_flat, v_template)
    if betas.device.type != "cuda":
        raise ValueError(f"blend_shapes_fused runs on cpu or cuda tensors, got {betas.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (betas, shapedirs_flat, v_template)
    ):
        raise NotImplementedError(
            "blend_shapes_fused has no CUDA backward yet: it lands with the "
            "training port. Call it under torch.no_grad() or on detached tensors."
        )
    B, L = betas.shape
    V = v_template.shape[0]
    N = V * 3
    for name, t, shape in (
        ("betas", betas, (B, L)),
        ("shapedirs_flat", shapedirs_flat, (L, N)),
        ("v_template", v_template, (V, 3)),
    ):
        if t.device != betas.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {betas.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    out = torch.empty((B, N), dtype=torch.float32, device=betas.device)
    device, stream = cuda_lib.launch_args(betas)
    code = cuda_lib.library().d3d_blend_shapes_f32(
        betas.data_ptr(), shapedirs_flat.data_ptr(), v_template.data_ptr(), out.data_ptr(),
        B, L, N, device, stream,
    )
    cuda_lib.check(code, "d3d_blend_shapes_f32")
    blend_shapes_fused.launches += 1
    return out.reshape(B, V, 3)


blend_shapes_fused.launches = 0  # kernel launches; the CPU path does not count
