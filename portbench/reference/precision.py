"""Lower precisions for the benchmark's control: the reference computed one
step below what the configuration states, rounded on both devices alike.

- ``fp8``: a tensor scaled per tensor into float8 e4m3's range and rounded to
  it; in a backward pass the incoming gradient is scaled and rounded to
  float8 e5m2 (the usual fp8 training recipe). It stands in for the bf16
  trunk's convolution operands.
- ``tf32_matmul``: a product whose operands are rounded to TF32's 10-bit
  mantissa, accumulated in fp32. It stands in for the fp32 FLAME decode.
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, and its gradient too: the configuration's own trunk
    precision, for a second witness beside the program."""
    return _BF16.apply(x)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to the nearest TF32 value (ties away from zero); in a
    backward pass the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b))


def exact_fp32() -> None:
    """Full fp32 products on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
