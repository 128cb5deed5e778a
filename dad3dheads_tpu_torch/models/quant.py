"""Post-training int8 quantization primitives. Port of
``dad3dheads_tpu/models/quant.py``.

Activations are quantized per tensor (``x ~ q * scale``, q in [-127, 127],
half-to-even rounding as ``jnp.round``), conv kernels per output channel
after BatchNorm is folded in. Kernels keep the port's OIHW layout: the
per-channel reduction runs over dims (1, 2, 3), where the JAX package's HWIO
reduces over (0, 1, 2).

The integer product. The JAX package convolves int8 x int8 into int32
(``preferred_element_type=jnp.int32``). A sum can pass 2**24 (stage 4's 3x3
conv adds 4,608 products of up to 127**2), so no fp32, TF32, bf16 or fp16
product of the int8 values is exact. :func:`conv_int8` takes the exact
integer route on every device: an im2col of the int8 NHWC tensor built from
one strided view of the padded input, copied once, then one ``torch._int_mm`` (int8 ->
int32, cuBLAS on the card). ``torch._int_mm`` on the card wants more than 16
rows and K and N multiples of 8, so the operands are zero-padded wherever a
site misses that (the stem's K 147 -> 152, the fusion conv's K 1,348 ->
1,352, the heatmap head's N 68 -> 72, BiFPN's smallest levels' rows); the
padding is the same on the CPU, and a zero row or column adds nothing to a
sum. There is no float fallback. The plain reference of the product is a
float64 convolution of the same int8 values, exact below 2**53
(:func:`conv_int8_accumulator_reference`).

The epilogue runs in the JAX order as separate fp32 operations:
``acc * (x_scale * w_scale) + bias``, ReLU, then requantization. XLA may
contract the multiply-add into one FMA, so a requantized value may differ by
one where the product sits on a rounding tie.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

QMAX = 127
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows
INT_MM_ALIGN = 8  # torch._int_mm on CUDA: K and N multiples of 8


class QTensor(NamedTuple):
    """int8 values + the fp32 scale that dequantizes them (x ~ values * scale)."""

    values: torch.Tensor  # int8
    scale: torch.Tensor  # () fp32


def quantize(x: torch.Tensor, scale: torch.Tensor) -> QTensor:
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return QTensor(q.to(torch.int8), scale)


def dequantize(q: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.values.float() * q.scale).to(dtype)


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, the divisor a tensor: CUDA divides by a Python
    float as a multiply by its reciprocal, which is not the quotient (the
    CPU and the JAX package divide), and a scale an ulp apart moves values
    across rounding ties."""
    return torch.clamp_min(amax, 1e-8) / amax.new_tensor(127.0)


def fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps: float):
    """Fold eval-mode BatchNorm into the preceding conv.

    kernel: (cout, cin, kh, kw). Returns (kernel', bias') with
    conv(x, kernel') + bias' == BN(conv(x, kernel))."""
    inv = bn_scale / torch.sqrt(bn_var + eps)  # (cout,)
    return kernel * inv[:, None, None, None], bn_bias - bn_mean * inv


def quantize_weights_per_channel(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cout, cin, kh, kw) fp -> int8 kernel + per-cout fp32 scales."""
    scale = _amax_scale(torch.amax(torch.abs(kernel), dim=(1, 2, 3)))
    q = torch.clamp(torch.round(kernel / scale[:, None, None, None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def gemm_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """int8 (cout, cin, kh, kw) -> the (N, K) operand of the im2col product,
    K in (kh, kw, cin) order, zero-padded to multiples of 8. Computed once
    per site by ``prepare_int8_params``."""
    n, cin, kh, kw = kernel_q.shape
    w = kernel_q.permute(0, 2, 3, 1).reshape(n, kh * kw * cin)
    return F.pad(w, (0, _round_up(w.shape[1], INT_MM_ALIGN) - w.shape[1], 0, _round_up(n, INT_MM_ALIGN) - n))


def _im2col(values: torch.Tensor, k: int, stride: int, pad: int, k_cols: int, extra_rows: int) -> torch.Tensor:
    """int8 NHWC -> (B*Ho*Wo, k*k*C) patches, columns in (kh, kw, cin) order,
    zero-padded to ``k_cols`` columns and by ``extra_rows`` rows. The windows
    are one strided view of the padded input (a 1x1 conv's, the input
    itself), copied once; a 1x1 stride-1 conv that needs no padding is the
    input, viewed."""
    C = values.shape[3]
    if pad:
        values = F.pad(values, (0, 0, pad, pad, pad, pad))
    if k == 1:
        cols = values[:, ::stride, ::stride].reshape(-1, C)
    else:
        # (B, Ho, Wo, C, kh, kw) -> (B, Ho, Wo, kh, kw, C)
        cols = values.unfold(1, k, stride).unfold(2, k, stride).permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * C)
    if k_cols > cols.shape[1] or extra_rows:
        cols = F.pad(cols, (0, k_cols - cols.shape[1], 0, extra_rows))
    return cols


def conv_int8_accumulator(values: torch.Tensor, weight: torch.Tensor, k: int, stride: int,
                          pad: int) -> torch.Tensor:
    """The exact int32 sums of an int8 NHWC input against ``weight``, the
    (N, K) operand of :func:`gemm_weight` of a k x k kernel, with zero
    padding ``pad``: (B, Ho, Wo, N), N the padded output width."""
    H, W = values.shape[1:3]
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    # a site whose map has fewer than 17 pixels gets 17 zero rows whatever
    # the batch, so that the choice does not depend on it
    extra = INT_MM_MIN_ROWS if Ho * Wo < INT_MM_MIN_ROWS else 0
    B = values.shape[0]
    cols = _im2col(values, k, stride, pad, weight.shape[1], extra)
    return torch._int_mm(cols, weight.t())[: B * Ho * Wo].view(B, Ho, Wo, -1)


def conv_int8_accumulator_reference(values: torch.Tensor, kernel_q: torch.Tensor, stride: int,
                                    pad: int) -> torch.Tensor:
    """The plain version: a float64 convolution of the int8 values (exact
    below 2**53), as int32, (B, Ho, Wo, cout)."""
    y = F.conv2d(values.permute(0, 3, 1, 2).double(), kernel_q.double(), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def conv_int8(
    xq: QTensor,
    weight: torch.Tensor,
    k: int,
    w_scale: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    pad: int,
    out_scale: Optional[torch.Tensor] = None,
    relu: bool = True,
    out_dtype: torch.dtype = torch.bfloat16,
):
    """int8 conv (NHWC in and out) of a k x k kernel given as its
    :func:`gemm_weight` operand, with the dequant + bias (+ ReLU)
    (+ requant) epilogue. Returns a QTensor when ``out_scale`` is given
    (int8-resident chain), else a dense ``out_dtype`` tensor."""
    y = _epilogue(conv_int8_accumulator(xq.values, weight, k, stride, pad), xq.scale, w_scale, bias, relu)
    if out_scale is None:
        return y.to(out_dtype)
    return quantize(y, out_scale)


def _epilogue(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
              relu: bool) -> torch.Tensor:
    """Dequantize the int32 sums (the padded columns dropped), add the
    bias, ReLU: fp32."""
    y = acc[..., : w_scale.shape[0]].float() * (x_scale * w_scale) + bias
    return torch.clamp_min(y, 0.0) if relu else y


def _residual(a: QTensor, b: QTensor) -> torch.Tensor:
    """Dequantize both operands, add, ReLU: fp32."""
    return torch.clamp_min(a.values.float() * a.scale + b.values.float() * b.scale, 0.0)


def add_relu_requant(a: QTensor, b: QTensor, out_scale: torch.Tensor) -> QTensor:
    """Residual join: dequantize both operands, add, ReLU, requantize."""
    return quantize(_residual(a, b), out_scale)
