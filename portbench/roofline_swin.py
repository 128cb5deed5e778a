"""The bound of a SwinV2 window-attention core, from the counts of the
program's ``dad3d.swin.attention`` span, whatever implements it.

One core: q, k and v read once and the output written once (4 tokens x
channels values), the relative-position bias (heads x N^2) and, in a
shifted block, the shift mask (windows x N^2) read once, all of the trunk's
``itemsize``; 4 tokens x N x channels FLOPs (q k^T and the product with v, 2
a multiply-add), N the window's tokens. The bound is the larger of the bytes
over the H100's 3.35 TB/s and the FLOPs over its dense peak of that type
(989 TFLOP/s bf16; 67 TFLOP/s fp32)."""

from __future__ import annotations

from typing import Optional

from .readers import Reading
from .roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound_s
from .spans import _closed

ATTENTION_SPAN = "dad3d.swin.attention"
PEAKS = {2: PEAK_BF16_FLOPS, 4: PEAK_FP32_FLOPS}


def attention_bound_s(tokens: int, window_tokens: int, channels: int, heads: int, windows: int, shift: int,
                      itemsize: int) -> float:
    """Seconds one attention core takes at the least: ``tokens`` = B H W,
    ``windows`` a image."""
    tables = (heads + (windows if shift else 0)) * window_tokens ** 2
    moved = itemsize * (4 * tokens * channels + tables)
    return bound_s(moved, 4.0 * tokens * window_tokens * channels, PEAKS[itemsize])


def attention_roofline_pct(r: Reading) -> Optional[float]:
    """Sum of the traced cores' bounds over the sum of their device time, in
    %; None without such spans or their device time."""
    found = [x for x in _closed() if x.name == ATTENTION_SPAN]
    times = [x.device_ms for x in found]
    if not found or any(t is None for t in times) or sum(times) <= 0:
        return None
    return 100.0 * sum(attention_bound_s(**x.counts) for x in found) / (sum(times) / 1e3)
