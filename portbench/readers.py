"""What a per-layer metric's reader is handed, and the reductions the readers
share. Each metric is a file ``portbench/metrics/<name>.py`` whose ``read``
takes a :class:`Reading` and returns the metric's value, or None where it
finds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

from . import roofline
from .trace import COPY_BUCKETS, KERNEL_PREFIX, OPTIMIZER_BUCKET, Trace


@dataclasses.dataclass
class Reading:
    trace: Trace  # the traced slice of the window, reduced
    calls: int  # calls (serving) or steps (training) inside the traced slice
    counters: Dict[str, int]  # the program's launch counters over the traced slice
    kernel_bounds: Dict[str, tuple]  # counter name -> (trace bucket, bound seconds of one launch)
    model_flops: float  # FLOPs of one call or step at the cell's shapes
    host_call_s: List[float]  # host seconds of every call or step of the whole window


def per_call_ms(r: Reading, seconds: float) -> Optional[float]:
    return seconds * 1e3 / r.calls if seconds > 0 and r.calls else None


def copy_ms(r: Reading) -> Optional[float]:
    """Device ms of the host-device copies a call."""
    return per_call_ms(r, sum(r.trace.buckets_s.get(b, 0.0) for b in COPY_BUCKETS))


def cnn_ms(r: Reading) -> Optional[float]:
    """Device ms a call or step of everything but the hand-written kernels, the
    copies and the optimizer: the CNN's convolutions, BN, elementwise and
    layout work (and in a train step the losses' ATen work)."""
    other = set(COPY_BUCKETS) | {OPTIMIZER_BUCKET}
    return per_call_ms(r, sum(s for b, s in r.trace.buckets_s.items()
                              if not b.startswith(KERNEL_PREFIX) and b not in other))


def optimizer_ms(r: Reading) -> Optional[float]:
    return per_call_ms(r, r.trace.buckets_s.get(OPTIMIZER_BUCKET, 0.0))


def kernel_roofline_pct(r: Reading) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their measured device time,
    over the hand-written kernels that launched in the traced slice."""
    bound = measured = 0.0
    for counter, (bucket, one) in r.kernel_bounds.items():
        n, t = r.counters.get(counter, 0), r.trace.buckets_s.get(bucket, 0.0)
        if n > 0 and t > 0:
            bound += n * one
            measured += t
    return 100.0 * bound / measured if measured > 0 else None


def mfu_pct(r: Reading) -> Optional[float]:
    """Model FLOPs of the traced calls over the traced window's length, as a
    share of the card's bf16 dense peak."""
    if not (r.calls and r.trace.window_s > 0 and r.model_flops > 0):
        return None
    return 100.0 * r.model_flops * r.calls / r.trace.window_s / roofline.PEAK_BF16_FLOPS


def idle_pct(r: Reading) -> Optional[float]:
    w = r.trace.window_s
    return 100.0 * (1.0 - r.trace.busy_s / w) if w > 0 and r.trace.busy_s > 0 else None


def host_call_median_ms(r: Reading) -> Optional[float]:
    return 1e3 * statistics.median(r.host_call_s) if r.host_call_s else None
