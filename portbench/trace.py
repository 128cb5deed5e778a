"""From a ``torch.profiler`` trace of the measured window to device seconds by
kernel bucket, the device's busy time, and the idle gaps named by what the
host was doing.

``BUCKETS``, ``bucket_of``, ``device_events`` and ``union_us`` are copies of
``dad3dheads_tpu_torch/trace_paths.py``'s, frozen here so that a change to the
program cannot move the yardstick."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
from torch.autograd import DeviceType

# bucket -> substrings of a kernel or copy name (lowercase), first match wins
BUCKETS = (
    ("kernel: resample_normalize", ("resample_kernel",)),
    ("kernel: normalize_images", ("normalize_vec_kernel", "normalize_scalar_kernel")),
    ("kernel: blend_shapes_fused", ("blend_shapes_kernel",)),
    ("kernel: blend_shapes_fused_backward", ("dbetas_partial_kernel", "dbetas_reduce_kernel", "ddirs_kernel")),
    ("optimizer (Adam, clip: foreach kernels)", ("multi_tensor_apply", "foreach")),
    ("memcpy HtoD", ("memcpy htod",)),
    ("memcpy DtoH", ("memcpy dtoh",)),
    ("depthwise conv (cuDNN's *_c1_k1_nhwc and xmma depthwise, ATen's conv_depthwise2d)",
     ("_c1_k1_", "depthwise_convolution", "conv_depthwise2d")),
    ("layout transposes, cuDNN's", ("nhwctonchw", "nchwtonhwc")),
    ("copies and casts, ATen's (layout copies included)", ("copy_kernel",)),
    ("batch norm (cuDNN's in fp32, ATen's in bf16)", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv (cuDNN/CUTLASS/GEMM, FFT)", ("cudnn", "xmma", "cutlass", "gemm", "conv", "sm90_", "wgrad", "dgrad",
                                        "fft", "pointwise_mult_and_sum_complex")),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
)
OTHER = "elementwise and other"
KERNEL_PREFIX = "kernel: "  # the hand-written kernels' buckets
COPY_BUCKETS = ("memcpy HtoD", "memcpy DtoH")
OPTIMIZER_BUCKET = "optimizer (Adam, clip: foreach kernels)"
WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"
TOP = 10


def bucket_of(name: str) -> str:
    low = name.lower()
    for bucket, keys in BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return OTHER


def device_events(prof) -> list:
    """(name, start_us, end_us) of every kernel, copy and memset on the card
    (not the device-side spans of annotations such as ``Optimizer.step``,
    which cover kernels already counted)."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not out:
        raise RuntimeError("the profiler recorded no device activity on this machine")
    return out


def union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """The traced window, reduced: seconds throughout."""

    window_s: float
    busy_s: float
    buckets_s: Dict[str, float]
    kernels_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]


def _host_label(cpu: list, starts: list, spans: list, t: float) -> str:
    """The innermost host event running at ``t``, under the span of the
    benchmark's own around it (a call or a step)."""
    inner = "host Python, between recorded ops"
    for j in range(bisect.bisect_right(starts, t) - 1, max(bisect.bisect_right(starts, t) - 5001, -1), -1):
        name, s, e = cpu[j]
        if s <= t <= e:
            inner = name
            break
    outer = next((n for n, s, e in spans if s <= t <= e), None)
    return f"{outer}: {inner}" if outer else inner


def reduce(prof) -> Trace:
    """The profiled window (the benchmark's ``portbench.window`` span) reduced
    to device seconds by bucket and by kernel, the union of the device's
    activity, and the idle gaps inside the window by what the host was doing."""
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == WINDOW_SPAN and e.device_type == DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = windows[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in device_events(prof) if e > w0 and s < w1]
    buckets: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for name, s, e in dev:
        b = bucket_of(name)
        buckets[b] = buckets.get(b, 0.0) + (e - s) / 1e6
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
    busy = _merged([(s, e) for _, s, e in dev])
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CPU]
    spans = [c for c in host if c[0].startswith("portbench.") and c[0] != WINDOW_SPAN]
    cpu = sorted((c for c in host if not c[0].startswith("portbench.")), key=lambda c: c[1])
    starts = [c[1] for c in cpu]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = _host_label(cpu, starts, spans, 0.5 * (a + b))
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return Trace(
        window_s=(w1 - w0) / 1e6,
        busy_s=union_us([(s, e) for _, s, e in dev]) / 1e6,
        buckets_s=buckets,
        kernels_s=kernels,
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
    )


def breakdown(t: Trace) -> dict:
    """The ``breakdown`` of a traced run's result line."""
    ops = sorted(t.kernels_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n[:160], s] for n, s in t.idle_gaps[:TOP]]}
