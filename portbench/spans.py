"""Readers of the program's own stage spans (``dad3dheads_tpu_torch.tracing``).

The program records a span only while a profiler records, so over a traced
run its log holds the traced slice alone. Each reader sums a stage over that
log and divides by the slice's calls or steps. A program without the tracing
module, or a log without the stage, reads None (the metric is left out)."""

from __future__ import annotations

from typing import List, Optional

from .readers import Reading

# the spans of the served path's host-device copies, on every entry point
COPY_SPANS = ("dad3d.serve.upload", "dad3d.serve.readback", "dad3d.serve.readback_queue")


def _closed() -> list:
    """The log's spans that have closed."""
    try:
        from dad3dheads_tpu_torch import tracing
    except ImportError:
        return []
    return [x for x in tracing.records() if x.end_ns is not None]


def _per_call(r: Reading, total_ms: float, found: List) -> Optional[float]:
    return total_ms / r.calls if found and r.calls else None


def host_ms(r: Reading, name: str, less: Optional[str] = None) -> Optional[float]:
    """Host ms a call in the ``name`` spans; with ``less``, without the time
    of their children of that name."""
    log = _closed()
    found = [x for x in log if x.name == name]
    ids = {x.id for x in found}
    total = sum(x.host_ms for x in found) - sum(x.host_ms for x in log if x.name == less and x.parent in ids)
    return _per_call(r, total, found)


def device_ms(r: Reading, name: str) -> Optional[float]:
    """Device ms a call between the entry and exit events of the ``name``
    spans, the gaps between their kernels included (None where a span
    recorded no device events)."""
    found = [x for x in _closed() if x.name == name]
    times = [x.device_ms for x in found]
    if any(t is None for t in times):
        return None
    return _per_call(r, sum(times), found)


def count(r: Reading, key: str, names=COPY_SPANS) -> Optional[float]:
    """The ``key`` count of the ``names`` spans, summed, a call."""
    found = [x for x in _closed() if x.name in names]
    return _per_call(r, sum(x.counts.get(key, 0) for x in found), found)
