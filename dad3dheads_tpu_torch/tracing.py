"""Stage spans of the port, on the profiler's clock.

``span(name, timed=False, **counts)`` marks one stage of a call or a train
step::

    with tracing.span("dad3d.serve.upload", bytes=n, copies=1):
        x = x.to(device)

Tracing is on only while a ``torch.profiler`` session records, and never
while ``torch.export`` or ``torch.compile`` traces (so exported programs
hold no span). Off, ``span`` checks one flag and returns the shared no-op
:data:`OFF`; nothing is recorded. On, a span

1. enters ``record_function(name)``, so that it stands in the profiler's
   trace beside the device's kernels and copies, on the same clock;
2. appends one :class:`Record` to a bounded in-memory log (the last
   :data:`LOG_SIZE` spans): its name, its parent, its start and end on
   ``time.perf_counter_ns()``, and the counts given;
3. with ``timed=True``, where CUDA is in use, records a timing event on the
   current stream at entry and at exit; the record's ``device_ms`` is the
   time between them (the stage's kernels and the gaps between them), read
   once the caller has synchronised. Only the spans whose device time a
   reader wants ask for it: the events cost most of a span's time.

Every profiler capture is so a tracing session: a benchmark's traced slice,
``utils.profile_trace``, a test's CPU profiler. ``records()`` returns the
log and ``clear()`` empties it; nothing is written to disk (a Chrome trace
of the profiler already carries the spans).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

LOG_SIZE = 65536

_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_ids = itertools.count()
_local = threading.local()  # the open spans of each thread, innermost last
_profiling = torch.autograd._profiler_enabled
_compiling = torch.compiler.is_compiling


class Record:
    """One span. ``start_ns`` and ``end_ns`` are ``time.perf_counter_ns()``
    (``end_ns`` None while it is open); ``parent`` the ``id`` of the span it
    opened in, or None for the outermost span of a call."""

    __slots__ = ("id", "name", "parent", "start_ns", "end_ns", "counts", "_events", "_device_ms")

    def __init__(self, name: str, parent: Optional[int], counts: Dict[str, int]):
        self.id = next(_ids)
        self.name, self.parent, self.counts = name, parent, counts
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self._events = None
        self._device_ms: Optional[float] = None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's entry and exit on its stream (waits
        for the exit event); None unless the span was ``timed`` on CUDA."""
        if self._events is not None and self.end_ns is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms, self._events = start.elapsed_time(end), None
        return self._device_ms


class _Off:
    """The span of a run that nobody profiles: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Span:
    __slots__ = ("_name", "_timed", "_counts", "_record", "_rf", "_stream")

    def __init__(self, name: str, timed: bool, counts: Dict[str, int]):
        self._name, self._timed, self._counts = name, timed, counts

    def __enter__(self) -> Record:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        rec = Record(self._name, parent.id if parent else None, self._counts)
        self._rf = record_function(self._name)
        self._rf.__enter__()
        self._stream = None
        if self._timed and torch.cuda.is_initialized():
            self._stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            rec._events = (start, None)
        stack.append(rec)
        _log.append(rec)
        self._record = rec
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self._record
        rec.end_ns = time.perf_counter_ns()
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            rec._events = (rec._events[0], end)
        _local.stack.pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str, timed: bool = False, **counts: int):
    """A context manager over one stage; ``counts`` (bytes, copies) are kept
    with the record, and ``timed`` records its device time. The shared no-op
    :data:`OFF` unless a profiler records and no compiler traces."""
    if not _profiling() or _compiling():
        return OFF
    return _Span(name, timed, counts)


def records() -> List[Record]:
    """The log as it stands, oldest first."""
    return list(_log)


def clear() -> None:
    _log.clear()
