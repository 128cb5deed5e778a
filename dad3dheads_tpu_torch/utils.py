"""Cross-cutting utilities: logging, config files, NaN debugging, profiling.
Mirrors ``dad3dheads_tpu/utils.py``:

- ``create_logger``: a console logger factory (no coloredlogs dependency);
- ``enable_nan_debugging``: autograd's anomaly detection, which raises at the
  backward op that produced a NaN (the ``Trainer``'s ``debug_nans``);
- ``profile_trace``: a ``torch.profiler`` capture of a region, written as a
  Chrome trace into ``log_dir`` (CPU and, where there is one, CUDA
  activity); ``annotate`` names a span of it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import yaml

_LOG_FORMAT = "%(asctime)s %(name)s %(levelname)s - %(message)s - %(filename)s:%(lineno)d"


def create_logger(name: str, msg_format: str = "") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(msg_format or _LOG_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if os.environ.get("DEBUG") else logging.INFO)
    return logger


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def get_relative_path(x: str, rel_to: str) -> str:
    return os.path.join(os.path.dirname(rel_to), x)


def enable_nan_debugging(enabled: bool = True) -> None:
    """Fail fast on a NaN produced in the backward pass: autograd's anomaly
    detection, which also records each op's forward stack for the error."""
    import torch

    torch.autograd.set_detect_anomaly(enabled, check_nan=True)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace_<ms>.json`` (Chrome trace format: chrome://tracing,
    Perfetto, TensorBoard's profile plugin)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """Named profiler region for the trace timeline."""
    from torch.profiler import record_function

    return record_function(name)
