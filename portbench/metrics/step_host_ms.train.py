"""Median host ms of a ``train_step`` call over the window (the benchmark's span around
each call, no synchronise inside): train/step.py's host dispatch."""

from portbench.readers import host_call_median_ms as read  # noqa: F401
