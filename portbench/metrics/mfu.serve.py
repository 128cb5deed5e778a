"""Model FLOPs of the traced ``predict_batch`` calls over the traced window, as a share of
the H100's bf16 dense peak."""

from portbench.readers import mfu_pct as read  # noqa: F401
