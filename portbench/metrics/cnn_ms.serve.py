"""Device ms a ``predict_batch`` call in the CNN's buckets (models/: conv, depthwise, transposes, BN,
elementwise and other ATen work, upsample, max pool)."""

from portbench.readers import cnn_ms as read  # noqa: F401
