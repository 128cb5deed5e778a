"""Device ms of the H2D and D2H copies a ``predict_batch`` call (api/predictor.py's upload and readback)."""

from portbench.readers import copy_ms as read  # noqa: F401
