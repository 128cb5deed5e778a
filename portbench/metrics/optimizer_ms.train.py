"""Device ms a train step of the Adam update and the clip (train/optimizers.py's foreach
kernels)."""

from portbench.readers import optimizer_ms as read  # noqa: F401
