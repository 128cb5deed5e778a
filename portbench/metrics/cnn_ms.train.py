"""Device ms a train step in the CNN's buckets (models/, and the losses' ATen work)."""

from portbench.readers import cnn_ms as read  # noqa: F401
