"""The hand-written kernels' share of their roofline in train steps: the sum of the
launches' bounds over their measured device time (ops/, core/flame.py -> csrc/)."""

from portbench.readers import kernel_roofline_pct as read  # noqa: F401
