"""The SwinV2 attention cores' share of their roofline in ``predict_batch``
calls: the bounds of the program's ``dad3d.swin.attention`` spans, computed
from their counts (``portbench/roofline_swin.py``), over the spans' measured
device time."""

from portbench.roofline_swin import attention_roofline_pct as read  # noqa: F401
