"""Device ms a ``predict_batch`` call between the CUDA timing events of the
program's ``dad3d.swin.stage`` spans: the SwinV2 encoder's four stages (the
patch merging, the blocks, the final LayerNorm; all but the patch embedding),
with the gaps between their kernels."""

from portbench.spans import device_ms


def read(r):
    return device_ms(r, "dad3d.swin.stage")
