"""Device ms a ``predict_batch`` call between the CUDA timing events of the
program's ``dad3d.swin.attention`` spans: each SwinV2 block's attention
core, from its qkv output to the output projection's input (cosine
normalisation, the relative-position bias and mask, the attention kernel,
the layout back to tokens)."""

from portbench.spans import device_ms


def read(r):
    return device_ms(r, "dad3d.swin.attention")
