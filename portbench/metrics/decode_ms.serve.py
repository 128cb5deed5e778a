"""Device ms a ``predict_batch`` call between the CUDA timing events of the
program's ``dad3d.serve.decode`` span: the FLAME decode, rotation and
projection, with the gaps between their kernels."""

from portbench.spans import device_ms


def read(r):
    return device_ms(r, "dad3d.serve.decode")
