"""Device ms a ``predict_batch`` call between the CUDA timing events of the
program's ``dad3d.serve.network`` span: DAD-3DNet and its landmark and 3DMM
decode, with the gaps between their kernels."""

from portbench.spans import device_ms


def read(r):
    return device_ms(r, "dad3d.serve.network")
