"""Host ms a ``predict_batch`` call in the program's ``dad3d.serve.readback`` span
less its ``dad3d.serve.wait`` child: the blocking ``.cpu()`` copies of
api/predictor.py after the first, which waits for the device's queue."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.serve.readback", less="dad3d.serve.wait")
