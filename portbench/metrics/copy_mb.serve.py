"""MB (1e6 bytes) a ``predict_batch`` call handed between host and device,
from the ``bytes=`` counts of the program's ``dad3d.serve.upload`` and
``dad3d.serve.readback`` spans."""

from portbench.spans import count


def read(r):
    n = count(r, "bytes")
    return None if n is None else n / 1e6
