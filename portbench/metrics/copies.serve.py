"""Host-device copies a ``predict_batch`` call, from the ``copies=`` counts of
the program's ``dad3d.serve.upload`` and ``dad3d.serve.readback`` spans: the
uint8 batch up, then one ``.cpu()`` a returned array."""

from portbench.spans import count


def read(r):
    return count(r, "copies")
