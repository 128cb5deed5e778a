"""Host ms a ``predict_batch`` call in the program's ``dad3d.serve.upload`` span:
api/predictor.py's ``.to(device)`` of the pageable uint8 batch."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.serve.upload")
