"""Host ms a train step in the program's ``dad3d.train.backward`` span:
``total.backward()``, the main thread waiting while autograd dispatches."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.backward")
