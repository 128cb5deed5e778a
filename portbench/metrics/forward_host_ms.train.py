"""Host ms a train step in the program's ``dad3d.train.forward`` span: the
train-mode forward of DAD-3DNet."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.forward")
