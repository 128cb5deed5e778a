"""Host ms a train step in the program's ``dad3d.train.optimizer`` span: the
global-norm clip, Adam and the learning-rate writes."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.optimizer")
