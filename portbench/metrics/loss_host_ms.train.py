"""Host ms a train step in the program's ``dad3d.train.loss`` span: the shared FLAME
decode and the four losses."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.loss")
