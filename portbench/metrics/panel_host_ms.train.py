"""Host ms a train step in the program's ``dad3d.train.panel`` span: the metric
panel and the detach of the logs."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.panel")
