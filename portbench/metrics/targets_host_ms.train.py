"""Host ms a train step in the program's ``dad3d.train.targets`` span: the heatmap
encode and the image normalize of train/step.py."""

from portbench.spans import host_ms


def read(r):
    return host_ms(r, "dad3d.train.targets")
