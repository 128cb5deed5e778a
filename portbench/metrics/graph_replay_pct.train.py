"""Share of the traced train steps whose work ran as a CUDA graph's replay, in %:
the ``graphed`` count of the program's ``dad3d.train_step`` spans (train/step.py's
host dispatch). A program whose spans carry no such count reads nothing."""

from portbench.spans import _closed, count

ROOT = ("dad3d.train_step",)


def read(r):
    if not any("graphed" in x.counts for x in _closed() if x.name in ROOT):
        return None
    return 100.0 * count(r, "graphed", names=ROOT)
