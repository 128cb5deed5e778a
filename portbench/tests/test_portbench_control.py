"""The control comes out as not correct: the reference put in the program's
place one precision below what each cell states (the trunk's convolutions
in fp8, the FLAME decode's products in TF32) fails at least one of the
cell's numbers under its own limits. On the CPU at a small size (128x128
images, a few rows); at the cell's own size on the card (``cuda``)."""

import pytest
import torch

from portbench import calibrate, compare, run

CELLS = ("resnet50-bulk-bf16-b256", "mobilenet_w1-bulk-bf16-b256", "resnet50-train-bf16-b128",
         "mobilenet_w1-train-bf16-b128")


def control_fails(spec, readings) -> bool:
    control = [r for r in readings if r["reading"] == "control"]
    assert control
    return all(not compare.passes(compare.judged(r, spec["limits"])) for r in control)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    spec = run.load_spec(cell)
    spec["config"]["img_size"] = 128
    spec["traffic"].update(batch=8, pool=3, warm_calls=0, sample_calls=1)
    assert control_fails(spec, calibrate.readings(spec, 3000000031, 1, True, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = run.load_spec(cell)
    for seed in (3000000041, 3000000042, 3000000043):
        assert control_fails(spec, calibrate.readings(spec, seed, 2, True))
