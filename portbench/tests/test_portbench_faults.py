"""The comparison that decides ``correct`` fails a broken program. Each test
skips the harness's look for a card and drives the rest of a run on the CPU
at a small size (64x64 images, a few rows; the port in fp32, whose sound run
reads round-off), under the cell's own limits: first sound, then with the
timed path broken underneath in one of the ways the cell can break.

Serving: an answer altered where it is produced; half of the batch left out.
Training: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest. (No cell spans chips, so no exchange
between chips can be left out.)"""

import time

import pytest
import torch

from portbench import run

SERVE = ("resnet50-bulk-bf16-b256", "mobilenet_w1-bulk-bf16-b256")
TRAIN = ("resnet50-train-bf16-b128", "mobilenet_w1-train-bf16-b128")


def small(cell: str, batch: int) -> dict:
    spec = run.load_spec(cell)
    spec["config"]["img_size"] = 64
    spec["traffic"].update(batch=batch, pool=4, warm_calls=1, dtype="float32")
    return spec


def correct(spec) -> bool:
    result, _ = run.run(spec, 3000000007, 0.3, False, device="cpu", t0=time.perf_counter())
    return result["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_serving_faults_fail(cell, monkeypatch):
    from dad3dheads_tpu_torch.api import predictor

    spec = small(cell, 4)
    assert correct(spec)

    decode = predictor.decode_pipeline_outputs

    def altered(out, stride, img_size):
        dev = decode(out, stride, img_size)
        dev["3dmm"] = dev["3dmm"].clone()
        dev["3dmm"][0] = dev["3dmm"][0] * 1.5
        return dev

    with monkeypatch.context() as m:
        m.setattr(predictor, "decode_pipeline_outputs", altered)
        assert not correct(spec)

    run_decoded = predictor.FaceMeshPredictor._run_decoded

    def half_left_out(self, x, replica):
        outs = run_decoded(self, x[: x.shape[0] // 2], replica)
        return tuple(torch.cat([o, torch.zeros_like(o)]) for o in outs)

    with monkeypatch.context() as m:
        m.setattr(predictor.FaceMeshPredictor, "_run_decoded", half_left_out)
        assert not correct(spec)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_fail(cell, monkeypatch):
    from dad3dheads_tpu_torch.train import optimizers, step

    spec = small(cell, 4)
    assert correct(spec)

    def unchanged(self, scale=1.0, sharded=None):
        return torch.zeros(())

    with monkeypatch.context() as m:
        m.setattr(optimizers.Optimizer, "step", unchanged)
        assert not correct(spec)

    build = step.build_train_step

    def half_left_out(*args, **kwargs):
        inner = build(*args, **kwargs)

        def train_step(state, flame, batch, lr_mult=1.0):
            n = next(iter(batch.values())).shape[0] // 2
            return inner(state, flame, {k: v[:n] for k, v in batch.items()}, lr_mult)

        return train_step

    with monkeypatch.context() as m:
        m.setattr(step, "build_train_step", half_left_out)
        assert not correct(spec)
