"""The SwinV2 serving cell on the CPU at a small size: its driver runs
through the harness and reads ``correct``; the control and the planted
faults of a serving cell (an answer altered where it is produced; half the
batch left out) read ``correct`` false; its reference imports nothing of
the program. The encoder is a small SwinV2 (128x128 images, embed 16,
depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 8, a BiFPN of 32 filters),
registered in the program under a name of its own for the test; the port
runs in fp32."""

import functools
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import compare, run
from portbench.drivers import predict_batch_swin

CELL = "swinv2_b_w16-bulk-bf16-b256"
SMALL = {"embed_dim": 16, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 8, "patch_size": 4,
         "mlp_ratio": 4}
REPO = Path(__file__).resolve().parents[2]


@pytest.fixture()
def small(monkeypatch):
    from dad3dheads_tpu_torch.models import dad3dnet
    from dad3dheads_tpu_torch.models.swin import SwinSpec, SwinV2Stages

    spec = SwinSpec(embed_dim=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8), window=8)
    monkeypatch.setitem(dad3dnet.ENCODERS, "swinv2_test", functools.partial(SwinV2Stages, spec))
    cell = run.load_spec(CELL)
    cell["config"].update(img_size=128, swin=SMALL)
    cell["config"]["model"].update(backbone="swinv2_test", num_filters=32)
    cell["traffic"].update(batch=4, pool=2, warm_calls=1, dtype="float32")
    return cell


def correct(spec) -> bool:
    result, _ = run.run(spec, 3000000007, 0.3, False, device="cpu", t0=time.perf_counter())
    assert set(result["metrics"]) == {"images_per_s", "batch_p95_ms", "setup_s"}
    return result["correct"]


def test_driver_runs_and_faults_fail(small, monkeypatch):
    from dad3dheads_tpu_torch.api import predictor

    assert correct(small)

    decode = predictor.decode_pipeline_outputs

    def altered(out, stride, img_size):
        dev = decode(out, stride, img_size)
        dev["3dmm"] = dev["3dmm"].clone()
        dev["3dmm"][0] = dev["3dmm"][0] * 1.5
        return dev

    with monkeypatch.context() as m:
        m.setattr(predictor, "decode_pipeline_outputs", altered)
        assert not correct(small)

    run_decoded = predictor.FaceMeshPredictor._run_decoded

    def half_left_out(self, x, replica):
        outs = run_decoded(self, x[: x.shape[0] // 2], replica)
        return tuple(torch.cat([o, torch.zeros_like(o)]) for o in outs)

    with monkeypatch.context() as m:
        m.setattr(predictor.FaceMeshPredictor, "_run_decoded", half_left_out)
        assert not correct(small)


def test_control_fails(small):
    """The reference in fp8 (trunk) and TF32 (decode) reads ``correct``
    false under the cell's limits, where the program in bf16 reads it true.
    (At the cell's own size the control fails every compared number: the
    limits are set so on the card.)"""
    from portbench import calibrate_swin

    small["traffic"]["dtype"] = "bfloat16"
    readings = calibrate_swin.readings(small, 3000000031, 1, True, device="cpu")
    program, ctl = readings
    assert compare.passes(compare.judged(program, small["limits"])), program
    assert not compare.passes(compare.judged(ctl, small["limits"])), ctl


def test_model_flops_count_the_encoder():
    """At the published widths, on the meta device: the encoder's 43.6
    GFLOP an image (linear layers, attention products, merging) and ~4 of
    neck, heads and decode."""
    spec = run.load_spec(CELL)
    flops = predict_batch_swin.model_flops(spec["config"], 2, 256) / 2
    assert 46e9 < flops < 50e9, flops


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.swinv2; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'dad3dheads_tpu_torch', 'dad3dheads_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
