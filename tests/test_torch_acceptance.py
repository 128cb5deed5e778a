"""``python -m dad3dheads_tpu_torch.cli.acceptance`` end to end on the CPU
at a small size (4 train and 2 val images at 64x64, batch 2, one epoch):
render, score the untrained network, train through the data pipeline,
score the trained checkpoint through host crops, through ``predict_frames``,
with a bf16 trunk, on held-out images, and through the int8 path calibrated
on the val images, in a fresh interpreter that never imports JAX."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("pose_error", "nme_reprojection", "z5_accuracy", "chamfer")


def test_acceptance_cli_on_the_cpu(tmp_path):
    work = str(tmp_path / "acc")
    args = ["--work", work, "--train-num", "4", "--val-num", "2", "--epochs", "1", "--img", "64", "--batch", "2",
            "--device", "cpu", "--device-preprocess", "--int8", "--calib-num", "2"]
    code = textwrap.dedent(
        f"""
        import sys
        from dad3dheads_tpu_torch.cli.acceptance import main
        main({args!r})
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("dad3dheads_tpu", "jax", "jaxlib", "flax", "optax"))
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    # from another directory: the package from PYTHONPATH, the config from the package's checkout
    env = {**{k: v for k, v in os.environ.items() if k != "DAD3D_PLATFORM"}, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-4000:] + proc.stdout[-2000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-2])
    assert result == json.load(open(os.path.join(work, "acceptance.json")))
    legs = ("untrained", "trained_host_preprocess", "trained_device_preprocess", "trained_bf16_host_preprocess",
            "trained_heldout_host_preprocess", "trained_int8_host_preprocess", "trained_int8_device_preprocess")
    for leg in legs:
        assert set(result[leg]) == set(METRICS), leg
        assert all(np.isfinite(v) for v in result[leg].values()), leg
    assert np.isfinite(result["bf16_3dmm_max_abs_gap"]) and np.isfinite(result["int8_3dmm_max_abs_gap"])
    for tag in ("untrained", "trained", "trained_device", "trained_bf16", "trained_heldout", "trained_int8",
                "trained_int8_device"):
        assert any(line.startswith(f"[{tag}] pose_error=") for line in lines), tag
    assert set(result["seconds"]) == {"render_train", "render_val", "render_heldout", "score_untrained", "train",
                                      "score_host", "score_device", "score_bf16", "score_heldout", "calibrate_int8",
                                      "score_int8", "score_int8_device"}
    assert os.path.isfile(os.path.join(work, "amax.npz"))
    assert os.path.isfile(os.path.join(work, "exp", "checkpoints", "dad_3dnet.msgpack"))
