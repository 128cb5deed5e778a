"""``python -m dad3dheads_tpu_torch.cli.train`` on an on-disk dataset, with
no ``--synthetic``: 4 train and 2 val images at 64x64 rendered by the port's
``cli/make_dataset.py``, batch 2, one epoch, uint8 train batches with device
heatmaps, on the CPU, in a fresh interpreter that never imports JAX. It
writes ``metrics.jsonl`` and ``dad_3dnet.msgpack``, and the JAX package's
predictor loads that file and agrees with the port's."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dad3dheads_tpu_torch.cli.make_dataset import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_disk")
    out, exp = str(root / "ds"), str(root / "exp")
    make_dataset(out, "train", 4, IMG, seed=0, device="cpu")
    make_dataset(out, "val", 2, IMG, seed=1, device="cpu")
    base = os.path.join(out, "DAD-3DHeadsDataset")
    args = ["--config", "configs/train.yaml", "--device", "cpu", f"img_size={IMG}", "batch_size=2", "max_epochs=1",
            "num_workers=2", f"experiment_dir={exp}",
            f"train.ann_path={base}/train/train.json", f"train.dataset_root={base}/train", f"train.img_size={IMG}",
            f"val.ann_path={base}/val/val.json", f"val.dataset_root={base}/val", f"val.img_size={IMG}"]
    code = textwrap.dedent(
        f"""
        import sys
        from dad3dheads_tpu_torch.cli.train import main
        main({args!r})
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("dad3dheads_tpu", "jax", "jaxlib", "flax", "optax"))
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    env = {**{k: v for k, v in os.environ.items() if k != "DAD3D_PLATFORM"}, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-4000:]
    yield exp, proc
    shutil.rmtree(root, ignore_errors=True)


def test_cli_trains_on_disk_data(run):
    exp, proc = run
    lines = [json.loads(s) for s in open(os.path.join(exp, "metrics.jsonl"))]
    (epoch,) = [m for m in lines if "train/loss" in m]
    assert epoch["step"] == 2  # 4 images, batch 2
    for key in ("train/loss", "train/metrics/reproject_nme_2d", "valid/loss", "valid/metrics/reproject_nme_2d"):
        assert np.isfinite(epoch[key]), key
    assert any("best/loss" in m for m in lines)
    assert os.path.isfile(os.path.join(exp, "checkpoints", "dad_3dnet.msgpack"))
    assert "sanity validation (2 steps) passed" in proc.stderr


def test_jax_predictor_loads_the_export(run):
    """The export is flax's msgpack: both packages' predictors load it and
    agree (3DMM and vertices atol 1e-4)."""
    from dad3dheads_tpu.api import predictor as jpred
    from dad3dheads_tpu_torch.api import predictor as tpred

    path = os.path.join(run[0], "checkpoints", "dad_3dnet.msgpack")
    jp = jpred.FaceMeshPredictor(config={"img_size": IMG}, checkpoint_path=path)
    tp = tpred.FaceMeshPredictor(config={"img_size": IMG}, checkpoint_path=path, device="cpu")
    images = np.random.default_rng(8).integers(0, 256, size=(2, IMG, IMG, 3), dtype=np.uint8)
    ref, out = jp.predict_batch(images), tp.predict_batch(images)
    for key in ("3dmm_params", "3d_vertices"):
        assert np.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4, err_msg=key)
