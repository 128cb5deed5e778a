"""``python -m dad3dheads_tpu_torch.cli.train --synthetic 2 --device cpu`` at
64x64 from the repo's ``configs/train.yaml``, end to end: in a fresh
interpreter that never imports JAX, it writes the metrics, the checkpoints
and an inference export that the port's and the JAX package's
``FaceMeshPredictor`` both load; a second run resumes from ``last``."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64


def _train(exp_dir: str, *flags: str, max_epochs: int = 2) -> subprocess.CompletedProcess:
    """The CLI in a fresh interpreter; afterwards it asserts that neither the
    JAX package nor jax/flax/optax was imported."""
    args = ["--config", "configs/train.yaml", "--synthetic", "2", "--device", "cpu", *flags,
            f"img_size={IMG}", "batch_size=2", f"max_epochs={max_epochs}", f"experiment_dir={exp_dir}"]
    code = textwrap.dedent(
        f"""
        import sys
        from dad3dheads_tpu_torch.cli.train import main
        main({args!r})
        import dad3dheads_tpu_torch.train  # noqa: F401
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("dad3dheads_tpu", "jax", "jaxlib", "flax", "optax"))
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    # one thread: the tests run beside other test processes
    env = {**{k: v for k, v in os.environ.items() if k != "DAD3D_PLATFORM"}, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of the full-width model with its Adam state is ~0.4 GB:
    each test's directory goes when the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    exp = str(root / "exp")
    proc = _train(exp)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-4000:]
    yield exp, proc
    shutil.rmtree(root, ignore_errors=True)


def test_cli_writes_metrics_checkpoints_and_export(run):
    exp, proc = run
    ck = os.path.join(exp, "checkpoints")
    assert os.path.isfile(os.path.join(exp, "config.yaml"))
    for name in ("last.pt", "registry.json", "dad_3dnet.msgpack"):
        assert os.path.isfile(os.path.join(ck, name)), name
    lines = [json.loads(s) for s in open(os.path.join(exp, "metrics.jsonl"))]
    epochs = [m for m in lines if "train/loss" in m]
    assert len(epochs) == 2 and [m["step"] for m in epochs] == [2, 4]
    for m in epochs:
        for key in ("train/loss", "train/grad_norm", "train/metrics/reproject_nme_2d",
                    "valid/metrics/reproject_nme_2d", "train/learning_rate"):
            assert np.isfinite(m[key]), key
    assert any("best/loss" in m for m in lines)
    registry = json.load(open(os.path.join(ck, "registry.json")))
    assert 1 <= len(registry) <= 3 and all(os.path.isfile(e["path"]) for e in registry)
    last = torch.load(os.path.join(ck, "last.pt"), weights_only=True)
    assert (last["step"], last["epoch"]) == (4, 1)
    # the scalars went to TensorBoard too, with no TensorFlow (and so no JAX) in the child
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(os.path.join(exp, "tb")))


def test_both_predictors_load_the_export(run):
    """The export is flax's msgpack: the port's and the JAX package's
    predictors load it and agree (3DMM and vertices atol 1e-4)."""
    from dad3dheads_tpu.api import predictor as jpred
    from dad3dheads_tpu_torch.api import predictor as tpred

    path = os.path.join(run[0], "checkpoints", "dad_3dnet.msgpack")
    config = {"img_size": IMG}
    jp = jpred.FaceMeshPredictor(config=config, checkpoint_path=path)
    tp = tpred.FaceMeshPredictor(config=config, checkpoint_path=path, device="cpu")
    assert tp.loaded_checkpoint == path
    images = np.random.default_rng(7).integers(0, 256, size=(2, IMG, IMG, 3), dtype=np.uint8)
    ref, out = jp.predict_batch(images), tp.predict_batch(images)
    for key in ("3dmm_params", "3d_vertices"):
        assert np.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4, err_msg=key)


def test_cli_resumes_from_last(run, tmp_path):
    """--resume with max_epochs=3 picks up at the saved epoch and step."""
    exp = str(tmp_path / "exp")
    shutil.copytree(run[0], exp)
    proc = _train(exp, "--resume", max_epochs=3)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-4000:]
    assert "resumed from last checkpoint at step 4" in proc.stderr
    last = torch.load(os.path.join(exp, "checkpoints", "last.pt"), weights_only=True)
    assert last["epoch"] == 2 and last["step"] > 4


def test_cli_refuses_without_synthetic(tmp_path):
    """Without --synthetic the CLI trains on the config's on-disk dataset
    (tests/test_torch_train_disk.py); where there is none, it refuses,
    naming the missing annotation file."""
    from dad3dheads_tpu_torch.cli.train import main

    missing = tmp_path / "no_dataset" / "train.json"
    with pytest.raises(FileNotFoundError, match="no_dataset"):
        main(["--config", os.path.join(REPO, "configs/train.yaml"), "--device", "cpu",
              f"experiment_dir={tmp_path / 'exp'}", f"train.ann_path={missing}"])
