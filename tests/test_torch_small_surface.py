"""The port's small surface against the JAX package on the CPU: ``utils``
(logger, yaml, paths, NaN debugging, a profiler trace with a named span),
the rest of ``core/projection.py`` on seeded inputs, and ``cli.visualize``'s
PNG against the JAX CLI's on one written dataset item."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import utils as tutils
from dad3dheads_tpu_torch.core import projection as tproj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_utils_match_jax(tmp_path):
    from dad3dheads_tpu import utils as jutils

    config = os.path.join(REPO, "configs", "train.yaml")
    assert tutils.load_yaml(config) == jutils.load_yaml(config)
    assert tutils.get_relative_path("a/b.yaml", config) == jutils.get_relative_path("a/b.yaml", config)
    port, ref = tutils.create_logger("dad3d.test.port"), jutils.create_logger("dad3d.test.jax")
    assert port.level == ref.level and len(port.handlers) == len(ref.handlers) == 1
    assert port.handlers[0].formatter._fmt == ref.handlers[0].formatter._fmt
    assert tutils.create_logger("dad3d.test.port") is port and len(port.handlers) == 1
    logging.getLogger("dad3d.test.port").handlers.clear()

    assert not torch.is_anomaly_enabled()
    tutils.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        tutils.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tutils.profile_trace(str(tmp_path / "trace")):
        with tutils.annotate("dad3d_span"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "dad3d_span" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


def test_projection_matches_jax():
    """calculate_paddings equal; project_vertices_onto_image and
    landmarks_img_to_input within 1e-6 relative of the JAX functions."""
    import jax.numpy as jnp

    from dad3dheads_tpu.core import projection as jproj

    for h, w in ((480, 640), (640, 480), (101, 100), (7, 7), (1, 1080)):
        assert tproj.calculate_paddings(h, w) == jproj.calculate_paddings(h, w)
    rng = np.random.default_rng(11)
    verts = np.concatenate([rng.normal(size=(500, 3)), np.ones((500, 1))], -1).astype(np.float32)
    proj = np.array([[2.0, 0.1, 0.0, 0.3], [0.0, 1.8, 0.2, -0.1], [0.0, 0.0, 1.0, 0.5], [0.01, 0.02, 0.3, 4.0]],
                    np.float32)
    ref = np.asarray(jproj.project_vertices_onto_image(jnp.asarray(verts), jnp.asarray(proj), jnp.asarray(480.0),
                                                       jnp.asarray(12.0), jnp.asarray(7.0)))
    out = tproj.project_vertices_onto_image(torch.from_numpy(verts), torch.from_numpy(proj), 480.0,
                                            torch.tensor(12.0), 7.0)
    assert out.dtype == torch.float32 and out.shape == (500, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    lm = rng.uniform(0, 256, (3, 68, 2)).astype(np.float32)
    ref = np.asarray(jproj.landmarks_img_to_input(jnp.asarray(lm), (10, 11, 3, 4), 0.4))
    out = tproj.landmarks_img_to_input(torch.from_numpy(lm), (10, 11, 3, 4), 0.4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_cli_visualize_matches_jax(tmp_path):
    """One item at the dataset's layout: both CLIs write
    ``<id>_GT_landmarks.png`` with the same pixels, and the port's ``main``
    prints its path."""
    import cv2

    from dad3dheads_tpu.cli import visualize as jvis
    from dad3dheads_tpu_torch.cli import visualize as tvis

    rng = np.random.default_rng(12)
    root = tmp_path / "dataset" / "DAD-3DHeadsDataset" / "val"
    (root / "annotations").mkdir(parents=True)
    (root / "images").mkdir()
    cv2.imwrite(str(root / "images" / "000007.png"), rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    mv = np.eye(4)
    mv[:3, 3] = (0.1, -0.2, 0.05)
    proj = [[40.0, 0, 0, 80.0], [0, 40.0, 0, 60.0], [0, 0, 1.0, 0], [0, 0, 0.02, 1.0]]
    ann = {"vertices": rng.uniform(-1, 1, (300, 3)).tolist(), "model_view_matrix": mv.tolist(),
           "projection_matrix": proj}
    with open(root / "annotations" / "000007.json", "w") as f:
        json.dump(ann, f)
    np.testing.assert_array_equal(tvis.get_2d_keypoints(ann, 120), jvis.get_2d_keypoints(ann, 120))
    base = str(tmp_path / "dataset")
    ref = jvis.visualize("val", "000007", base, str(tmp_path / "jax"))
    tvis.main(["--subset", "val", "--id", "000007", "--base-path", base, "--out", str(tmp_path / "port")])
    out = os.path.join(tmp_path, "port", "000007_GT_landmarks.png")
    assert os.path.basename(ref) == os.path.basename(out)
    got, want = cv2.imread(out), cv2.imread(ref)
    assert got is not None and got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != cv2.imread(str(root / "images" / "000007.png"))).any()  # dots were drawn
