"""The port's deployment artifact on the CPU, at tests/test_export.py's size
(mobilenet_w1, 128x128, 64 BiFPN filters): ``api/export.py`` and
``cli/export.py``. The trainer's ``export_aot``, serving without model code
and the ``dad3d::`` operators' checks are in
tests/test_torch_export_serve.py.

One ``.msgpack`` checkpoint of numpy-drawn flax variables feeds the port's
live predictor, the port's artifact (written by ``cli.export``) and the JAX
package's artifact (``export_predictor(..., platforms=("cpu",))``). The
artifact is held against the live predictor at tests/test_export.py's
tolerances and against the JAX artifact on the same weights and inputs. The
kernels' card checks are in tests/test_torch_kernels.py,
tests/test_torch_frames.py and tests/test_torch_render.py (marked ``cuda``)
and in ``chip_smoke.py``.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dad3dheads_tpu.api import predictor as jpred
from dad3dheads_tpu.models import create_model as jax_create_model
from dad3dheads_tpu_torch.api import predictor as tpred
from dad3dheads_tpu_torch.api.export import SUFFIX, ExportedFaceMeshPredictor, export_predictor, read_meta


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 128
MODEL = {"backbone": "mobilenet_w1", "num_classes": 68, "num_filters": 64}
CONFIG = {"img_size": IMG, "stride": 4, "model": MODEL}
MESH_KEYS = {"points", "projected_vertices", "3d_vertices", "3dmm_params"}


def seeded_variables(seed: int):
    """Random flax variables of the model's tree shapes, drawn with numpy:
    kernels at half the lecun-normal variance, BN statistics and affine
    terms non-trivial. The shapes come from tracing ``model.init`` without
    compiling it."""
    model = jax_create_model(MODEL)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            value = rng.normal(size=shape) * np.sqrt(0.5 / np.prod(shape[:-1]))
        elif name.endswith(("['var']", "['scale']", "['w1']", "['w2']")):
            value = rng.uniform(0.75, 1.25, size=shape)
        elif name.endswith("['depthwise_scale']"):
            value = rng.normal(size=shape)
        else:  # biases and BN means
            value = rng.normal(size=shape) * 0.1
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return jpred.save_predictor_checkpoint(seeded_variables(5), str(tmp_path_factory.mktemp("ck") / "dad_3dnet.msgpack"))


@pytest.fixture(scope="module")
def live(checkpoint):
    return tpred.FaceMeshPredictor(CONFIG, checkpoint_path=checkpoint, device="cpu", require_weights=True)


@pytest.fixture(scope="module")
def artifact(checkpoint, tmp_path_factory):
    """The port's artifact, written by ``cli.export`` on the CPU."""
    from dad3dheads_tpu_torch.cli.export import main

    out = str(tmp_path_factory.mktemp("aot") / f"dad_3dnet{SUFFIX}")
    return main(["--checkpoint", checkpoint, "--out", out, "--img-size", str(IMG), "--backbone", "mobilenet_w1",
                 "--num-filters", "64", "--device", "cpu", "--devices", "cpu"])


@pytest.fixture(scope="module")
def exported(artifact):
    return ExportedFaceMeshPredictor(artifact, device="cpu")


@pytest.fixture(scope="module")
def jax_exported(checkpoint, tmp_path_factory):
    from dad3dheads_tpu.api import export as jexport

    pred = jpred.FaceMeshPredictor(CONFIG, checkpoint_path=checkpoint)
    path = str(tmp_path_factory.mktemp("jaot") / "dad_3dnet.aot.npz")
    jexport.export_predictor(pred.model, pred.variables, pred.flame, path, img_size=IMG, stride=4,
                             platforms=("cpu",))
    return jexport.ExportedFaceMeshPredictor(path)


def _uint8(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


FRAMES = [(160, 140), (96, 200), (128, 128)]
BOXES = [(10, 12, 120, 150), (0, 0, 200, 96), (4, 4, 124, 124)]


def _frames(seed: int = 7) -> list:
    return [_uint8(seed + i, h, w, 3) for i, (h, w) in enumerate(FRAMES)]


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# --------------------------------------------------------------------------
# the artifact against the port's live predictor
# --------------------------------------------------------------------------


def test_call_matches_live(exported, live):
    image = _uint8(1, 180, 150, 3)
    ref, got = live(image), exported(image)
    assert set(got) == MESH_KEYS
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_predict_images_matches_call(exported):
    """Three images in chunks of two, the ragged last chunk through the same
    program unpadded."""
    images = [_uint8(2 + i, h, w, 3) for i, (h, w) in enumerate([(150, 120), (90, 160), (128, 128)])]
    bulk = exported.predict_images(images, batch_size=2, num_workers=2)
    assert len(bulk) == 3
    for img, got in zip(images, bulk):
        ref = exported(img)
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got["points"], ref["points"])
        np.testing.assert_allclose(got["3dmm_params"], ref["3dmm_params"], atol=1e-5)
        np.testing.assert_allclose(got["3d_vertices"], ref["3d_vertices"], atol=1e-5)
    slim = exported.predict_images(images, batch_size=2, with_mesh=False)
    assert all(set(p) == {"points", "3dmm_params"} for p in slim)


def test_predict_frames_matches_live(exported, live):
    """Chunks of two: buffers of 192x256 and 128x128 through one program, the
    boxes clamped inside it, points in full-frame coordinates."""
    frames = _frames()
    a = exported.predict_frames(frames, bboxes=BOXES, batch_size=2)
    b = live.predict_frames(frames, bboxes=BOXES, batch_size=2)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert set(x) == MESH_KEYS
        np.testing.assert_allclose(x["points"], y["points"], atol=1)
        np.testing.assert_allclose(x["3dmm_params"], y["3dmm_params"], atol=1e-5)
        np.testing.assert_allclose(x["3d_vertices"], y["3d_vertices"], atol=1e-4)


def test_predict_batch_uint8_matches_fp32_and_live(exported, live):
    """uint8 is normalized on the host as the normalize kernel computes it:
    the same as its fp32 image, and as the live predictor's predict_batch."""
    from dad3dheads_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD

    u8 = _uint8(3, 2, IMG, IMG, 3)
    f32 = (u8.astype(np.float32) / 255.0 - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    a, b, ref = exported.predict_batch(u8), exported.predict_batch(f32), live.predict_batch(u8)
    np.testing.assert_allclose(a["3dmm_params"], b["3dmm_params"], atol=1e-4)
    for k in ref:
        np.testing.assert_allclose(a[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("batch", [1, 3])
def test_batch_polymorphism(exported, batch):
    out = exported.predict_batch(_uint8(4 + batch, batch, IMG, IMG, 3))
    V = 5023
    expect = {"points": (batch, 68, 2), "3d_vertices": (batch, V, 3), "projected_vertices": (batch, V, 2),
              "3dmm_params": (batch, 413)}
    for k, shape in expect.items():
        assert out[k].shape == shape and out[k].dtype == np.float32 and np.isfinite(out[k]).all(), k


def test_metadata(artifact):
    meta = read_meta(artifact)
    assert meta["format_version"] == 1 and meta["devices"] == ["cpu"] and meta["quantized"] is False
    assert (meta["img_size"], meta["stride"], meta["backbone"], meta["dtype"]) == (IMG, 4, "mobilenet_w1", "float32")
    assert meta["constants"]["shape"] == 300 and sum(meta["constants"].values()) == 413
    assert meta["resize_mode"] == "longest_max_size" and meta["torch_version"] == torch.__version__
    assert set(meta["export_seconds"]) == {f"{p}.cpu" for p in ("pipeline", "decode", "frames")}
    names = set(zipfile.ZipFile(artifact).namelist())
    assert names == {"meta.json", "weights.pt", "pipeline.cpu.pt2", "decode.cpu.pt2", "frames.cpu.pt2"}


def test_weights_are_stored_once(artifact):
    """The programs carry no tensors of their own: the weights and FLAME
    arrive as arguments, from weights.pt alone."""
    with zipfile.ZipFile(artifact) as z:
        sizes = {i.filename: i.file_size for i in z.infolist()}
    weights = sizes.pop("weights.pt")
    assert weights > 30e6  # FLAME's shapedirs alone are 24 MB
    assert all(size < 0.05 * weights for name, size in sizes.items()), sizes


def test_cpu_graphs_hold_the_kernel_ops(exported):
    """decode holds the blendshape op, frames the resample op: one node each,
    and no plain-version resample (einsum, arange) in the frames graph."""
    targets = {name: [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
               for name, prog in exported._programs.items()}
    assert targets["decode"].count("dad3d.blend_shapes.default") == 1
    assert targets["frames"].count("dad3d.resample_normalize_u8.default") == 1
    assert not any("einsum" in t or "arange" in t for t in targets["frames"])
    assert not any(t.startswith("dad3d.") for t in targets["pipeline"])


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_refuses_a_device_the_artifact_lacks(artifact):
    with pytest.raises(ValueError, match=r"\['cpu'\].*'cuda'"):
        ExportedFaceMeshPredictor(artifact, device="cuda")
    with pytest.raises(ValueError, match="runs on"):
        export_predictor(None, None, "unused", devices=("tpu",))


def test_refuses_a_newer_format(artifact, tmp_path):
    newer = tmp_path / f"newer{SUFFIX}"
    with zipfile.ZipFile(artifact) as src, zipfile.ZipFile(newer, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), "format_version": 2}).encode()
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="newer than this loader"):
        ExportedFaceMeshPredictor(str(newer), device="cpu")


def test_refuses_int8(checkpoint, live, tmp_path):
    """int8 artifacts cover the resnet50 flagship only: a mobilenet_w1 one is
    refused, through the API and the CLI (tests/test_torch_int8_serve.py
    exports the resnet50's)."""
    from dad3dheads_tpu_torch.cli.export import main

    with pytest.raises(ValueError, match="resnet50"):
        export_predictor(live.model, live.flame, str(tmp_path / "q.aot.zip"), img_size=IMG, devices=("cpu",),
                         quant_amax={"fusion/in": 1.0})
    with pytest.raises(ValueError, match="resnet50"):
        main(["--checkpoint", checkpoint, "--out", str(tmp_path / "q.aot.zip"), "--device", "cpu",
              "--backbone", "mobilenet_w1", "--num-filters", "64", "--img-size", str(IMG),
              "--quant-amax", "amax.npz"])
    assert not os.path.exists(tmp_path / "q.aot.zip")


# --------------------------------------------------------------------------
# the artifact against the JAX package's artifact on the same weights
# --------------------------------------------------------------------------


def test_predict_batch_matches_jax_artifact(exported, jax_exported):
    """3DMM and vertices 1e-4, points 1 px (the frames tests' tolerance);
    measured: 3DMM 2.4e-7, vertices 8.9e-8, points 9.5e-6 px."""
    images = _uint8(11, 2, IMG, IMG, 3)
    got, ref = exported.predict_batch(images), jax_exported.predict_batch(images)
    assert set(got) == set(ref)
    for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1.0), ("projected_vertices", 1.0)):
        assert got[key].shape == ref[key].shape, key
        assert _gap(got[key], ref[key]) <= atol, (key, _gap(got[key], ref[key]))


def test_predict_frames_matches_jax_artifact(exported, jax_exported):
    """One chunk of three frames and face boxes: 3DMM and vertices 1e-4,
    points 1 px (integers after the readjustment); measured: 3DMM 3.6e-7,
    vertices 6.7e-8, points 0."""
    frames = _frames(21)
    got = exported.predict_frames(frames, bboxes=BOXES, batch_size=4)
    ref = jax_exported.predict_frames(frames, bboxes=BOXES, batch_size=4)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1.0)):
            assert _gap(g[key], r[key]) <= atol, (key, _gap(g[key], r[key]))


def test_call_and_predict_images_match_jax_artifact(exported, jax_exported):
    """Host resize, pad and readjustment on both sides: 3DMM and vertices
    1e-4, points 1 px; measured: 3DMM 6.6e-7, vertices 1.4e-7, points 0."""
    images = [_uint8(22 + i, h, w, 3) for i, (h, w) in enumerate([(180, 150), (90, 160), (128, 128)])]
    pairs = [(exported(images[0]), jax_exported(images[0]))]
    pairs += zip(exported.predict_images(images, batch_size=2), jax_exported.predict_images(images, batch_size=2))
    for g, r in pairs:
        assert set(g) == set(r)
        for key, atol in (("3dmm_params", 1e-4), ("3d_vertices", 1e-4), ("points", 1.0)):
            assert g[key].shape == r[key].shape and _gap(g[key], r[key]) <= atol, (key, _gap(g[key], r[key]))
