"""The port's dataset generator (``cli/make_dataset.py``) and its lighting
(``render/lighting.py``) against the JAX package on the CPU.

The generator's random part cannot match: the JAX tool draws its 3DMM
vectors from ``jax.random``. So for three fixed 3DMM vectors the test runs
the JAX tool's arithmetic inline with ``dad3dheads_tpu`` functions (decode,
world and screen vertices, ``RenderPipeline`` on the XLA rasterizer, the
model-view and projection matrices, the bbox) and holds the port's
``render_sample`` to it: the annotation and bbox within 1e-5, the image
within one uint8 level on all but 0.1% of its values, the limit the render
tests use. The CLI writes the JAX tool's on-disk layout.
"""

import json
import os

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import assets
from dad3dheads_tpu_torch.cli.make_dataset import main as make_dataset_main
from dad3dheads_tpu_torch.cli.make_dataset import render_sample
from dad3dheads_tpu_torch.core.flame import FlameModel
from dad3dheads_tpu_torch.data.synthetic import random_3dmm
from dad3dheads_tpu_torch.render.lighting import RenderPipeline, norm_vertices

S = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _screen_head(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(5023, 3)) * [9.0, 11.0, 7.0] + [32.0, 30.0, 0.0]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_lighting_matches_the_jax_packages(seed):
    """norm_vertices and compute_light within 1e-6, for the default and a
    moved light; __call__ renders within one level on all but 0.1%."""
    import jax.numpy as jnp

    from dad3dheads_tpu.render import lighting as jl

    faces = assets.get_faces().astype(np.int32)
    v = _screen_head(seed)
    np.testing.assert_allclose(norm_vertices(torch.from_numpy(v)).numpy(), np.asarray(jl.norm_vertices(jnp.asarray(v))),
                               atol=1e-6)
    port, ref = RenderPipeline(), jl.RenderPipeline()
    for light_pos in (None, (1.0, -2.0, 4.0)):
        if light_pos is not None:
            port.update_light_pos(light_pos)
            ref.update_light_pos(light_pos)
        a = port.compute_light(torch.from_numpy(v), torch.from_numpy(faces)).numpy()
        b = np.asarray(ref.compute_light(jnp.asarray(v), jnp.asarray(faces)))
        assert a.shape == (5023, 3) and a.min() >= 0 and a.max() <= 1
        np.testing.assert_allclose(a, b, atol=1e-6)
    bg = np.full((S, S, 3), 32, np.uint8)
    img = port(torch.from_numpy(v), torch.from_numpy(faces), torch.from_numpy(bg)).numpy()
    ref_img = np.asarray(ref(jnp.asarray(v), jnp.asarray(faces), jnp.asarray(bg)))
    gap = np.abs(img.astype(int) - ref_img.astype(int))
    assert (img != 32).any() and (gap > 1).sum() <= 1e-3 * gap.size


def _jax_tool_sample(mm: np.ndarray, img_size: int):
    """``tools/make_synthetic_dataset.py``'s per-sample arithmetic (its XLA
    render path), with the JAX package's functions."""
    import jax
    import jax.numpy as jnp

    from dad3dheads_tpu import assets as jassets
    from dad3dheads_tpu.core.flame import FlameModel as JaxFlame
    from dad3dheads_tpu.core.flame import FlameParams, flame_decode
    from dad3dheads_tpu.core.rotation import rot_mat_from_6dof
    from dad3dheads_tpu.render.lighting import RenderPipeline as JaxPipeline

    S = img_size
    params = FlameParams.from_3dmm(jnp.asarray(mm))
    v0 = flame_decode(JaxFlame.load(), params, zero_rot=True)
    R = rot_mat_from_6dof(params.rotation)
    scale = jnp.clip(params.scale[:, None] + 1.0, min=1e-8)
    t = params.translation.at[..., 2].set(0.0)
    world = jnp.einsum("bxy,bvy->bvx", R, v0) * scale + t[:, None]
    v0, world, R, scale = jax.device_get((v0, world, R, scale))
    v0, world, R, scale = v0[0], world[0], R[0], float(scale[0, 0, 0])
    screen = np.empty_like(world)
    screen[:, 0] = (world[:, 0] + 1.0) / 2.0 * S
    screen[:, 1] = (world[:, 1] + 1.0) / 2.0 * S
    screen[:, 2] = world[:, 2]
    faces = jassets.get_faces().astype(np.int32)
    bg = jnp.asarray(np.full((S, S, 3), 32, np.uint8))
    img = np.asarray(JaxPipeline()(jnp.asarray(screen), jnp.asarray(faces), bg))
    mv = np.eye(4, dtype=np.float32)
    mv[:3, :3] = R
    mv[:3, 3] = [float(mm[0, 409]) / scale, float(mm[0, 410]) / scale, 0.0]
    proj = np.array([[scale * S / 2, 0, 0, S / 2], [0, -scale * S / 2, 0, S / 2], [0, 0, 1, 0], [0, 0, 0, 1]],
                    np.float32)
    xs, ys = screen[:, 0], screen[:, 1]
    x0, y0 = float(max(xs.min(), 0)), float(max(ys.min(), 0))
    x1, y1 = float(min(xs.max(), S - 1)), float(min(ys.max(), S - 1))
    annotation = {"vertices": v0.tolist(), "model_view_matrix": mv.tolist(), "projection_matrix": proj.tolist()}
    return img, annotation, [int(x0), int(y0), int(x1 - x0), int(y1 - y0)]


def test_render_sample_matches_the_jax_tools_arithmetic():
    flame = FlameModel.load()
    faces = torch.as_tensor(assets.get_faces().astype(np.int32))
    vectors = random_3dmm(torch.Generator().manual_seed(7), 3)
    vectors[2, 409:411] = torch.tensor([0.3, -0.25])  # a head off the image's centre
    for i in range(3):
        mm = vectors[i : i + 1]
        img, annotation, bbox = render_sample(mm, flame, faces, RenderPipeline(), S)
        ref_img, ref_annotation, ref_bbox = _jax_tool_sample(mm.numpy(), S)
        assert img.dtype == np.uint8 and img.shape == (S, S, 3)
        assert set(annotation) == set(ref_annotation)
        for key, value in ref_annotation.items():
            np.testing.assert_allclose(np.asarray(annotation[key]), np.asarray(value), atol=1e-5, err_msg=key)
        np.testing.assert_allclose(bbox, ref_bbox, atol=1e-5)
        gap = np.abs(img.astype(int) - ref_img.astype(int))
        assert (gap > 1).sum() <= 1e-3 * gap.size, (i, int((gap > 1).sum()))
        assert (img != 32).any(-1).sum() > 100  # the head is drawn


def test_cli_writes_the_jax_tools_layout(tmp_path):
    out = str(tmp_path)
    make_dataset_main(["--out", out, "--subset", "train", "--num", "2", "--img-size", str(S), "--seed", "3",
                       "--with-attributes", "--device", "cpu"])
    base = os.path.join(out, "DAD-3DHeadsDataset", "train")
    index = json.load(open(os.path.join(base, "train.json")))
    assert [e["item_id"] for e in index] == ["synth_train_00000", "synth_train_00001"]
    import cv2

    for e in index:
        assert set(e) == {"item_id", "img_path", "annotation_path", "bbox", "attributes"}
        assert e["img_path"] == f"images/{e['item_id']}.png"
        assert e["attributes"] == {"quality": "good", "gender": "synthetic"}
        img = cv2.imread(os.path.join(base, e["img_path"]))
        assert img.shape == (S, S, 3)
        ann = json.load(open(os.path.join(base, e["annotation_path"])))
        assert np.asarray(ann["vertices"]).shape == (5023, 3)
        mv = np.asarray(ann["model_view_matrix"])
        np.testing.assert_allclose(mv[:3, :3] @ mv[:3, :3].T, np.eye(3), atol=1e-5)  # orthonormal
        x, y, w, h = e["bbox"]
        assert 0 <= x and 0 <= y and 0 < w and 0 < h and x + w <= S and y + h <= S
    # the seed decides the data
    again = str(tmp_path / "again")
    make_dataset_main(["--out", again, "--subset", "train", "--num", "2", "--img-size", str(S), "--seed", "3",
                       "--device", "cpu"])
    assert [e["bbox"] for e in json.load(open(os.path.join(again, "DAD-3DHeadsDataset", "train", "train.json")))] == [
        e["bbox"] for e in index]
