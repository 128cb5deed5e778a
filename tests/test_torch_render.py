"""The render path of the port against the JAX package.

The rasterizer on CPU tensors (the kernel's plain version) against the JAX
XLA ``rasterize_buffers`` and the Pallas kernel in interpret mode; ``shade``,
``get_normal``, ``calculate_rpy`` and ``HeadMesh``; ``PNCCEstimator`` and
``UVTextureCreator`` against the JAX ones; the demo processors and the demo
CLI end to end on the CPU.

The ``cuda``-marked tests hold the rasterizer kernel against its plain
version on the card and skip without one. JAX is imported only inside the
tests that need it, so that on a machine with a card and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_render.py``.
"""

import json

import numpy as np
import pytest
import torch

from dad3dheads_tpu_torch import assets
from dad3dheads_tpu_torch.core.flame import FlameModel
from dad3dheads_tpu_torch.core.head_mesh import HeadMesh
from dad3dheads_tpu_torch.render.rasterizer import rasterize_buffers, rasterize_buffers_reference


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The tests run beside other test processes: two torch threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def random_triangles(seed=0, n_tris=40, width=127.0):
    """The triangles of the JAX package's Pallas-vs-XLA rasterizer test."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, width, size=(n_tris * 3, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(0, 10, size=n_tris * 3)
    return verts, np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)


def head_params(seed=0, fill=0.6):
    """A 3DMM vector whose mesh fills ``fill`` of the image: seeded shape and
    expression, a small rotation, identity otherwise."""
    rng = np.random.default_rng(seed)
    mm = np.zeros((1, 413), np.float32)
    mm[0, :400] = rng.normal(size=400) * 0.5
    mm[0, 403:409] = [1.0, 0.05, 0.0, -0.05, 1.0, 0.1]
    mm[0, 409:411] = rng.uniform(-0.1, 0.1, size=2)
    extent = np.ptp(assets.load_flame_model().v_template[:, :2], axis=0).max()
    mm[0, 412] = 2.0 * fill / extent - 1.0
    return mm


def flame_screen(size, device="cpu", faces="faces_wo_ears_remapped"):
    """The FLAME mesh projected into a (height, width) image, z flipped, as
    PNCC rasterizes it, and the face subset."""
    h, w = size
    hm = HeadMesh(image_size=max(h, w), device=device)
    verts = hm.reprojected_vertices(torch.from_numpy(head_params()), to_2d=False)[0].clone()
    verts[:, 2] *= -1.0
    return verts.cpu().numpy(), assets.get_flame_indices(faces).astype(np.int32)


def spherical_uv(res):
    from dad3dheads_tpu_torch.render.uv_texture import spherical_uv_vertices

    return spherical_uv_vertices(assets.load_flame_model().v_template, res), assets.get_faces().astype(np.int32)


def constant_depth(res):
    """Overlapping triangles at one depth: every overlap is a tie."""
    verts, faces = random_triangles(seed=5, n_tris=60, width=res - 1.0)
    verts[:, 2] = 1.0
    return verts, faces


def assert_buffers_equal(out, ref, atol=1e-4, near_ties=0.0):
    """Triangle ids identical, depth and barycentrics within atol where
    covered.

    ``near_ties``: the share of covered pixels whose ids may differ, where
    two triangles' depths agree within atol (the depth check below holds
    there too). XLA on the CPU contracts some multiply-adds into FMAs, which
    moves such a depth by an ulp and can flip the winner: on an edge shared
    by two triangles, or anywhere in an overlap at constant depth. The port
    rounds each operation on its own, on the CPU and in the kernel alike."""
    depth, tri_id, bary = (np.asarray(t) for t in out)
    r_depth, r_tri_id, r_bary = (np.asarray(t) for t in ref)
    cov = r_tri_id >= 0
    assert cov.any()
    np.testing.assert_array_equal(tri_id >= 0, cov)
    flipped = tri_id != r_tri_id
    assert flipped.sum() <= near_ties * cov.sum(), (flipped.sum(), cov.sum())
    np.testing.assert_allclose(depth[cov], r_depth[cov], atol=atol)
    same = cov & ~flipped
    np.testing.assert_allclose(bary[same], r_bary[same], atol=atol)
    np.testing.assert_array_equal(depth[~cov], r_depth[~cov])


def port_raster(verts, faces, h, w):
    return [t.numpy() for t in rasterize_buffers(torch.from_numpy(verts), torch.from_numpy(faces), h, w)]


def xla_raster(verts, faces, h, w):
    import jax.numpy as jnp

    from dad3dheads_tpu.render.rasterizer import rasterize_buffers as jax_raster

    tile_rows = 16 if h % 16 == 0 else 1
    return jax_raster(jnp.asarray(verts), jnp.asarray(faces), h, w, tile_rows=tile_rows)


# --------------------------------------------------------------------------
# the rasterizer's plain version against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["triangles_16x128", "flame_64x64", "flame_48x72", "uv_spherical_64", "constant_depth_64"]
)
def test_rasterize_plain_matches_xla(case):
    if case == "triangles_16x128":
        (verts, faces), (h, w) = random_triangles(), (16, 128)
    elif case.startswith("flame"):
        h, w = map(int, case.split("_")[1].split("x"))
        verts, faces = flame_screen((h, w))
    elif case == "uv_spherical_64":
        (verts, faces), (h, w) = spherical_uv(64), (64, 64)
    else:
        (verts, faces), (h, w) = constant_depth(64), (64, 64)
    # at constant depth every overlap is a tie that an ulp decides
    near_ties = 0.15 if case.startswith("constant") else 1e-3
    assert_buffers_equal(port_raster(verts, faces, h, w), xla_raster(verts, faces, h, w), near_ties=near_ties)


def test_rasterize_plain_matches_pallas_interpret():
    """The Pallas kernel sorts faces by tile first, so ties may break apart;
    these triangles have none, and the ids agree."""
    import jax.numpy as jnp

    from dad3dheads_tpu.render.rasterizer_pallas import rasterize_buffers_pallas

    verts, faces = random_triangles()
    ref = rasterize_buffers_pallas(jnp.asarray(verts), jnp.asarray(faces), 16, 128, interpret=True)
    assert_buffers_equal(port_raster(verts, faces, 16, 128), ref)


def test_rasterize_degenerate_and_empty():
    """Zero-area triangles never win; an empty face list leaves the buffers
    at their initial values."""
    verts = np.asarray([[0, 0, 5], [10, 0, 5], [20, 0, 5], [0, 0, 1], [9, 0, 1], [0, 9, 1]], np.float32)
    depth, tri_id, bary = port_raster(verts, np.asarray([[0, 1, 2], [3, 4, 5]], np.int32), 12, 12)
    assert set(np.unique(tri_id)) == {-1, 1}
    depth, tri_id, bary = port_raster(verts, np.zeros((0, 3), np.int32), 5, 7)
    assert (tri_id == -1).all() and (depth == -1e8).all() and (bary == 0).all()


def test_shade_rasterize_and_normals_match_jax():
    import jax.numpy as jnp

    from dad3dheads_tpu.render import rasterizer as jr
    from dad3dheads_tpu_torch.render import rasterizer as tr

    verts, faces = flame_screen((48, 72))
    colors = np.random.default_rng(1).uniform(size=(verts.shape[0], 3)).astype(np.float32)
    bg = np.random.default_rng(2).integers(0, 256, (48, 72, 3), dtype=np.uint8)
    for alpha in (1.0, 0.6):
        ref = np.asarray(jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(colors),
                                      bg=jnp.asarray(bg), alpha=alpha))
        out = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(colors),
                           bg=torch.from_numpy(bg), alpha=alpha).numpy()
        assert out.dtype == np.uint8 and out.shape == bg.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    black = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(colors), height=48, width=72)
    assert black.shape == (48, 72, 3) and black.max() > 0
    ref = np.asarray(jr.get_normal(jnp.asarray(verts), jnp.asarray(faces)))
    out = tr.get_normal(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


# --------------------------------------------------------------------------
# geometry used by the render path
# --------------------------------------------------------------------------


def test_calculate_rpy_matches_jax():
    import jax.numpy as jnp

    from dad3dheads_tpu.core.rotation import calculate_rpy as jax_rpy
    from dad3dheads_tpu_torch.core.rotation import calculate_rpy

    rot6 = np.random.default_rng(3).normal(size=(16, 6)).astype(np.float32)
    rot6[0] = [1, 0, 0, 0, 1, 0]
    ref, out = jax_rpy(jnp.asarray(rot6)), calculate_rpy(torch.from_numpy(rot6))
    for name in ("roll", "pitch", "yaw"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-3)
    one = calculate_rpy(torch.from_numpy(rot6[0]))
    assert one.roll.shape == (1,)


def test_head_mesh_matches_jax():
    import jax.numpy as jnp

    from dad3dheads_tpu.core.head_mesh import HeadMesh as JaxHeadMesh

    mm = np.concatenate([head_params(0), head_params(1)])
    ref, hm = JaxHeadMesh(image_size=96), HeadMesh(image_size=96, device="cpu")
    x, jx = torch.from_numpy(mm), jnp.asarray(mm)
    np.testing.assert_allclose(hm.vertices_3d(x).numpy(), np.asarray(ref.vertices_3d(jx)), atol=1e-5)
    np.testing.assert_allclose(hm.vertices_3d(x, zero_rotation=True).numpy(),
                               np.asarray(ref.vertices_3d(jx, zero_rotation=True)), atol=1e-5)
    for to_2d in (True, False):
        np.testing.assert_allclose(hm.reprojected_vertices(x, to_2d=to_2d).numpy(),
                                   np.asarray(ref.reprojected_vertices(jx, to_2d=to_2d)), atol=1e-3)
    np.testing.assert_allclose(hm.adjust_3dmm_to_paddings(x, [3, 4, -5, 6]).numpy(),
                               np.asarray(ref.adjust_3dmm_to_paddings(jx, [3, 4, -5, 6])), atol=1e-6)


# --------------------------------------------------------------------------
# the renderers against the JAX ones
# --------------------------------------------------------------------------


def test_pncc_matches_jax():
    """Within one uint8 level, with and without the background, on an image
    whose size is not a multiple of a tile."""
    from dad3dheads_tpu.render.pncc import PNCCEstimator as JaxPNCC
    from dad3dheads_tpu_torch.render.pncc import PNCCEstimator

    image = np.random.default_rng(4).integers(0, 256, (72, 100, 3), dtype=np.uint8)
    preds = {"3dmm_params": head_params()}
    ref_est, est = JaxPNCC(), PNCCEstimator(device="cpu")
    np.testing.assert_allclose(est.colors.numpy(), ref_est.colors, atol=1e-6)
    for with_bg in (False, True):
        ref, out = ref_est(image, preds, with_bg), est(image, preds, with_bg)
        assert out.dtype == np.uint8 and out.shape == image.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
        assert (out != image).any()


def two_triangle_layout(n_faces):
    """A UV layout row-aligned with the mesh: two charts on rows 0-1, the
    other rows degenerate."""
    vt = np.array([[0.05, 0.05], [0.45, 0.05], [0.05, 0.95], [0.55, 0.05], [0.95, 0.05], [0.95, 0.95]], np.float32)
    ft = np.zeros((n_faces, 3), np.int64)
    ft[0], ft[1] = [0, 1, 2], [3, 4, 5]
    return vt, ft


@pytest.mark.parametrize("source", ["spherical", "layout_npz", "table_npz", "obj"])
def test_uv_texture_matches_jax(tmp_path, source, monkeypatch):
    """The texel table is identical; the texture within one uint8 level."""
    from dad3dheads_tpu.render.uv_texture import UVTextureCreator as JaxUV
    from dad3dheads_tpu_torch.render.uv_texture import UVTextureCreator

    monkeypatch.delenv("DAD3D_UV_DATA_PATH", raising=False)
    n_faces = len(assets.get_faces())
    vt, ft = two_triangle_layout(n_faces)
    path = None
    if source == "layout_npz":
        path = str(tmp_path / "layout.npz")
        np.savez(path, vt=vt, ft=ft)
    elif source == "table_npz":
        path = str(tmp_path / "table.npz")
        tri_id = np.full((32, 32), -1, np.int32)
        tri_id[4:20, 4:20] = 7
        np.savez(path, tri_id=tri_id, bary=np.full((32, 32, 3), 1 / 3, np.float32))
    elif source == "obj":
        path = str(tmp_path / "layout.obj")
        with open(path, "w") as f:
            f.writelines(f"vt {u} {v}\n" for u, v in vt)
            f.writelines(f"f {i + 1}/{a + 1} {i + 2}/{b + 1} {i + 3}/{c + 1}\n" for i, (a, b, c) in enumerate(ft))
    image = np.random.default_rng(6).integers(0, 256, (80, 64, 3), dtype=np.uint8)
    preds = {"3dmm_params": head_params()}
    ref_uv = JaxUV(resolution=64, uv_data_path=path)
    uv = UVTextureCreator(resolution=64, uv_data_path=path, device="cpu")
    cov = ref_uv.tri_id >= 0
    np.testing.assert_array_equal(uv.tri_id >= 0, cov)
    flipped = uv.tri_id != ref_uv.tri_id  # near ties on shared edges, as in assert_buffers_equal
    assert flipped.sum() <= 1e-3 * cov.sum()
    np.testing.assert_allclose(uv.bary[cov & ~flipped], ref_uv.bary[cov & ~flipped], atol=1e-4)
    ref, out = ref_uv(image, preds), uv(image, preds)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert out.max() > 0


def test_parse_obj_uv_layout_matches_jax(tmp_path):
    from dad3dheads_tpu.render.uv_texture import parse_obj_uv_layout as jax_parse
    from dad3dheads_tpu_torch.render.uv_texture import parse_obj_uv_layout

    good, plain, quad = tmp_path / "a.obj", tmp_path / "b.obj", tmp_path / "c.obj"
    good.write_text("v 0 0 0\nvt 0.1 0.2\nvt 0.3 0.4\nvt 0.5 0.6\nf 1/1 1/2 1/3\n")
    plain.write_text("v 0 0 0\nf 1 1 1\n")
    quad.write_text("vt 0 0\nf 1/1 1/1 1/1 1/1\n")
    for a, b in zip(parse_obj_uv_layout(str(good)), jax_parse(str(good))):
        np.testing.assert_array_equal(a, b)
    assert parse_obj_uv_layout(str(plain)) is None
    with pytest.raises(ValueError, match="triangular"):
        parse_obj_uv_layout(str(quad))


# --------------------------------------------------------------------------
# the demo processors and the demo CLI
# --------------------------------------------------------------------------


def demo_predictions(size=(90, 120)):
    """One prediction dict in the ``__call__`` contract, from the port's
    geometry on seeded 3DMM parameters."""
    mm = head_params()
    hm = HeadMesh(image_size=max(size), device="cpu")
    x = torch.from_numpy(mm)
    proj = hm.reprojected_vertices(x).numpy()
    return {"points": proj[0, :68].astype(int), "projected_vertices": proj,
            "3d_vertices": hm.vertices_3d(x)[0].numpy(), "3dmm_params": mm}


@pytest.mark.parametrize("kind", ["68_landmarks", "191_landmarks", "445_landmarks", "head_mesh", "face_mesh",
                                  "pose", "3d_mesh", "flame_params"])
def test_demo_processors_match_jax(kind):
    """cv2 drawing, mesh and parameter outputs equal the JAX package's."""
    from dad3dheads_tpu.cli.demo import demo_funcs as jax_funcs
    from dad3dheads_tpu_torch.cli.demo import demo_funcs

    preds = demo_predictions()
    image = np.random.default_rng(7).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    out = demo_funcs[kind].processor(preds, image.copy())
    ref = jax_funcs[kind].processor(preds, image.copy())
    assert demo_funcs[kind].saver.extension == jax_funcs[kind].saver.extension
    if isinstance(ref, tuple):
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    elif isinstance(ref, dict):
        assert out == ref
    else:
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("kind", ["pncc", "3d_mesh", "flame_params", "68_landmarks"])
def test_demo_cli(tmp_path, kind):
    import cv2

    from dad3dheads_tpu_torch.cli.demo import main

    src = tmp_path / "head.png"
    cv2.imwrite(str(src), np.random.default_rng(8).integers(0, 256, (96, 80, 3), dtype=np.uint8))
    path = main(["--input", str(src), "--out", str(tmp_path / "out"), "--type", kind,
                 "--device", "cpu", "--allow-random-weights"])
    assert path.endswith({"3d_mesh": ".obj", "flame_params": ".json"}.get(kind, ".png"))
    if kind == "flame_params":
        assert len(json.loads(open(path).read())["expression"]) == 100
    elif kind == "3d_mesh":
        assert sum(line.startswith("f ") for line in open(path)) == 9976
    else:
        img = cv2.imread(path)
        assert img.shape == (96, 80, 3)


# --------------------------------------------------------------------------
# the kernel on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["triangles_16x128", "flame_256x256", "flame_512x640", "uv_spherical_256", "constant_depth_256"]
)
def test_rasterize_kernel_matches_plain(cuda, case):
    """Triangle ids identical on every pixel; depth and barycentrics within
    1e-4 where covered; one launch per call."""
    if case == "triangles_16x128":
        (verts, faces), (h, w) = random_triangles(), (16, 128)
    elif case.startswith("flame"):
        h, w = map(int, case.split("_")[1].split("x"))
        verts, faces = flame_screen((h, w))
    elif case == "uv_spherical_256":
        (verts, faces), (h, w) = spherical_uv(256), (256, 256)
    else:
        (verts, faces), (h, w) = constant_depth(256), (256, 256)
    v, f = torch.from_numpy(verts).to(cuda), torch.from_numpy(faces).to(cuda)
    before = rasterize_buffers.launches
    out = rasterize_buffers(v, f, h, w)
    assert rasterize_buffers.launches == before + 1
    ref = rasterize_buffers_reference(v, f, h, w)
    assert_buffers_equal([t.cpu() for t in out], [t.cpu() for t in ref])


@pytest.mark.cuda
def test_renderers_on_the_card_match_the_cpu(cuda):
    """PNCC and the UV texture rendered on the card against the CPU's
    renderers. The card decodes the head with the 3xTF32 blendshape kernel,
    whose sums are not bit-identical to the CPU's fp32 ones, and a pixel
    centre that close to a triangle edge may fall on the neighbouring
    triangle. So: the two decodes within 1e-3 px; the CPU's renderers
    drawing the card's decode within one uint8 level everywhere; and the
    card's decode and render against the CPU's decode and render within one
    level on all but 0.1% of the values (the limit of ``chip_smoke.py``
    phase 4c), the count printed."""
    image = np.random.default_rng(9).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    preds = {"3dmm_params": head_params()}
    from dad3dheads_tpu_torch.render import PNCCEstimator, UVTextureCreator

    card_mesh = HeadMesh(model=FlameModel.load(device=cuda))
    cpu_mesh = HeadMesh(device="cpu")

    class CardDecode(HeadMesh):
        """The CPU's head mesh, with the vertices the card decodes."""

        def reprojected_vertices(self, params_3dmm, to_2d=True):
            return card_mesh.reprojected_vertices(params_3dmm, to_2d).cpu()

    mm = torch.from_numpy(preds["3dmm_params"])
    for to_2d in (False, True):
        gap = card_mesh.reprojected_vertices(mm, to_2d).cpu() - cpu_mesh.reprojected_vertices(mm, to_2d)
        assert gap.abs().max().item() <= 1e-3
    before = rasterize_buffers.launches
    pncc = PNCCEstimator(card_mesh)(image, preds)
    uv = UVTextureCreator(resolution=128, head_mesh=card_mesh)(image, preds)
    assert rasterize_buffers.launches >= before + 2
    ref_pncc = PNCCEstimator(CardDecode(device="cpu"))(image, preds)
    ref_uv = UVTextureCreator(resolution=128, head_mesh=CardDecode(device="cpu"))(image, preds)
    assert np.abs(pncc.astype(int) - ref_pncc.astype(int)).max() <= 1
    assert np.abs(uv.astype(int) - ref_uv.astype(int)).max() <= 1
    cpu_pncc = PNCCEstimator(device="cpu")(image, preds)
    cpu_uv = UVTextureCreator(resolution=128, device="cpu")(image, preds)
    for name, out, ref in (("pncc", pncc, cpu_pncc), ("uv_texture", uv, cpu_uv)):
        gap = np.abs(out.astype(int) - ref.astype(int))
        far = int((gap > 1).sum())
        print(f"{name}: {far} of {gap.size} values differ from the CPU's decode and render by more than one "
              f"level (max {gap.max()})")
        assert far <= 1e-3 * gap.size, (name, far)
