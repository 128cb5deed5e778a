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


def soup(seed, n_tris, lo, hi, z=None):
    """n_tris triangles with corners uniform in [lo, hi)^2: depth uniform in
    [0, 10), or the constant z."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(lo, hi, (3 * n_tris, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(0, 10, 3 * n_tris) if z is None else z
    return verts, np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)


def sliver_tips(seed, n_tris, size):
    """Slivers whose computed area is mostly rounding, each pointing 2-40 px
    past its tip at a pixel within 3e-5 px of its long edge's line: there
    fp32 can pass the inside test outside the 1 px + 1e-3 box."""
    rng = np.random.default_rng(seed)
    pixel = rng.integers(0, size, (n_tris, 2)).astype(np.float64)
    phi = rng.uniform(0, 2 * np.pi, n_tris)
    along = np.stack([np.cos(phi), np.sin(phi)], 1)
    normal = np.stack([-along[:, 1], along[:, 0]], 1)
    length = rng.uniform(40, 200, (n_tris, 1))
    tip = pixel - rng.uniform(2, 40, (n_tris, 1)) * along + rng.uniform(-3e-5, 3e-5, (n_tris, 1)) * normal
    base = tip - length * along
    apex = base + rng.uniform(0, 1, (n_tris, 1)) * length * along + 10.0 ** rng.uniform(-7, -4.5, (n_tris, 1)) * normal
    verts = np.concatenate([np.stack([base, tip, apex], 1), rng.uniform(0, 10, (n_tris, 3, 1))], 2)
    return verts.reshape(-1, 3).astype(np.float32), np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)


def adversarial(case, size):
    """The meshes that stress the kernel's per-tile lists, on a size x size
    image (ragged: size - 14 x size - 3): (verts, faces, h, w)."""
    if case == "overflow_constant_depth":  # every tile's list past a batch and a slice, all ties
        return (*soup(10, 600 if size <= 64 else 4500, -size // 4, size + size // 4, z=1.0), size, size)
    if case == "overflow":
        return (*soup(11, 600, -size // 4, size + size // 4), size, size)
    if case == "off_image":  # partly off the image, negative coordinates
        return (*soup(12, 80, -size, size * 5 // 8), size, size)
    if case == "whole_image":  # one triangle over the whole image, under others
        verts, faces = soup(13, 20, 0, size - 1)
        big = np.asarray([[-5 * size, -5 * size, 0.5], [11 * size, -5 * size, 0.5], [-5 * size, 11 * size, 0.5]],
                         np.float32)
        return np.concatenate([big, verts]), np.concatenate([[[0, 1, 2]], faces + 3]).astype(np.int32), size, size
    if case == "ragged":  # no side a multiple of a tile; a face count no multiple of a slice
        return (*soup(14, 70 if size <= 64 else 1031, -5, size + 5), size - 14, size - 3)
    if case == "empty":
        return soup(15, 1, 0, 1)[0], np.zeros((0, 3), np.int32), size, size
    if case == "sliver_tips":  # pixels inside slivers outside their 1 px + 1e-3 box
        return (*sliver_tips(19, 500 if size <= 64 else 2000, size), size, size)
    raise KeyError(case)


ADVERSARIAL = ("overflow_constant_depth", "overflow", "off_image", "whole_image", "ragged", "empty", "sliver_tips")


def assert_buffers_equal(out, ref, atol=1e-4, near_ties=0.0, covered=True):
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
    assert cov.any() == covered
    np.testing.assert_array_equal(tri_id >= 0, cov)
    flipped = tri_id != r_tri_id
    assert flipped.sum() <= near_ties * cov.sum(), (flipped.sum(), cov.sum())
    np.testing.assert_allclose(depth[cov], r_depth[cov], atol=atol)
    same = cov & ~flipped
    np.testing.assert_allclose(bary[same], r_bary[same], atol=atol)
    np.testing.assert_array_equal(depth[~cov], r_depth[~cov])


def assert_flips_are_ties(verts, faces, out, ref):
    """Where the ids differ, the reference's winner passes the port's inside
    test at that pixel with a z within an ulp of the port's winning z, and
    the two depths agree within an ulp: each flip is a tie that rounding
    decided."""
    depth, tri_id = np.asarray(out[0]), np.asarray(out[1])
    r_depth, r_tri_id = np.asarray(ref[0]), np.asarray(ref[1])
    y, x = np.nonzero(tri_id != r_tri_id)
    tri = verts[faces[r_tri_id[y, x]]]
    px, py = x.astype(np.float32), y.astype(np.float32)
    (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = (tri[:, k].T for k in range(3))
    inv_area = np.float32(1) / ((x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0))
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
    w2 = np.float32(1) - w0 - w1
    z = w0 * z0 + w1 * z1 + w2 * z2
    ulp = np.spacing(np.abs(depth[y, x]))
    assert np.all((w0 >= -1e-5) & (w1 >= -1e-5) & (w2 >= -1e-5))
    assert np.all(np.abs(z - depth[y, x]) <= ulp), np.abs(z - depth[y, x]).max()
    assert np.all(np.abs(r_depth[y, x] - depth[y, x]) <= ulp)


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


@pytest.mark.parametrize("case", [c for c in ADVERSARIAL if c != "sliver_tips"])
def test_rasterize_plain_matches_xla_adversarial(case):
    """The kernel's stress meshes at 64². Under 600 triangles of one depth
    every pixel is a tie that an ulp of XLA's FMA contraction decides, so
    there ids may differ, but only where the two winners' depths tie within
    an ulp. (The sliver tips are held against every pair evaluated instead:
    the pixels they cover are rounding, which XLA's contraction decides
    otherwise on 2 of 4,096 pixels.)"""
    verts, faces, h, w = adversarial(case, 64)
    out, ref = port_raster(verts, faces, h, w), xla_raster(verts, faces, h, w)
    near_ties = 0.6 if case == "overflow_constant_depth" else 1e-3  # 54.2% flip there
    assert_buffers_equal(out, ref, near_ties=near_ties, covered=case != "empty")
    assert_flips_are_ties(verts, faces, out, ref)


def non_finite_mesh(case, size):
    """1,100 triangles over a size x size image, two of XLA's chunks of 1,024:
    chunk 0 in front (z in [5, 10)) all over the image, chunk 1 behind (z in
    [0, 5)) over its left half, and triangle 3 (chunk 0) over most of the
    image with a corner made non-finite: z = NaN ("nan_z") or x = inf
    ("inf_x"). Returns (verts, faces, h, w, 3)."""
    verts, faces = soup(40, 1100, -size // 8, size + size // 8)
    rng = np.random.default_rng(41)
    n0, n1 = 3 * 1024, verts.shape[0] - 3 * 1024
    verts[:n0, 2] = rng.uniform(5, 10, n0)
    verts[n0:, 0] = rng.uniform(-size // 8, size // 2, n1)
    verts[n0:, 2] = rng.uniform(0, 5, n1)
    verts[9:12] = np.asarray([[0.05, 0.05, 7.0], [0.95, 0.1, 7.0], [0.45, 0.95, 7.0]], np.float32) * [size, size, 1]
    if case == "nan_z":
        verts[10, 2] = np.nan
    elif case == "inf_x":
        verts[10, 0] = np.inf
    else:
        raise KeyError(case)
    return verts, faces, size, size, 3


def without_triangle(raster, verts, faces, h, w, k):
    """``raster`` on the mesh with triangle k removed, its ids mapped back to
    the whole mesh's."""
    depth, tri_id, bary = raster(verts, np.delete(faces, k, 0), h, w)
    return depth, np.where(tri_id >= k, tri_id + 1, tri_id), bary


@pytest.mark.parametrize("case", ["nan_z", "inf_x"])
def test_rasterize_plain_matches_xla_on_non_finite_vertices(case):
    """The plain version keeps XLA's rule on a non-finite vertex, with the
    tie allowance of the other meshes. A NaN z voids the winner of the NaN
    triangle's chunk of 1,024 wherever that triangle covers a pixel (there
    chunk 1's triangles behind it, or nothing, show), so the result parts
    from the mesh without that triangle; an infinite x corner passes the
    inside test nowhere, so it leaves the result as that triangle's removal
    does. (The kernel skips the NaN triangle alone:
    test_rasterize_kernel_on_non_finite_vertices.)"""
    verts, faces, h, w, k = non_finite_mesh(case, 64)
    out, ref = port_raster(verts, faces, h, w), xla_raster(verts, faces, h, w)
    assert_buffers_equal(out, ref, near_ties=1e-3)
    assert_flips_are_ties(verts, faces, out, ref)
    removed = without_triangle(port_raster, verts, faces, h, w, k)
    voided = out[1] != removed[1]
    if case == "nan_z":
        # every voided pixel shows chunk 1's winner or nothing, in both versions
        assert voided.sum() > 0.1 * h * w
        assert np.all((out[1][voided] >= 1024) | (out[1][voided] == -1))
        assert np.any(out[1][voided] == -1) and np.any(out[1][voided] >= 1024)
    else:
        assert not voided.any()
        for a, b in zip(out, removed):
            np.testing.assert_array_equal(a, b)


def unculled_raster(verts, faces, h, w):
    """The plain version's arithmetic on every (pixel, triangle) pair, in the
    caller's order, strict z > best: no box, no strips."""
    tri = torch.from_numpy(verts)[torch.from_numpy(faces).long()]
    (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = (tri[:, k].unbind(-1) for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ok = torch.abs(area) > 1e-12
    inv_area = torch.where(ok, 1.0 / area, torch.zeros_like(area))
    px, py = torch.arange(w, dtype=torch.float32)[None, :], torch.arange(h, dtype=torch.float32)[:, None]
    depth, tri_id, bary = torch.full((h, w), -1e8), torch.full((h, w), -1, dtype=torch.int32), torch.zeros((h, w, 3))
    for t in torch.nonzero(ok).flatten().tolist():
        w0 = ((x1[t] - px) * (y2[t] - py) - (x2[t] - px) * (y1[t] - py)) * inv_area[t]
        w1 = ((x2[t] - px) * (y0[t] - py) - (x0[t] - px) * (y2[t] - py)) * inv_area[t]
        w2 = 1.0 - w0 - w1
        z = w0 * z0[t] + w1 * z1[t] + w2 * z2[t]
        take = (w0 >= -1e-5) & (w1 >= -1e-5) & (w2 >= -1e-5) & (z > depth)
        depth = torch.where(take, z, depth)
        tri_id = torch.where(take, torch.tensor(t, dtype=torch.int32), tri_id)
        bary = torch.where(take[..., None], torch.stack([w0, w1, w2], -1), bary)
    return depth.numpy(), tri_id.numpy(), bary.numpy()


@pytest.mark.parametrize("case", ["sliver_tips", "overflow", "whole_image", "ragged"])
def test_rasterize_box_cull_is_sound(case):
    """The plain version tests a triangle only in the strips its widened box
    meets, and the kernel only at the pixels inside that box. Against every
    pair evaluated (same arithmetic, no culling), the buffers are equal on
    every pixel. The sliver tips hold winning pixels outside the 1 px + 1e-3
    box, which only the whole-image box of box_margin keeps."""
    verts, faces, h, w = adversarial(case, 64)
    ref = unculled_raster(verts, faces, h, w)
    for a, b in zip(port_raster(verts, faces, h, w), ref):
        np.testing.assert_array_equal(a, b)
    if case == "sliver_tips":
        tri = verts[faces]
        lo, hi = tri[:, :, :2].min(1), tri[:, :, :2].max(1)
        margin = 1.0 + 1e-3 * (hi - lo).max(1, keepdims=True)
        won = ref[1][ref[1] >= 0]
        yx = np.argwhere(ref[1] >= 0)
        beyond = np.any((yx[:, ::-1] < lo[won] - margin[won]) | (yx[:, ::-1] > hi[won] + margin[won]), axis=1)
        assert beyond.sum() >= 3, beyond.sum()


def merge_key(z, ids):
    """The kernel's merge key (csrc/rasterize.cu::merge_key) in numpy: z as an
    order-preserving unsigned, -0 folded into +0, above ~id."""
    u = (np.asarray(z, np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (~np.asarray(ids, np.int64) & 0xFFFFFFFF).astype(np.uint64)


@pytest.mark.parametrize("case", ["constant_depth", "signed_zero"])
def test_rasterize_slice_merge_equals_ordered_scan(case):
    """The kernel rasterizes slices of the caller's order apart and keeps, per
    pixel, the largest merge key (larger z, then lower id). On ties at one
    depth, and between -0 and +0, that picks the triangle the ordered strict
    z > best scan picks: the plain version over slices of 7 triangles, merged
    so, equals the plain version over all of them."""
    if case == "constant_depth":
        verts, faces = soup(16, 40, -8, 40, z=1.0)
    else:  # overlapping triangles at -0 and +0, in both orders
        verts, faces = soup(17, 40, -8, 40, z=0.0)
        verts[faces[::2].ravel(), 2] = -0.0
    h, w = 32, 37
    ref = port_raster(verts, faces, h, w)
    best = np.zeros((h, w), np.uint64)
    for lo in range(0, len(faces), 7):
        depth, tri_id, _ = port_raster(verts, faces[lo : lo + 7], h, w)
        hit = tri_id >= 0
        best = np.where(hit, np.maximum(best, merge_key(depth, np.where(hit, tri_id + lo, 0))), best)
    ids = np.where(best > 0, ~(best & np.uint64(0xFFFFFFFF)).astype(np.int64) & 0xFFFFFFFF, -1)
    assert (ref[1] >= 0).sum() > 100 and len(np.unique(ref[1])) > 10
    np.testing.assert_array_equal(ids, ref[1])


def test_rasterize_region_cull_is_sound():
    """The kernel skips a triangle for a warp's 16x8 pixels when an edge
    function lies below -margin at the region's four corners
    (csrc/rasterize.cu region_outside, mirrored here in numpy fp32). On
    random triangles near the region, slivers and coarse floats among them,
    and on triangles with an edge within the tolerance of the region's
    corner, no skipped region holds a pixel that passes the kernel's inside
    test. (Without the margin's rounding term, or with its tolerance term
    cut to half the 1e-5 tolerance, regions holding such a pixel are skipped.)"""
    f32, eps = np.float32, np.float32(1e-5)
    rng = np.random.default_rng(18)
    n = 40000
    kind = rng.integers(0, 4, n)[:, None]
    a = rng.uniform(-40, 80, (n, 2))
    d1 = rng.normal(size=(n, 2)) * np.where(kind == 0, 30, np.where(kind == 1, 300, 5))
    d2 = d1 * rng.uniform(0, 1, (n, 1)) + rng.normal(size=(n, 2)) * 10.0 ** rng.uniform(-7, 1, (n, 1))
    v = np.stack([a, a + d1, a + d2], 1)
    corner = v[np.arange(n), rng.integers(0, 3, n)]
    rx0 = np.floor(corner[:, 0] + rng.integers(-20, 5, n))
    ry0 = np.floor(corner[:, 1] + rng.integers(-10, 3, n))
    # and triangles with one edge within the -1e-5 tolerance of the region's
    # last pixel c, the region wholly on the edge's outer side: c passes the
    # inside test with a weight in (-2e-5, 0), so only the margin keeps the
    # region (edge 0, 1 or 2 by the order of the corners)
    m = n // 2
    phi = rng.uniform(0.2, 1.4, m)
    normal = np.stack([np.cos(phi), np.sin(phi)], 1)  # into the triangle, away from the region
    along, half = np.stack([-normal[:, 1], normal[:, 0]], 1), rng.uniform(20, 200, (m, 1))
    c = np.floor(rng.uniform(-40, 80, (m, 2)))
    apex = np.where(rng.uniform(size=(m, 1)) < 0.5, half, 10.0 ** rng.uniform(-3, 0, (m, 1)))  # or slivers
    offset = rng.uniform(0, 2e-5, (m, 1)) * apex  # c's weight is -offset / apex
    tri = np.stack([c + apex * normal, c + half * along + offset * normal, c - half * along + offset * normal], 1)
    order = rng.integers(0, 3, m)
    tri = np.stack([np.roll(t, k, axis=0) for t, k in zip(tri, order)])
    v = np.concatenate([v, tri]).astype(f32)
    rx0, ry0 = np.concatenate([rx0, c[:, 0] - 15]).astype(f32), np.concatenate([ry0, c[:, 1] - 7]).astype(f32)
    v[np.concatenate([kind[:, 0] == 3, np.zeros(m, bool)])] += f32(3e4)
    rx0[: n][kind[:, 0] == 3] += f32(3e4)
    ry0[: n][kind[:, 0] == 3] += f32(3e4)
    n += m
    x0, y0, x1, y1, x2, y2 = (v[:, k // 2, k % 2] for k in range(6))
    with np.errstate(all="ignore"):
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        ok = np.abs(area) > f32(1e-12)
        inv = np.where(ok, f32(1) / area, f32(0)).astype(f32)
        s = np.where(area > 0, f32(1), f32(-1)).astype(f32)
        X = [np.stack([xk - rx0, xk - (rx0 + f32(15))]) for xk in (x0, x1, x2)]
        Y = [np.stack([yk - ry0, yk - (ry0 + f32(7))]) for yk in (y0, y1, y2)]
        mx = [np.abs(t).max(0) for t in X]
        my = [np.abs(t).max(0) for t in Y]
        ma = np.abs((x1 - x0) * (y2 - y0)) + np.abs((x2 - x0) * (y1 - y0))
        margin = f32(2) * eps * np.abs(area) + f32(2.0**-19) * (
            mx[1] * my[2] + mx[2] * my[1] + mx[2] * my[0] + mx[0] * my[2] + mx[0] * my[1] + mx[1] * my[0] + ma)

        def edge_max(xa, yb, xc, yd):
            return np.max([s * (xa[i] * yb[j] - xc[i] * yd[j]) for i in range(2) for j in range(2)], axis=0)

        culled = ok & np.isfinite(area) & ((edge_max(X[1], Y[2], X[2], Y[1]) < -margin)
                                           | (edge_max(X[2], Y[0], X[0], Y[2]) < -margin)
                                           | (edge_max(X[0], Y[1], X[1], Y[0]) < -margin))
        inside_culled = 0
        for dy in range(8):
            for dx in range(16):
                px, py = rx0 + f32(dx), ry0 + f32(dy)
                w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv
                w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv
                w2 = (f32(1) - w0) - w1
                inside = ok & (w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
                inside_culled += int((culled & inside).sum())
        near_inside = inside[n - m :].sum()  # at c = (rx0 + 15, ry0 + 7), the loops' last pixel
    assert culled.sum() > n // 10
    assert inside_culled == 0
    assert int(near_inside) > m // 4  # the constructed triangles put c inside, by a hair


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
    "case",
    ["triangles_16x128", "flame_256x256", "flame_512x640", "uv_spherical_256", "constant_depth_256",
     *(f"{c}_256" for c in ADVERSARIAL)],
)
def test_rasterize_kernel_matches_plain(cuda, case):
    """Triangle ids identical on every pixel; depth and barycentrics within
    1e-4 everywhere (expected: equal); the same bits on a second launch; one
    launch per call."""
    if case == "triangles_16x128":
        (verts, faces), (h, w) = random_triangles(), (16, 128)
    elif case.startswith("flame"):
        h, w = map(int, case.split("_")[1].split("x"))
        verts, faces = flame_screen((h, w))
    elif case == "uv_spherical_256":
        (verts, faces), (h, w) = spherical_uv(256), (256, 256)
    elif case == "constant_depth_256":
        (verts, faces), (h, w) = constant_depth(256), (256, 256)
    else:
        verts, faces, h, w = adversarial(case[: -len("_256")], 256)
    v, f = torch.from_numpy(verts).to(cuda), torch.from_numpy(faces).to(cuda)
    before = rasterize_buffers.launches
    out = rasterize_buffers(v, f, h, w)
    assert rasterize_buffers.launches == before + 1
    again = rasterize_buffers(v, f, h, w)
    ref = rasterize_buffers_reference(v, f, h, w)
    assert_buffers_equal([t.cpu() for t in out], [t.cpu() for t in ref], covered=len(faces) > 0)
    for a, b, r in zip(out, again, ref):
        assert a.shape == r.shape and (a.double() - r.double()).abs().max().item() <= 1e-4
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan_z", "inf_x"])
@pytest.mark.parametrize("size", [64, 256])
def test_rasterize_kernel_on_non_finite_vertices(cuda, case, size):
    """The kernel's rule, its one departure from the plain version: a
    triangle with a NaN z is skipped alone, so the kernel equals the plain
    version on the mesh without that triangle, bit for bit (where the plain
    version voids the NaN triangle's chunk instead); on an infinite x corner
    it equals the plain version on the mesh itself, bit for bit."""
    verts, faces, h, w, k = non_finite_mesh(case, size)
    v, f = torch.from_numpy(verts).to(cuda), torch.from_numpy(faces).to(cuda)
    out = [t.cpu().numpy() for t in rasterize_buffers(v, f, h, w)]

    def plain(vs, fs, hh, ww):
        return [t.cpu().numpy() for t in rasterize_buffers_reference(torch.from_numpy(vs).to(cuda),
                                                                     torch.from_numpy(fs).to(cuda), hh, ww)]

    ref = without_triangle(plain, verts, faces, h, w, k) if case == "nan_z" else plain(verts, faces, h, w)
    assert (ref[1] >= 0).any()
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    if case == "nan_z":
        assert (plain(verts, faces, h, w)[1] != out[1]).any()


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
