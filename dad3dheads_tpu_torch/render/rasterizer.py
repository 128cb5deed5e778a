"""Mesh rasterizer: z-buffer depth / triangle-id / barycentric buffers, vertex
colour shading and vertex normals. Port of ``dad3dheads_tpu/render/rasterizer.py``
and of the TPU kernel ``rasterize_buffers_pallas``.

:func:`rasterize_buffers` calls the ``torch.library`` custom operator
``dad3d::rasterize`` (registered when this module is imported): on CUDA
tensors it launches the hand-written kernel of ``csrc/rasterize.cu``; on CPU
tensors it runs :func:`rasterize_buffers_reference`, the plain PyTorch
version; its fake implementation gives a trace the buffers' shapes. There is
no other dispatch. Both keep the JAX package's XLA semantics: depth starts at
-1e8 and id at -1, a pixel at integer coordinates (x, y) is inside when its
three barycentric weights are >= -1e-5, triangles of |doubled area| <= 1e-12
are rejected, the largest z wins (callers flip z for a camera looking down
-z) and, on an exact tie, the lowest triangle index. Both skip only pairs
that cannot pass the inside test: those outside the triangle's widened box
(:func:`box_margin`).

The kernel's one departure is a NaN z. There the XLA version lets the NaN
void the winner of its whole chunk of 1,024 triangles of the caller's order
at that pixel (``argmax`` picks the NaN, which then loses to the running
best), and so does the plain version (``torch.max`` over the same chunks);
the kernel skips the NaN triangle alone. The reference has no single rule to
copy: its Pallas kernel voids chunks of 128 taken after a sort by tile, which
are other chunks. A triangle with a non-finite x or y corner passes the
inside test nowhere (a weight is NaN at every pixel), on every path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import cuda_lib

ZBUF_INIT = -1e8
_EPS = 1e-5
_MIN_AREA = 1e-12
_MARGIN_PX, _MARGIN_REL = 1.0, 1e-3
_U = 2.0**-24  # fp32's unit roundoff
_MAX_SIDE = 32767  # the kernel keeps pixel bounds in 16 bits


def _corners(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    return vertices.float()[faces.long()]  # (T, 3 corners, 3 xyz)


def box_margin(lo_x, hi_x, lo_y, hi_y, area, height: int, width: int) -> torch.Tensor:
    """How far past its box (lo_x..hi_x, lo_y..hi_y) a triangle of doubled
    area ``area`` is tested on a height x width image, so that no pixel
    beyond passes the inside test (``csrc/rasterize.cu`` computes the same).

    A pixel d past the box has an exact weight <= -d / (2E), E the extent.
    Evaluated as the inside test does, a weight errs by less than
    31u (E + d)^2 / |area| plus the area's relative error 8u E^2 / |area|
    (u = 2^-24). Where d / (2E) exceeds twice those and twice the 1e-5
    tolerance, the pixel fails the test. Twice the error is concave in d, so
    that holds on the interval between the quadratic's roots: the margin is
    1 px + 1e-3 E, or the smaller root where that is larger (long thin
    triangles), and infinity (the whole image) unless both the margin, less
    the box's own rounding, and the image's farthest pixel lie inside the
    interval (slivers whose computed area is mostly rounding)."""
    extent = torch.maximum(hi_x - lo_x, hi_y - lo_y)
    a = torch.abs(area)
    tol = 2 * _EPS + 16 * _U * extent * extent / a
    k = 64 * _U / a

    def clear(d):
        return d / (2 * extent) > tol + k * (extent + d) * (extent + d)

    # d / (2E) = tol + k (E + d)^2 in s = E + d: k s^2 - s / (2E) + 1/2 + tol = 0
    b = 0.5 / extent
    root = (1 + 2 * tol) / (b + torch.sqrt(torch.clamp(b * b - 4 * k * (0.5 + tol), min=0))) - extent
    margin = torch.maximum(_MARGIN_PX + _MARGIN_REL * extent, 1.0625 * root)
    coord = torch.maximum(torch.maximum(lo_x.abs(), hi_x.abs()), torch.maximum(lo_y.abs(), hi_y.abs()))
    near = margin - 4 * _U * (coord + margin)
    far = torch.maximum(torch.maximum(lo_x, (width - 1) - hi_x), torch.maximum(lo_y, (height - 1) - hi_y)) + 1
    sound = (16 * _U * extent * extent <= 0.125 * a) & ((far <= near) | (clear(near) & clear(far)))
    return torch.where(sound, margin, torch.full_like(margin, float("inf")))


def rasterize_buffers_reference(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    height: int,
    width: int,
    tile_rows: int = 32,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: for each strip of ``tile_rows`` rows, the
    triangles whose widened box meets the strip, in the caller's order and
    grouped by the XLA version's chunks (triangles ``[c * chunk, (c + 1) *
    chunk)``), each group evaluated for every pixel of the strip at once, with
    a running per-pixel maximum. The edge functions follow the XLA expression
    order. Returns depth (H, W) fp32, tri_id (H, W) int32, bary (H, W, 3)."""
    dev = vertices.device
    tri = _corners(vertices, faces)
    x0, y0, z0 = tri[:, 0, 0], tri[:, 0, 1], tri[:, 0, 2]
    x1, y1, z1 = tri[:, 1, 0], tri[:, 1, 1], tri[:, 1, 2]
    x2, y2, z2 = tri[:, 2, 0], tri[:, 2, 1], tri[:, 2, 2]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ok = torch.abs(area) > _MIN_AREA
    inv_area = torch.where(ok, 1.0 / area, torch.zeros_like(area))
    lo_x, hi_x = tri[:, :, 0].min(dim=1).values, tri[:, :, 0].max(dim=1).values
    lo_y, hi_y = tri[:, :, 1].min(dim=1).values, tri[:, :, 1].max(dim=1).values
    margin = box_margin(lo_x, hi_x, lo_y, hi_y, area, height, width)

    depth = torch.full((height, width), ZBUF_INIT, dtype=torch.float32, device=dev)
    tri_id = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    for row0 in range(0, height, tile_rows):
        rows = min(tile_rows, height - row0)
        py = (row0 + torch.arange(rows, dtype=torch.float32, device=dev))[:, None, None]
        hits = ok & (lo_y - margin <= row0 + rows - 1) & (hi_y + margin >= row0)
        ids = torch.nonzero(hits).flatten()  # ascending: the caller's order
        # where each of XLA's chunks starts in ids: a NaN z voids its chunk's winner
        edges = torch.arange(0, faces.shape[0] + chunk, chunk, device=dev)
        bounds = torch.searchsorted(ids, edges).tolist()
        best_z = depth[row0 : row0 + rows]
        best_id = tri_id[row0 : row0 + rows]
        best_bary = bary[row0 : row0 + rows]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if lo == hi:
                continue
            k = ids[lo:hi]
            ax0, ay0, az0 = x0[k], y0[k], z0[k]
            ax1, ay1, az1 = x1[k], y1[k], z1[k]
            ax2, ay2, az2 = x2[k], y2[k], z2[k]
            inv = inv_area[k]
            w0 = ((ax1 - px) * (ay2 - py) - (ax2 - px) * (ay1 - py)) * inv
            w1 = ((ax2 - px) * (ay0 - py) - (ax0 - px) * (ay2 - py)) * inv
            w2 = 1.0 - w0 - w1  # (rows, W, C)
            inside = (w0 >= -_EPS) & (w1 >= -_EPS) & (w2 >= -_EPS)
            z = w0 * az0 + w1 * az1 + w2 * az2
            z = torch.where(inside, z, torch.full_like(z, ZBUF_INIT))
            zk, j = torch.max(z, dim=-1)  # the first maximum: the lowest id
            take = zk > best_z
            best_z.copy_(torch.where(take, zk, best_z))
            best_id.copy_(torch.where(take, k[j].to(torch.int32), best_id))
            bk = torch.stack([torch.gather(w, -1, j[..., None])[..., 0] for w in (w0, w1, w2)], dim=-1)
            best_bary.copy_(torch.where(take[..., None], bk, best_bary))
    return depth, tri_id, bary


@torch.library.custom_op("dad3d::rasterize", mutates_args=(), device_types="cuda")
def _rasterize_op(
    vertices: torch.Tensor, faces: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """On CUDA tensors the kernel, which takes fp32 vertices, sides up to
    32,767 and raises on other shapes."""
    if vertices.ndim != 2 or vertices.shape[1] != 3 or vertices.dtype != torch.float32:
        raise ValueError(f"vertices: expected (V, 3) float32, got {vertices.dtype} {tuple(vertices.shape)}")
    if faces.ndim != 2 or faces.shape[1] != 3 or faces.device != vertices.device:
        raise ValueError(f"faces: expected (T, 3) on {vertices.device}, got {tuple(faces.shape)} on {faces.device}")
    vertices = vertices.contiguous()
    faces = faces.to(torch.int32).contiguous()
    V, T = vertices.shape[0], faces.shape[0]
    if T and not V:
        raise ValueError("faces index an empty vertex array")
    H, W = int(height), int(width)
    if H > _MAX_SIDE or W > _MAX_SIDE:
        raise ValueError(f"the kernel rasterizes sides up to {_MAX_SIDE}, got {H}x{W}")
    dev = vertices.device
    lib = cuda_lib.library()
    scratch = torch.empty(lib.d3d_rasterize_scratch_bytes(T, H, W), dtype=torch.uint8, device=dev)
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    tri_id = torch.empty((H, W), dtype=torch.int32, device=dev)
    bary = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    device, stream = cuda_lib.launch_args(vertices)
    code = lib.d3d_rasterize(
        vertices.data_ptr(), faces.data_ptr(), scratch.data_ptr(), scratch.numel(),
        depth.data_ptr(), tri_id.data_ptr(), bary.data_ptr(), V, T, H, W, device, stream,
    )
    cuda_lib.check(code, "d3d_rasterize")
    rasterize_buffers.launches += 1
    return depth, tri_id, bary


@_rasterize_op.register_kernel("cpu")
def _(vertices, faces, height, width):
    return rasterize_buffers_reference(vertices, faces, height, width)


@_rasterize_op.register_fake
def _(vertices, faces, height, width):
    return (vertices.new_empty((height, width), dtype=torch.float32),
            vertices.new_empty((height, width), dtype=torch.int32),
            vertices.new_empty((height, width, 3), dtype=torch.float32))


def rasterize_buffers(
    vertices: torch.Tensor, faces: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Z-buffer rasterization of one mesh at any (height, width).

    vertices: (V, 3) screen-space fp32, x right, y down, larger z nearer;
    faces: (T, 3) integer vertex indices. Returns depth (H, W) fp32 (-1e8
    where empty), tri_id (H, W) int32 (-1 where empty) and bary (H, W, 3)
    fp32, the winning triangle's barycentric weights.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes fp32 vertices, sides up to 32,767 and raises on other devices or
    shapes."""
    if vertices.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rasterize_buffers runs on cpu or cuda tensors, got {vertices.device}")
    return _rasterize_op(vertices, faces, int(height), int(width))


rasterize_buffers.launches = 0  # kernel launches (one per op call on CUDA tensors); the CPU path does not count


def shade(
    tri_id: torch.Tensor,
    bary: torch.Tensor,
    faces: torch.Tensor,
    colors: torch.Tensor,
    bg: torch.Tensor,
    alpha: float = 1.0,
) -> torch.Tensor:
    """Interpolate per-vertex colours (in [0, 1]) over the rasterized buffers
    and alpha-blend them into a uint8 background image."""
    vid = faces.long()[torch.clamp(tri_id, min=0).long()]  # (H, W, 3)
    pix = torch.sum(colors[vid] * bary[..., None], dim=-2)  # (H, W, 3)
    bg_f = bg.float()
    covered = (tri_id >= 0)[..., None]
    out = torch.where(covered, (1.0 - alpha) * bg_f + alpha * 255.0 * torch.clamp(pix, 0.0, 1.0), bg_f)
    return torch.clamp(out + 0.5, 0, 255).to(torch.uint8)


def rasterize(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    colors: torch.Tensor,
    bg: Optional[torch.Tensor] = None,
    height: int = 256,
    width: int = 256,
    alpha: float = 1.0,
    channels: int = 3,
) -> torch.Tensor:
    """Render per-vertex colours over ``bg`` (uint8 (H, W, C), or black of
    (height, width, channels)) on the vertices' device."""
    dev = vertices.device
    vertices = vertices.float()
    faces = faces.to(dev)
    colors = colors.to(device=dev, dtype=torch.float32)
    if bg is None:
        bg = torch.zeros((height, width, channels), dtype=torch.uint8, device=dev)
    else:
        bg = bg.to(dev)
        height, width = bg.shape[:2]
    _, tri_id, bary = rasterize_buffers(vertices, faces, height, width)
    return shade(tri_id, bary, faces, colors, bg, alpha)


def get_normal(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """One-ring vertex normals: per vertex, the sum of its faces' cross
    products (their doubled areas weight them), normalized."""
    faces = faces.long()
    tri = vertices[faces]  # (T, 3, 3)
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    return vn / torch.clamp(norm, min=1e-12)
