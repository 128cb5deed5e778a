"""CUDA-event times of one call on the card, and the kernels of a checkout of
the port timed alike.

:func:`median_ms` is the timer of ``chip_smoke.py``. :func:`kernel_ms` times a
kernel two ways, each on a cold L2: the card's time, with the call queued
behind a ~0.5 ms spin of the card so that the host has issued all of it
before its start event runs; and the time with the host's dispatch, without
the spin, where a wrapper that takes longer to launch than the L2 flush takes
to run leaves the card idle inside the timed span (the only kernel timing of
``chip_smoke.py`` before the spin).

Run as a file, it times the kernels of the port in the checkout ROOT
(default: the one holding this file), both ways, with the host's
microseconds per call, and prints one JSON line: the FLAME blendshape
forward (B = 64 and 256) and its backward (d_betas + d_template, B = 64)
against ``torch.addmm`` and ``torch.matmul`` + ``sum`` (fp32, TF32 off);
the rasterizer on the FLAME mesh at 512x640 (the PNCC render) and on the
spherical UV unwrap at 256x256 (the UV table); the crop/resize/normalize
kernel on 64 planar 1280x720 frames with face boxes (``chip_smoke.py``
phase 3b's timing shape); the uint8 normalize on predict_batch's (256, 256,
256, 3) batch, fp32 output beside ``torch.addcmul`` (the same function in
one call, contracted to an FMA), bf16 output where the checkout's wrapper
takes ``out_dtype``, and the bf16 route that output replaces, the fp32
kernel then ``.to(torch.bfloat16)``, timed as one span. The inputs come
from the seeded functions below, which ``chip_smoke.py`` uses too. Two checkouts are compared by running it
on each, one after the other on one card (parent, change, change, parent)::

    python3 dad3dheads_tpu_torch/kernel_timing.py [ROOT]

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SPIN_CYCLES = 1_000_000  # ~0.5 ms of the card's clock before a kernel's timed call
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def median_ms(fn, reps: int = 20, warmup: int = 3, flush: torch.Tensor | None = None, spin: bool = False) -> float:
    """Median CUDA-event time of one call of ``fn`` after ``warmup`` calls.
    ``flush`` is overwritten before each timed call, so that the call finds a
    cold L2; with ``spin`` the card then idles for ``SPIN_CYCLES`` before the
    start event, so that the time is the card's alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(fn, flush: torch.Tensor) -> tuple[float, float]:
    """(the card's ms, the ms with the host's dispatch) of one call of ``fn``
    on a cold L2, each the median of 20."""
    return median_ms(fn, flush=flush, spin=True), median_ms(fn, flush=flush)


def host_us(fn, calls: int = 50) -> float:
    """The host's microseconds per call of ``fn``, over ``calls`` calls back
    to back: the card's queue takes them without the host waiting."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def head_params(seed: int = 0, fill: float = 0.6) -> np.ndarray:
    """A 3DMM vector whose FLAME mesh fills ``fill`` of the image: seeded
    shape and expression, a small rotation."""
    from dad3dheads_tpu_torch import assets

    rng = np.random.default_rng(seed)
    mm = np.zeros((1, 413), np.float32)
    mm[0, :400] = rng.normal(size=400) * 0.5
    mm[0, 403:409] = [1.0, 0.05, 0.0, -0.05, 1.0, 0.1]
    mm[0, 409:411] = rng.uniform(-0.1, 0.1, size=2)
    extent = np.ptp(assets.load_flame_model().v_template[:, :2], axis=0).max()
    mm[0, 412] = 2.0 * fill / extent - 1.0
    return mm


def flame_screen(flame, h: int, w: int) -> np.ndarray:
    """The seeded head's vertices projected into an (h, w) image, z flipped,
    as the PNCC render rasterizes them."""
    from dad3dheads_tpu_torch.core.head_mesh import HeadMesh

    hm = HeadMesh(image_size=max(h, w), model=flame)
    v = hm.reprojected_vertices(torch.from_numpy(head_params()), to_2d=False)[0].clone()
    v[:, 2] *= -1.0
    return v.cpu().numpy()


def seeded_frames(rng, sizes) -> list:
    """uint8 RGB frames of the given (h, w): a smooth gradient plus noise,
    so that a resample of them is not flat."""
    frames = []
    for h, w in sizes:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (yy * 97 // max(h, 1) + xx * 131 // max(w, 1))[..., None] + np.array([0, 60, 120])
        noise = rng.integers(0, 64, (h, w, 3))
        frames.append(((base + noise) % 256).astype(np.uint8))
    return frames


def face_boxes(rng, sizes) -> list:
    """Boxes cycling through: the whole frame, a face-sized interior box, a
    small box (an upscale), a wide flat box (mixed scales in resize mode) and
    a loose box past the frame."""
    boxes = []
    for i, (h, w) in enumerate(sizes):
        kind = i % 5
        if kind == 0:
            boxes.append([0, 0, w, h])
        elif kind == 1:
            side = int(min(h, w) * rng.uniform(0.3, 0.6))
            x0, y0 = int(rng.integers(0, w - side)), int(rng.integers(0, h - side))
            boxes.append([x0, y0, x0 + side, y0 + side])
        elif kind == 2:
            x0, y0 = int(rng.integers(0, w - 90)), int(rng.integers(0, h - 90))
            boxes.append([x0, y0, x0 + int(rng.integers(40, 90)), y0 + int(rng.integers(40, 90))])
        elif kind == 3:
            boxes.append([0, h // 3, w, h // 3 + min(h // 3, 100)])
        else:
            boxes.append([-40, -25, w + 60, h + 35])
    return boxes


def frames_batch(rng, batch: int = 64, size=(720, 1280)):
    """``batch`` planar frames of one size with face boxes, as predict_frames
    packs them: (uint8 buffer, sizes, boxes), numpy."""
    from dad3dheads_tpu_torch.ops.preprocess_device import pack_frames_host

    sizes_hw = [size] * batch
    frames = seeded_frames(rng, sizes_hw[:8]) * (batch // 8)
    return pack_frames_host(frames, face_boxes(rng, sizes_hw), batch, planar=True)


def _row(name: str, kernel, library, err: float, flush: torch.Tensor) -> dict:
    """A kernel timed both ways beside its library call (or none)."""
    k_ms, k_host_ms = kernel_ms(kernel, flush)
    row = {"name": name, "ms": k_ms, "ms_host": k_host_ms, "host_us": host_us(kernel)}
    if library is not None:
        l_ms, l_host_ms = kernel_ms(library, flush)
        row.update({"library_ms": l_ms, "library_ms_host": l_host_ms, "library_host_us": host_us(library),
                    "max_abs_err_vs_library": err})
    return row


def main(argv: list[str] | None = None) -> int:
    here = Path(__file__).resolve().parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=str(here.parent), help="checkout whose port is timed")
    root = Path(ap.parse_args(argv).root).resolve()
    if not torch.cuda.is_available():
        print("kernel_timing needs a CUDA device; none is available", file=sys.stderr)
        return 1
    # the port of ROOT, not the modules beside this file
    sys.path[:] = [str(root)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    from dad3dheads_tpu_torch.core.flame import FlameModel
    from dad3dheads_tpu_torch.ops import blendshapes as ops
    from dad3dheads_tpu_torch.ops import cuda_lib

    if Path(ops.__file__).resolve().parents[2] != root:
        print(f"imported the port from {ops.__file__}, not {root}: run this file directly", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cuda_lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    flame = FlameModel.load(device="cuda")
    dirs, template = flame.shapedirs, flame.v_template
    template_flat = template.reshape(1, -1)
    K, N = dirs.shape
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []
    for B in (64, 256):
        betas = torch.randn((B, K), generator=gen).cuda()
        err = (ops.blend_shapes_fused(betas, dirs, template).reshape(B, N)
               - torch.addmm(template_flat, betas, dirs)).abs().max().item()
        rows.append(_row(f"forward B={B}", lambda: ops.blend_shapes_fused(betas, dirs, template),
                         lambda: torch.addmm(template_flat, betas, dirs), err, flush))
    B, needs = 64, (True, False, True)
    g = torch.randn((B, N), generator=gen).cuda()
    betas = torch.randn((B, K), generator=gen).cuda()
    d_betas, _, d_tmpl = ops.blend_shapes_fused_backward(g, betas, dirs, needs)
    err = max((d_betas - g @ dirs.T).abs().max().item(), (d_tmpl - g.sum(0)).abs().max().item())
    rows.append(_row(f"backward B={B} d_betas + d_template",
                     lambda: ops.blend_shapes_fused_backward(g, betas, dirs, needs),
                     lambda: (torch.matmul(g, dirs.T), g.sum(0)), err, flush))

    # the rasterizer: the PNCC render's mesh and the UV table's unwrap
    from dad3dheads_tpu_torch import assets
    from dad3dheads_tpu_torch.ops.preprocess_device import frame_scalars
    from dad3dheads_tpu_torch.ops.resample import resample_normalize
    from dad3dheads_tpu_torch.render.rasterizer import rasterize_buffers
    from dad3dheads_tpu_torch.render.uv_texture import spherical_uv_vertices

    meshes = {
        "rasterize FLAME 512x640": (flame_screen(flame, 512, 640),
                                    assets.get_flame_indices("faces_wo_ears_remapped"), 512, 640),
        "rasterize UV table 256x256": (spherical_uv_vertices(flame.v_template.cpu().numpy(), 256),
                                       assets.get_faces(), 256, 256),
    }
    for name, (verts, faces, h, w) in meshes.items():
        v = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).cuda()
        f = torch.from_numpy(np.ascontiguousarray(faces, np.int32)).cuda()
        rows.append(_row(f"{name} ({len(faces)} faces)", lambda: rasterize_buffers(v, f, h, w), None, 0.0, flush))

    # the resample: 64 planar 1280x720 frames with face boxes -> 256x256 fp32
    buf, sizes, boxes = frames_batch(np.random.default_rng(10))
    x = torch.from_numpy(buf).cuda()
    scalars = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(boxes), 256)[0].cuda()
    rows.append(_row("resample_normalize B=64 planar 720x1280 face boxes -> 256x256 fp32",
                     lambda: resample_normalize(x, scalars, 256), None, 0.0, flush))

    # the uint8 normalize at predict_batch's shape
    from dad3dheads_tpu_torch.ops import preprocess

    x = torch.randint(0, 256, (256, 256, 256, 3), generator=gen, dtype=torch.uint8).cuda()
    scale, bias = (torch.from_numpy(a).cuda() for a in preprocess.normalize_scale_bias("imagenet"))
    err = (preprocess.normalize_images(x) - torch.addcmul(bias, x, scale)).abs().max().item()
    rows.append(_row("normalize (256, 256, 256, 3) -> fp32", lambda: preprocess.normalize_images(x),
                     lambda: torch.addcmul(bias, x, scale), err, flush))
    if "out_dtype" in inspect.signature(preprocess.normalize_images).parameters:
        rows.append(_row("normalize (256, 256, 256, 3) -> bf16",
                         lambda: preprocess.normalize_images(x, out_dtype=torch.bfloat16), None, 0.0, flush))
    rows.append(_row("normalize (256, 256, 256, 3) -> fp32, then .to(torch.bfloat16)",
                     lambda: preprocess.normalize_images(x).to(torch.bfloat16), None, 0.0, flush))
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
