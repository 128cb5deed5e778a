"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

The hand-written kernels are built from ``dad3dheads_tpu_torch/csrc`` on first
use. Phases, each of which asserts (any failure exits non-zero):

  1. the card's name and power limit, the torch and CUDA versions;
  2. build the kernels (nvcc), report the build seconds;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with CUDA-event times (median of 20 after warm-up, L2
     flushed before each launch);
  4. ``FaceMeshPredictor.predict_batch`` (resnet50 DAD-3DNet, 256x256, random
     weights from a seeded generator, randomized BN statistics) on 64 seeded
     uint8 images: shapes, dtypes, finiteness, launch counts of both kernels,
     and agreement with the same weights run on the CPU (plain paths);
  5. ``predict_batch`` at B=256, fp32 and bf16 trunk: img/s from CUDA events,
     median of 5 after warm-up.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dad3dheads_tpu_torch.api import FaceMeshPredictor
from dad3dheads_tpu_torch.core.flame import FlameModel
from dad3dheads_tpu_torch.models import randomize_bn_stats
from dad3dheads_tpu_torch.ops import cuda_lib
from dad3dheads_tpu_torch.ops.blendshapes import blend_shapes_fused, blend_shapes_fused_reference
from dad3dheads_tpu_torch.ops.preprocess import normalize_images, normalize_images_reference

SEED = 0
IMG = 256
SLICE_B = 64
BENCH_B = 256
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def median_ms(fn, reps: int = 20, warmup: int = 3, flush: torch.Tensor | None = None) -> float:
    """Median CUDA-event time of one call of ``fn``; ``flush`` is overwritten
    before each timed call so that the call finds a cold L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase1_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def phase2_build() -> None:
    path, seconds = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {path.name}: {seconds:.2f} s compiling (0 = cached)")


def phase3_kernels(flame: FlameModel) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    # kernel 2: uint8 normalize
    norm_err = 0.0
    shapes = [(BENCH_B, IMG, IMG, 3), (3, 250, 131, 3)]
    for shape in shapes:
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
        for mode in ("imagenet", "mean", "none"):
            err = (normalize_images(x, mode) - normalize_images_reference(x, mode)).abs().max().item()
            print(f"[normalize] {shape} {mode}: max abs diff {err:.3g}")
            assert err <= 1e-6, (shape, mode, err)
            norm_err = max(norm_err, err)
    # a batch slice is not 16-byte aligned: the kernel's scalar path
    x = torch.randint(0, 256, (4, 250, 131, 3), generator=gen, dtype=torch.uint8).to(dev)[1:]
    err = (normalize_images(x) - normalize_images_reference(x)).abs().max().item()
    print(f"[normalize] unaligned slice {tuple(x.shape)}: max abs diff {err:.3g}")
    assert err <= 1e-6, err
    norm_err = max(norm_err, err)
    x = torch.randint(0, 256, shapes[0], generator=gen, dtype=torch.uint8).to(dev)
    norm_ms = median_ms(lambda: normalize_images(x), flush=flush)
    norm_plain_ms = median_ms(lambda: normalize_images_reference(x), flush=flush)
    print(f"[normalize] {shapes[0]} imagenet: kernel {norm_ms:.4f} ms, plain {norm_plain_ms:.4f} ms")

    # kernel 1: fused blendshapes at the full FLAME width
    blend_err = 0.0
    blend_ms = blend_plain_ms = None
    for B in (1, 7, SLICE_B, BENCH_B):
        betas = torch.randn((B, flame.shapedirs.shape[0]), generator=gen).to(dev)
        out = blend_shapes_fused(betas, flame.shapedirs, flame.v_template)
        ref = blend_shapes_fused_reference(betas, flame.shapedirs, flame.v_template)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        k_ms = median_ms(lambda: blend_shapes_fused(betas, flame.shapedirs, flame.v_template), flush=flush)
        p_ms = median_ms(lambda: blend_shapes_fused_reference(betas, flame.shapedirs, flame.v_template), flush=flush)
        print(f"[blendshapes] B={B} N={flame.shapedirs.shape[1]}: max abs diff {err:.3g} (rel {rel:.3g}), "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        assert out.shape == (B, flame.num_vertices, 3), out.shape
        assert err <= 1e-4 and rel <= 1e-5, (B, err, rel)
        blend_err = max(blend_err, err)
        blend_ms, blend_plain_ms = k_ms, p_ms  # the last, B=256, goes in the summary
    del flush
    return [
        {"name": "blend_shapes_fused", "route": "cuda",
         "source": "dad3dheads_tpu_torch/csrc/blendshapes.cu",
         "replaces": "dad3dheads_tpu/ops/blendshapes.py:36",
         "max_abs_err": blend_err, "ms": blend_ms, "plain_ms": blend_plain_ms,
         "shape": f"B={BENCH_B}"},
        {"name": "normalize_images", "route": "cuda",
         "source": "dad3dheads_tpu_torch/csrc/normalize.cu",
         "replaces": "dad3dheads_tpu/ops/preprocess_pallas.py:30",
         "max_abs_err": norm_err, "ms": norm_ms, "plain_ms": norm_plain_ms,
         "shape": f"{shapes[0]}"},
    ]


def phase4_slice(config: dict) -> tuple[FaceMeshPredictor, dict]:
    pred = FaceMeshPredictor(config, device="cuda", seed=SEED)
    randomize_bn_stats(pred.model, torch.Generator().manual_seed(SEED + 1))
    images = np.random.default_rng(SEED).integers(0, 256, (SLICE_B, IMG, IMG, 3), dtype=np.uint8)

    blend_shapes_fused.launches = 0
    normalize_images.launches = 0
    t0 = time.perf_counter()
    out = pred.predict_batch(images)
    seconds = time.perf_counter() - t0
    launches = {"blend_shapes_fused": blend_shapes_fused.launches,
                "normalize_images": normalize_images.launches}
    print(f"[slice] predict_batch B={SLICE_B} (first call) {seconds:.3f} s, launches {launches}")
    assert all(n >= 1 for n in launches.values()), launches

    V = pred.flame.num_vertices
    expect = {"points": (SLICE_B, 68, 2), "projected_vertices": (SLICE_B, V, 2),
              "3d_vertices": (SLICE_B, V, 3), "3dmm_params": (SLICE_B, 413)}
    for key, shape in expect.items():
        assert out[key].shape == shape and out[key].dtype == np.float32, (key, out[key].shape, out[key].dtype)
        assert np.isfinite(out[key]).all(), key

    cpu = FaceMeshPredictor(config, device="cpu", seed=SEED)
    cpu.model.load_state_dict(pred.model.state_dict())
    ref = cpu.predict_batch(images[:4])
    tol = {"3dmm_params": 1e-3, "3d_vertices": 1e-3, "points": 0.5, "projected_vertices": 0.5}
    for key, atol in tol.items():
        gap = float(np.abs(out[key][:4] - ref[key]).max())
        print(f"[slice] card vs cpu {key}: max abs gap {gap:.3g} (atol {atol})")
        assert gap <= atol, (key, gap)
    return pred, launches


def phase5_throughput(pred: FaceMeshPredictor, config: dict) -> None:
    images = np.random.default_rng(SEED + 2).integers(0, 256, (BENCH_B, IMG, IMG, 3), dtype=np.uint8)
    bf16_config = {**config, "model": {**config["model"], "dtype": "bfloat16"}}
    bf16 = FaceMeshPredictor(bf16_config, device="cuda", seed=SEED)
    bf16.model.load_state_dict(pred.model.state_dict())
    outs = {}
    for name, p in (("fp32", pred), ("bf16", bf16)):
        ms = median_ms(lambda: outs.__setitem__(name, p.predict_batch(images)), reps=5, warmup=2)
        print(f"[throughput] predict_batch B={BENCH_B} {name}: {ms:.2f} ms, {BENCH_B / ms * 1e3:.1f} img/s")
        assert all(np.isfinite(v).all() for v in outs[name].values()), name
    gap = float(np.abs(outs["bf16"]["3dmm_params"] - outs["fp32"]["3dmm_params"]).max())
    print(f"[throughput] bf16 vs fp32 3dmm_params max abs gap {gap:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase1_card()
    phase2_build()
    flame = FlameModel.load(device="cuda")
    kernels = phase3_kernels(flame)
    config = {"img_size": IMG, "model": {"backbone": "resnet50", "dtype": "float32"}}
    pred, launches = phase4_slice(config)
    phase5_throughput(pred, config)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
