"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

The hand-written kernels are built from ``dad3dheads_tpu_torch/csrc`` on first
use. Phases, each of which asserts (any failure exits non-zero):

  1. the card's name and power limit, the torch and CUDA versions;
  2. build the kernels (one nvcc per source, in parallel), report the seconds
     and the blendshape, rasterizer, resample and normalize kernels'
     registers, shared memory and spills;
  3. the normalize kernel bit for bit against its plain version, fp32 and
     bf16 output (and the bf16 output against the fp32 one cast), in every
     mode, on predict_batch's (256, 256, 256, 3) batch, ragged sizes and
     unaligned batch slices; timed in both types beside
     ``torch.addcmul`` and the bf16 route it replaces (the fp32 kernel, then
     the cast). The normalize and blendshape kernels against their plain PyTorch
     versions on the card, at the main path's shapes, with CUDA-event times
     (median of 20 after warm-up, L2 flushed before each launch; each
     kernel and library call timed twice, queued behind a spin of the card
     so that the time is the card's, and without the spin, so that the
     host's dispatch counts where it outlasts the flush:
     ``dad3dheads_tpu_torch/kernel_timing.py``); the blendshape forward at
     B = 1, 7, 64, 256 and 257 (each configuration of its row tile, and a
     ragged last one), timed against ``torch.addmm`` at the train batch 64
     and the inference batch 256;
  3b. the crop/resize/normalize kernel against its plain version: area
     downscale, linear upscale, resize mode with mixed scales, loose boxes,
     Hmax 640 and 1088, both layouts, fp32 and bf16 (bf16 bit for bit the
     fp32 output cast), a whole 1920x1080 frame
     (f = 7.5), a 2-pixel crop, a ragged Wmax (the byte path), the same bits
     on a second launch, an exact identity crop; the bytes one call allocates
     beyond its output (none); timed at B=64 on 1280x720 frames with face
     boxes;
  3c. the rasterizer kernel against its plain version, ids on every pixel
     and the same bits on a second launch: the FLAME mesh at 256² and
     512x640, the spherical UV unwrap at 256², a constant-depth mesh, 4,500
     large overlapping triangles at constant depth (lists past a batch and a
     slice, all ties), triangles partly off-image, one triangle over the
     whole image, 1,031 triangles on a ragged 250x333 image, no triangles,
     2,000 sliver tips (pixels inside slivers past their 1 px + 1e-3 box);
     then its one departure, a NaN z (the kernel skips that triangle alone:
     bit for bit the plain version on the mesh without it), and an infinite x
     corner (bit for bit the plain version);
     timed at 512x640 (the PNCC render) and on the UV table at 256²;
  4. ``FaceMeshPredictor.predict_batch`` (resnet50 DAD-3DNet, 256x256, random
     weights in the JAX package's initialisation scheme from a seeded
     generator, randomized BN statistics) on 64 seeded
     uint8 images: shapes, dtypes, finiteness, launch counts of both kernels,
     and agreement with the same weights run on the CPU (plain paths);
  4b. ``predict_frames`` on 64 seeded frames of mixed sizes up to 1920x1080
     with whole-frame, interior and loose face boxes, against the CPU on 4 of
     them; ``predict_images`` on a CUDA uint8 tensor (the device branch);
  4c. ``PNCCEstimator`` and ``UVTextureCreator`` on a 4b frame and a seeded
     head that fills 60% of the mesh's image, against the CPU;
  5. ``predict_batch`` at B=256, fp32 and bf16 trunk: one normalize launch
     each, writing fp32 and bf16; img/s from CUDA events, median of 5 after
     warm-up; the bf16 trunk's outputs bit for bit those of the route through
     the fp32 normalize and autocast's cast (cuDNN deterministic);
  5b. ``predict_frames`` on 256 1280x720 frames in batches of 64, fp32 and
     bf16 trunk, img/s, median of 5 after warm-up, and the host's share; the
     bf16 trunk's outputs on 64 of them bit for bit the fp32-resample route's;
  3d. the blendshape backward kernel against its plain version at B = 7,
     64 and 128 (d_betas, d_template, d_shapedirs; the same bits on a second
     launch), timed at the train batch B = 64 against one library call;
  6. the training path: two train steps on the card and on the CPU from the
     same seeded weights and batch (fp32, dropout 0, B = 8, 256x256), held
     to each other; then ``cli.train``'s ``main`` at full width (resnet50,
     256x256, batch 64, ``--synthetic 4``, one epoch, the repo's
     ``configs/train.yaml``) to an export that the port's predictor loads;
     then train-step img/s at B = 64 and 128, fp32 and bf16 trunk, the step
     without its metric panel (median and range of 5 windows of 3 steps
     after 5 warm-ups), and the kernels' launches per train step;
  7. the dataset path: ``cli/make_dataset.py`` renders 64 train and 16 val
     images at 128x128 on the card (the rasterizer kernel); ``cli.train``
     trains on them from disk at full width (batch 32, one epoch, uint8
     batches normalized by the kernel, heatmaps encoded in the step); the
     val set is predicted through host crops and through ``predict_frames``
     (the resample kernel) and scored against ``generate_gt``'s ground truth;
     the evaluator on the card and on the CPU on one submission (pose and
     NME equal, Chamfer within 1e-6 relative, Z_5 within 1e-3) and timed on
     a 32-item submission; this path's launches of all five kernels; the
     loader's ms per item and the loader-fed train img/s at B = 64, 256x256,
     thread workers and spawned process workers (the same batches), beside
     phase 6's rate;
  8. the second model family, mobilenet_w1 DAD-3DNet at its published widths
     (256x256, BiFPN 256 filters, 68 landmarks, 413 outputs), through the
     same entry points: ``predict_batch`` on 64 seeded uint8 images with
     seeded random weights and randomized BN statistics, against the same
     weights on the CPU (phase 4's tolerances); ``predict_frames`` on 8
     4b-style frames, against the CPU on 4; two train steps on the card and
     the CPU from one seeded state (phase 6's tolerances); ``cli.train``
     (``model.backbone=mobilenet_w1``, ``--synthetic 4``, batch 64) to an
     export that the mobilenet predictor loads; then phase 5's and 5b's
     img/s and bit-for-bit bf16 routes, and train-step img/s at B = 64 and
     128, fp32 and bf16. This path's launches of the normalize, resample,
     blendshape and blendshape backward kernels (each at least one) go into
     the kernels line as ``launches_mobilenet_path``;
  9. the deployment artifact (``api/export.py``), resnet50 at 256x256 with
     phase 4's weights, fp32 and the bf16 trunk: ``export_predictor`` on the
     card (each program's trace seconds, the artifact's MB); a child process
     that cannot import the models, the FLAME code and assets or JAX loads
     it on the card, checks that the ``decode`` graph holds the blendshape
     op and the ``frames`` graph the resample op (and no plain resample),
     and serves ``predict_batch`` on phase 4's 64 images, ``predict_frames``
     on phase 4b's frames and boxes and ``predict_images`` on 131 images
     (chunks of 64, 64 and 3), which are held against the live predictor at
     phase 4's tolerances (``predict_images`` against the live network on
     the same chunks, normalized as the artifact's host does it); the
     child's launches go into the kernels line as ``launches_export_path``
     (at least one blendshape and one resample launch, none of the others);
     the artifact's ``predict_batch`` img/s at B=256 on a pre-normalized
     fp32 batch (beside the live predictor on the same batch and phase 5's
     uint8 rate) and ``predict_frames`` img/s on 256 frames of 1280x720
     (beside phase 5b's); then ``cli.train --synthetic 4 export_aot=true`` at
     full width writes an artifact (card and CPU programs) that loads on the
     card and serves what its ``.msgpack`` gives the live predictor;
  10. int8 inference (``quant_amax``), resnet50 at 256x256, nothing cut, on
     phase 4's weights through a checkpoint: the im2col + ``torch._int_mm``
     route's int32 sums bit for bit a float64 conv at the stem's, a 3x3
     stride-2, the fusion conv's (K 1,348), the heatmap head's (N 68) and
     batch-1 p7's (M 4) shapes and at stage 4's depth with every value at
     +-127; ``calibrate`` on phase 4's 64 images on the card and the CPU, fp32
     (rtol 1e-5) and bf16; the int8 predictor, fp32 and bf16, through
     ``predict_batch``, ``__call__`` and ``predict_frames`` (phase 4b's
     frames) against the CPU at phase 4's tolerances, its landmark
     displacement and 3DMM drift from the float path, img/s beside phase 5's
     and 5b's; the fp32 int8 artifact exported on the card and served from a
     child as in phase 9, ``predict_batch`` and ``predict_frames`` with a
     gap of 0 to the live int8 predictor. This path's launches of the
     normalize, resample and blendshape kernels go into the kernels line as
     ``launches_int8_path`` (each at least one).
  11. the rest of training: two resnet50 train steps with lamb on the card
     and on the CPU from one seeded state (phase 6's tolerances); a
     ``Trainer`` at full width on ``cli.train --synthetic 4``'s synthetic
     loaders (batch 64, two epochs) with ``auto_bs`` (capped at 1024: at
     2048 the stem's output passes 2**31 elements), ``auto_lr`` (8 steps),
     panels every 2 steps and async checkpoints: the probes' outcomes and peak
     memory, the tuned batch and lr, the panels in TensorBoard (or an
     in-memory recorder where it does not import); the fit's async
     ``last.pt`` and a second async save byte for byte a synchronous save of
     the same state, and the host time of a save each way; the blendshape
     pair at every probed batch (the tuned one and the first that did not
     fit) against its plain versions (phases 3 and 3d's bounds); the panel
     forward card against CPU. The Trainer's launches go
     into the kernels line as ``launches_rest_of_training_path``.
  12. parallel, resnet50 at 256x256, fp32, dropout 0: (a) ``cli.train
     --synthetic 4 distributed=true`` in a child with torchrun's variables
     (a world of one on NCCL) against the same run without ``distributed``
     (phase 6's tolerances on the epoch's losses, the fit's update and the
     BN statistics); (b) two gloo ranks sharing the card (NCCL refuses two
     ranks on one card; ``tests/torch_parallel_worker.py``), each on half
     of a global batch of 16, two data-parallel steps against one process
     on the whole batch (the step-0 loss within 1e-5, the first update and
     BN statistics within phase 6's tolerances, the second step's losses
     within 10%); (c) ``FaceMeshPredictor(mesh=make_mesh([cuda:0,
     cuda:0]))``: ``predict_batch`` at B = 255 and ``predict_frames`` on
     phase 4b's frames against one device (phase 4's tolerances); (d) the
     heads split over two gloo ranks against the replicated step (logs
     2e-4 relative, head weights 1e-5). Each leg's wall time; the
     children's and ranks' launches and the mesh predictor's go into the
     kernels line as ``launches_parallel_path``.

Every launch counter is set to 0 just before the path that owns it is driven
(4, 4b, 4c, 6, 7, each entry point of 8 and 10, each child of 9, 11's
Trainer, and each child, rank and mesh predictor of 12) and read just
after. The kernels are ``torch.library`` custom operators; each counts its
launches in its CUDA body, so the launches of an exported program count. The line before the last is a JSON object
with one entry per kernel: its launches on that path, its largest gap to the
plain version, its time on the card and with the host's dispatch
(``ms_host``), the plain version's, a library call's where one computes the
same function (both ways), and its bound on the card: the larger of the
bytes it must move over 3.35 TB/s and its operations over the peak of the
unit that runs them (the published H100 SXM peaks at 700 W): 67 TFLOP/s for
fp32 outside the tensor cores, 495 TFLOP/s of TF32 for the blendshape pair,
whose 3xTF32 scheme issues three tensor-core products for each fp32 one. The
last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dad3dheads_tpu_torch import assets
from dad3dheads_tpu_torch.api import FaceMeshPredictor
from dad3dheads_tpu_torch.api import predictor as predictor_module
from dad3dheads_tpu_torch.core.flame import FlameModel
from dad3dheads_tpu_torch.core.head_mesh import HeadMesh
from dad3dheads_tpu_torch.kernel_timing import (
    L2_FLUSH_BYTES,
    face_boxes,
    flame_screen,
    frames_batch,
    head_params,
    kernel_ms,
    median_ms,
    seeded_frames,
)
from dad3dheads_tpu_torch.models import randomize_bn_stats
from dad3dheads_tpu_torch.ops import cuda_lib
from dad3dheads_tpu_torch.ops.blendshapes import (
    blend_shapes_fused,
    blend_shapes_fused_backward,
    blend_shapes_fused_backward_reference,
    blend_shapes_fused_reference,
)
from dad3dheads_tpu_torch.ops.preprocess import normalize_images, normalize_images_reference, normalize_scale_bias
from dad3dheads_tpu_torch.ops.preprocess_device import frame_scalars, pack_frames_host
from dad3dheads_tpu_torch.ops.resample import resample_normalize, resample_normalize_reference
from dad3dheads_tpu_torch.render import PNCCEstimator, UVTextureCreator
from dad3dheads_tpu_torch.render.rasterizer import rasterize_buffers, rasterize_buffers_reference
from dad3dheads_tpu_torch.render.uv_texture import spherical_uv_vertices

SEED = 0
IMG = 256
SLICE_B = 64
BENCH_B = 256
FRAMES_B = 64
HBM_BYTES_PER_S = 3.35e12  # published H100 SXM peaks at 700 W
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
TF32X3 = 3  # tensor-core products per fp32 product in the blendshape kernels (csrc/tf32x3.cuh)
TRAIN_B = 64  # configs/train_stage/flame_landmarks.yaml
MODES = ("imagenet", "mean", "none")
KERNELS = ("blend_shapes_fused", "normalize_images", "resample_normalize", "rasterize_buffers",
           "blend_shapes_fused_backward")
SMI = ""  # the card's name and power limit, as nvidia-smi gives them (phase 1)
COUNTED = (blend_shapes_fused, normalize_images, resample_normalize, rasterize_buffers, blend_shapes_fused_backward)


def bound(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take for this work, and which of
    bytes or operations (at ``flops`` a second) sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blend_bounds(n_bytes: float, n_mac: float) -> tuple[tuple[float, str], float]:
    """A blendshape kernel's bound on the tensor cores (three TF32 products
    per multiply-add, each two operations) and, for comparison, the fp32
    bound of the same work outside them."""
    return bound(n_bytes, TF32X3 * 2 * n_mac, TF32_FLOPS), bound(n_bytes, 2 * n_mac)[0]


def reset_launches() -> None:
    for fn in COUNTED:
        fn.launches = 0
    normalize_images.bf16_launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def phase1_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    global SMI
    SMI = smi[0]
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def phase2_build() -> None:
    path, seconds = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {path.name}: {seconds:.2f} s compiling (0 = cached)")
    # the compiler's report for the redesigned kernels: entry, registers,
    # static shared memory, spills (the blendshape kernels' cp.async rings and
    # the resample kernel's rows are dynamic shared memory, sized in the
    # sources and the wrapper)
    source = None
    for line in cuda_lib.build_log_path().read_text().splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif source in ("blendshapes.cu", "blendshapes_bwd.cu", "rasterize.cu", "resample.cu", "normalize.cu") and (
                "Compiling entry" in line or "Used" in line or "spill" in line):
            print(f"[build] {source}: {line.strip()}")


def phase3_normalize(flush: torch.Tensor) -> dict:
    """Kernel 2, the uint8 normalize: bit for bit against its plain version in
    fp32 and bf16 (the bf16 output also against the fp32 output cast), every
    mode; timed at predict_batch's shape in both types, beside torch.addcmul
    (the fp32 function in one call, contracted to an FMA: it differs in the
    last bit) and the bf16 route it replaces (the fp32 kernel, then the
    cast, as autocast cast it before the stem conv)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    # (3, 250, 131, 3) and (1, 37, 41, 3) end in ragged tails (n % 16 = 14, 7)
    cases = {str(shape): torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
             for shape in ((BENCH_B, IMG, IMG, 3), (3, 250, 131, 3), (1, 37, 41, 3))}
    # batch slices off 16-byte alignment (the scalar kernel)
    for shape in ((4, 250, 131, 3), (4, 250, 130, 3)):
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)[1:]
        cases[f"slice {tuple(x.shape)}, {x.data_ptr() % 16} bytes past 16"] = x
    err = 0.0
    for name, x in cases.items():
        for mode in MODES:
            out32, out16 = normalize_images(x, mode), normalize_images(x, mode, out_dtype=torch.bfloat16)
            ref32, ref16 = normalize_images_reference(x, mode), normalize_images_reference(x, mode, torch.bfloat16)
            same = torch.equal(out32, ref32) and torch.equal(out16, ref16) and torch.equal(out16, out32.to(torch.bfloat16))
            e = max((out32 - ref32).abs().max().item(), (out16.float() - ref16.float()).abs().max().item())
            print(f"[normalize] {name} {mode}: fp32 and bf16 bit for bit the plain version's {same} "
                  f"(max abs diff {e:.3g})")
            assert same and out32.dtype == torch.float32 and out16.dtype == torch.bfloat16, (name, mode, e)
            err = max(err, e)

    x = cases[str((BENCH_B, IMG, IMG, 3))]
    n = x.numel()
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        k_ms, k_host_ms = kernel_ms(lambda: normalize_images(x, out_dtype=dtype), flush)
        p_ms = median_ms(lambda: normalize_images_reference(x, "imagenet", dtype), flush=flush, spin=True)
        n_bytes = n * (1 + torch.finfo(dtype).bits // 8)
        b_ms, b_by = bound(n_bytes, 2 * n)
        print(f"[normalize] {tuple(x.shape)} imagenet -> {dtype}: kernel {k_ms:.4f} ms ({k_host_ms:.4f} with the "
              f"host's dispatch), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB), "
              f"{b_ms / k_ms:.1%} of it")
        timed[dtype] = {"ms": k_ms, "ms_host": k_host_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
    scale, bias = (torch.from_numpy(a).to(dev) for a in normalize_scale_bias("imagenet"))
    lib_err = (normalize_images(x) - torch.addcmul(bias, x, scale)).abs().max().item()
    lib_ms, lib_host_ms = kernel_ms(lambda: torch.addcmul(bias, x, scale), flush)
    route_ms, route_host_ms = kernel_ms(lambda: normalize_images(x).to(torch.bfloat16), flush)
    print(f"[normalize] torch.addcmul (fp32, one FMA: max abs diff {lib_err:.3g}) {lib_ms:.4f} ms ({lib_host_ms:.4f} "
          f"with the host's dispatch); the replaced bf16 route, fp32 kernel then .to(bfloat16): {route_ms:.4f} ms "
          f"({route_host_ms:.4f} with the host's dispatch)")
    return {"normalize_images": {
        "route": "cuda", "source": "dad3dheads_tpu_torch/csrc/normalize.cu",
        "replaces": "dad3dheads_tpu/ops/preprocess_pallas.py:30",
        "max_abs_err": err, **timed[torch.float32], "library_ms": lib_ms, "library_ms_host": lib_host_ms,
        "bf16": timed[torch.bfloat16], "bf16_route_replaced": {"ms": route_ms, "ms_host": route_host_ms},
        "shape": f"{tuple(x.shape)} fp32; bf16 under the bf16 trunk"}}


def phase3_kernels(flame: FlameModel, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    # kernel 1: fused blendshapes at the full FLAME width; the library call
    # for the same function is one fp32 GEMM with the add fused, TF32 off
    # (the geometry's precision)
    assert not torch.backends.cuda.matmul.allow_tf32
    dirs, template = flame.shapedirs, flame.v_template
    template_flat = template.reshape(1, -1)
    K, N = dirs.shape
    blend_err = 0.0
    timed = {}
    for B in (1, 7, SLICE_B, BENCH_B, BENCH_B + 1):
        betas = torch.randn((B, K), generator=gen).to(dev)
        out = blend_shapes_fused(betas, dirs, template)
        again = blend_shapes_fused(betas, dirs, template)
        ref = blend_shapes_fused_reference(betas, dirs, template)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        k_ms, k_host_ms = kernel_ms(lambda: blend_shapes_fused(betas, dirs, template), flush)
        p_ms = median_ms(lambda: blend_shapes_fused_reference(betas, dirs, template), flush=flush, spin=True)
        (b_ms, b_by), simt_ms = blend_bounds(4 * (B * K + K * N + N + B * N), B * K * N)
        line = (f"[blendshapes] B={B} N={N}: max abs diff {err:.3g} (rel {rel:.3g}), second launch identical "
                f"{torch.equal(out, again)}, kernel {k_ms:.4f} ms ({k_host_ms:.4f} with the host's dispatch), plain "
                f"{p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; fp32 outside the tensor cores {simt_ms:.4f} ms)")
        if B in (SLICE_B, BENCH_B):
            lib_ms, lib_host_ms = kernel_ms(lambda: torch.addmm(template_flat, betas, dirs), flush)
            timed[B] = (k_ms, k_host_ms, p_ms, lib_ms, lib_host_ms, b_ms, b_by, simt_ms)
            line += f", torch.addmm (fp32, TF32 off) {lib_ms:.4f} ms ({lib_host_ms:.4f} with the host's dispatch)"
        print(line)
        assert out.shape == (B, flame.num_vertices, 3), out.shape
        assert err <= 1e-4 and rel <= 1e-5 and torch.equal(out, again), (B, err, rel)
        blend_err = max(blend_err, err)
    blend_ms, blend_host_ms, blend_plain_ms, blend_lib_ms, blend_lib_host_ms, b_ms, b_by, simt_ms = timed[BENCH_B]
    return {
        "blend_shapes_fused": {
            "route": "cuda", "source": "dad3dheads_tpu_torch/csrc/blendshapes.cu",
            "replaces": "dad3dheads_tpu/ops/blendshapes.py:36",
            "max_abs_err": blend_err, "ms": blend_ms, "ms_host": blend_host_ms, "plain_ms": blend_plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": blend_lib_ms, "library_ms_host": blend_lib_host_ms,
            "fp32_bound_ms": simt_ms,
            "shape": f"B={BENCH_B} K={K} N={N}"},
        **phase3_normalize(flush),
    }


# --------------------------------------------------------------------------
# 3b: the crop/resize/normalize kernel
# --------------------------------------------------------------------------


def resample_work(sizes: torch.Tensor, boxes: torch.Tensor, S: int, out_bytes: int) -> tuple[float, float]:
    """(bytes, fp32 operations) that these crops need: each crop's uint8 rows
    read once and the output written once; two operations per tap of the row
    pass over the crop's columns and of the column pass, two per output
    element for the normalize."""
    scalars = frame_scalars(sizes.cpu(), boxes.cpu(), S)[0].numpy().astype(np.float64)
    n_bytes, ops = float(out_bytes), 0.0
    for y0, bh, new_h, _, x0, bw, new_w, _, area, _ in scalars:
        n_bytes += bh * bw * 3

        def taps(crop_len, new_len):
            if not area:
                return 2.0 * new_len
            f = crop_len / max(new_len, 1.0)
            r = np.arange(new_len)
            return float(np.sum(np.ceil((r + 1) * f) - np.floor(r * f)))

        ops += 2 * taps(bh, new_h) * 3 * bw + 2 * taps(bw, new_w) * 3 * new_h
    return n_bytes, ops + 2.0 * out_bytes / 4


def check_resample(name: str, x: torch.Tensor, scalars: torch.Tensor) -> tuple[float, float]:
    """The kernel against its plain version on one buffer, fp32 and bf16;
    (fp32 gap, bf16 gap)."""
    ref = resample_normalize_reference(x, scalars, IMG)
    out32 = resample_normalize(x, scalars, IMG)
    again = resample_normalize(x, scalars, IMG)
    out16 = resample_normalize(x, scalars, IMG, out_dtype=torch.bfloat16)
    e32 = (out32 - ref).abs().max().item()
    e16 = (out16.float() - ref).abs().max().item()
    cast = torch.equal(out16, out32.to(torch.bfloat16))
    print(f"[resample] {name}: max abs diff fp32 {e32:.3g}, bf16 {e16:.3g}, second launch identical "
          f"{torch.equal(out32, again)}, bf16 bit for bit the fp32 output cast {cast}")
    assert out32.shape == (x.shape[0], IMG, IMG, 3) and out16.dtype == torch.bfloat16
    assert e32 <= 1e-4 and e16 <= 3e-2 and torch.equal(out32, again) and cast, (name, e32, e16)
    return e32, e16


def phase3b_resample(flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 10)
    errs = []
    for hmax, wmax in ((640, 480), (1088, 1920)):
        sizes_hw = [(hmax - 17 * i, wmax - 29 * i) for i in range(10)]
        frames = seeded_frames(rng, sizes_hw)
        boxes = face_boxes(rng, sizes_hw)
        for layout in ("planar", "nhwc"):
            buf, sizes, packed_boxes = pack_frames_host(frames, boxes, len(frames), planar=layout == "planar")
            x = torch.from_numpy(buf).to(dev)
            sz, bb = torch.from_numpy(sizes).to(dev), torch.from_numpy(packed_boxes).to(dev)
            for mode in ("longest_max_size", "resize"):
                scalars, scales, paddings = frame_scalars(sz, bb, IMG, mode)
                cpu = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(packed_boxes), IMG, mode)
                assert torch.equal(scales.cpu(), cpu[1]) and torch.equal(paddings.cpu(), cpu[2]), mode
                errs.append(check_resample(f"Hmax {hmax} Wmax {wmax} {layout} {mode}", x, scalars))
    # a whole 1920x1080 frame (f = 7.5), a 2-pixel crop (a 128x upscale) and a
    # ragged Wmax (333: rows 999 bytes apart, the kernel's byte path)
    frames = seeded_frames(rng, [(1080, 1920), (1080, 1920), (300, 333), (250, 320)])
    boxes = [[0, 0, 1920, 1080], [700, 400, 702, 402], [0, 0, 333, 300], [17, 9, 19, 11]]
    for layout in ("planar", "nhwc"):
        for bucket, picks in ((64, [0, 1]), (1, [2, 3])):
            buf, sizes, packed_boxes = pack_frames_host([frames[i] for i in picks], [boxes[i] for i in picks], 2,
                                                        bucket=bucket, planar=layout == "planar")
            x = torch.from_numpy(buf).to(dev)
            for mode in ("longest_max_size", "resize"):
                scalars = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(packed_boxes), IMG, mode)[0]
                shape = "x".join(map(str, frames[picks[0]].shape[:2]))
                errs.append(check_resample(f"{layout} Wmax {buf.shape[-1] // 3 if layout == 'planar' else buf.shape[2]}"
                                           f" ({shape} whole frame and a 2-pixel crop) {mode}", x, scalars.to(dev)))
    err32, err16 = max(e[0] for e in errs), max(e[1] for e in errs)
    # an identity crop resamples with 0/1 weights: exact
    same = torch.from_numpy(np.stack(seeded_frames(rng, [(IMG, IMG)] * 4))).to(dev)
    scalars = frame_scalars(torch.full((4, 2), IMG, dtype=torch.int32), torch.tensor([[0, 0, IMG, IMG]] * 4), IMG)[0]
    assert (scalars == torch.tensor([0, IMG, IMG, 0, 0, IMG, IMG, 0, 0, 0], dtype=torch.int32)).all(), scalars
    e = (resample_normalize(same, scalars.to(dev), IMG) - normalize_images_reference(same)).abs().max().item()
    print(f"[resample] identity crop: max abs diff to the normalize {e:.3g}")
    assert e <= 1e-6, e

    # time it: B=64 frames of 1280x720 with face boxes, planar as predict_frames packs them
    buf, sizes, packed_boxes = frames_batch(np.random.default_rng(SEED + 10), FRAMES_B)
    x = torch.from_numpy(buf).to(dev)
    scalars = frame_scalars(torch.from_numpy(sizes), torch.from_numpy(packed_boxes), IMG)[0].to(dev)
    gc.collect()  # no cycle of card tensors is freed inside the measured call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # bytes asked of the caching allocator (its blocks may be larger)
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = resample_normalize(x, scalars, IMG)
    extra = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before - out.numel() * out.element_size()
    print(f"[resample] one call asks the allocator for {extra} bytes on the card beyond its output")
    assert extra == 0, extra
    del out
    k_ms, k_host_ms = kernel_ms(lambda: resample_normalize(x, scalars, IMG), flush)
    p_ms = median_ms(lambda: resample_normalize_reference(x, scalars, IMG), flush=flush, spin=True)
    n_bytes, ops = resample_work(torch.from_numpy(sizes), torch.from_numpy(packed_boxes), IMG, FRAMES_B * IMG * IMG * 3 * 4)
    b_ms, b_by = bound(n_bytes, ops)
    print(f"[resample] B={FRAMES_B} 1280x720 planar, face boxes: kernel {k_ms:.4f} ms ({k_host_ms:.4f} with "
          f"the host's dispatch), plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"resample_normalize": {
        "route": "cuda", "source": "dad3dheads_tpu_torch/csrc/resample.cu",
        "replaces": "dad3dheads_tpu/ops/preprocess_pallas.py:327",
        "max_abs_err": err32, "max_abs_err_bf16": err16, "ms": k_ms, "ms_host": k_host_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library_ms_host": None,
        "extra_bytes": extra, "shape": f"B={FRAMES_B} 720x1280 planar -> {IMG}x{IMG} fp32"}}


# --------------------------------------------------------------------------
# 3c: the rasterizer kernel
# --------------------------------------------------------------------------


def raster_work(verts: np.ndarray, faces: np.ndarray, h: int, w: int) -> tuple[float, float]:
    """(bytes, fp32 operations) of one rasterization: vertices and faces read
    once, 20 bytes written per pixel; 26 operations per (pixel, triangle)
    pair whose pixel lies in the triangle's box, clipped to the image."""
    tri = verts[faces]
    lo = np.ceil(tri[:, :, :2].min(1))
    hi = np.floor(tri[:, :, :2].max(1))
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, [w - 1, h - 1])
    pairs = np.prod(np.clip(hi - lo + 1, 0, None), axis=1).sum()
    return float(verts.nbytes + faces.nbytes + h * w * 20), 26.0 * float(pairs)


def raster_cases(flame: FlameModel) -> dict:
    """name -> (vertices, faces, h, w): the render path's meshes and the cases
    that stress the kernel's per-tile lists."""
    wo_ears = assets.get_flame_indices("faces_wo_ears_remapped").astype(np.int32)
    all_faces = assets.get_faces().astype(np.int32)
    cases = {f"flame {h}x{w}": (flame_screen(flame, h, w), wo_ears, h, w) for h, w in ((256, 256), (512, 640))}
    cases["uv spherical 256x256"] = (spherical_uv_vertices(flame.v_template.cpu().numpy(), IMG), all_faces, IMG, IMG)
    rng = np.random.default_rng(SEED + 20)

    def soup(n, lo, hi, const_z=None):
        verts = rng.uniform(lo, hi, (3 * n, 3)).astype(np.float32)
        verts[:, 2] = rng.uniform(0, 10, 3 * n) if const_z is None else const_z
        return verts, np.arange(3 * n, dtype=np.int32).reshape(n, 3)

    cases["constant depth 256x256"] = (*soup(60, 0, IMG - 1, 1.0), IMG, IMG)
    # every tile's list far past a batch, in several slices, all ties
    cases["4,500 large overlapping triangles at constant depth 256x256"] = (*soup(4500, -60, IMG + 60, 1.0), IMG, IMG)
    cases["triangles partly off-image, negative coordinates 256x256"] = (*soup(300, -200, 120), IMG, IMG)
    verts, faces = soup(40, 0, IMG - 1)
    big = np.asarray([[-500, -500, 0.5], [5 * IMG, -500, 0.5], [-500, 5 * IMG, 0.5]], np.float32)
    cases["one triangle over the whole image under 40 256x256"] = (
        np.concatenate([big, verts]), np.concatenate([[[0, 1, 2]], faces + 3]).astype(np.int32), IMG, IMG)
    cases["1,031 triangles (no multiple of a tile, batch or slice) 250x333"] = (*soup(1031, -10, 340), 250, 333)
    cases["no triangles 250x333"] = (soup(1, 0, 1)[0], np.zeros((0, 3), np.int32), 250, 333)
    cases["2,000 sliver tips 256x256"] = (*sliver_tips(rng, 2000, IMG), IMG, IMG)
    return cases


def sliver_tips(rng, n: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Slivers whose computed area is mostly rounding, each pointing 2-40 px
    past its tip at a pixel within 3e-5 px of its long edge's line: there
    fp32 passes the inside test outside the 1 px + 1e-3 box, and only the
    whole-image box that box_margin gives such slivers keeps those pixels."""
    pixel = rng.integers(0, size, (n, 2)).astype(np.float64)
    phi = rng.uniform(0, 2 * np.pi, n)
    along = np.stack([np.cos(phi), np.sin(phi)], 1)
    normal = np.stack([-along[:, 1], along[:, 0]], 1)
    length = rng.uniform(40, 200, (n, 1))
    tip = pixel - rng.uniform(2, 40, (n, 1)) * along + rng.uniform(-3e-5, 3e-5, (n, 1)) * normal
    base = tip - length * along
    apex = base + rng.uniform(0, 1, (n, 1)) * length * along + 10.0 ** rng.uniform(-7, -4.5, (n, 1)) * normal
    verts = np.concatenate([np.stack([base, tip, apex], 1), rng.uniform(0, 10, (n, 3, 1))], 2)
    return verts.reshape(-1, 3).astype(np.float32), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def non_finite_mesh(case: str, size: int = IMG) -> tuple[np.ndarray, np.ndarray, int]:
    """1,100 triangles, two of the XLA rasterizer's chunks of 1,024: chunk 0
    in front all over the image, chunk 1 behind over its left half, and
    triangle 3 over most of the image with a corner made non-finite: z = NaN
    ("nan_z") or x = inf ("inf_x"). Returns (verts, faces, 3)."""
    rng = np.random.default_rng(SEED + 21)
    n0, n1 = 3 * 1024, 3 * 76
    verts = rng.uniform(-size // 8, size + size // 8, (n0 + n1, 3)).astype(np.float32)
    verts[:n0, 2] = rng.uniform(5, 10, n0)
    verts[n0:, 0] = rng.uniform(-size // 8, size // 2, n1)
    verts[n0:, 2] = rng.uniform(0, 5, n1)
    verts[9:12] = np.asarray([[0.05, 0.05, 7.0], [0.95, 0.1, 7.0], [0.45, 0.95, 7.0]], np.float32) * [size, size, 1]
    verts[10, 2 if case == "nan_z" else 0] = np.nan if case == "nan_z" else np.inf
    return verts, np.arange(n0 + n1, dtype=np.int32).reshape(-1, 3), 3


def check_non_finite(case: str) -> None:
    """The kernel on a non-finite vertex: with a NaN z it skips that triangle
    alone, so it equals the plain version on the mesh without it (ids mapped
    back), where the plain version voids the NaN triangle's chunk of 1,024;
    with an infinite x corner it equals the plain version on the mesh."""
    dev = torch.device("cuda")
    verts, faces, k = non_finite_mesh(case)
    vt, ft = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)
    out = rasterize_buffers(vt, ft, IMG, IMG)
    full = rasterize_buffers_reference(vt, ft, IMG, IMG)
    if case == "nan_z":
        depth, tri_id, bary = rasterize_buffers_reference(vt, torch.cat([ft[:k], ft[k + 1:]]), IMG, IMG)
        ref = (depth, torch.where(tri_id >= k, tri_id + 1, tri_id), bary)
    else:
        ref = full
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, ref))
    parted = int((out[1] != full[1]).sum().item())
    print(f"[rasterize] {case}, 1,100 triangles 256x256: bit for bit the plain version on the mesh"
          f"{' without the NaN triangle' if case == 'nan_z' else ''} {same}; {parted} pixels part from the plain "
          f"version on the whole mesh")
    assert same and (parted > 0) == (case == "nan_z"), (case, parted)


def phase3c_raster(flame: FlameModel, flush: torch.Tensor) -> dict:
    """Each case: the triangle ids equal the plain version's on every pixel,
    depth and barycentrics within 1e-4 (printed; expected 0), and a second
    launch gives the same bits."""
    dev = torch.device("cuda")
    cases = raster_cases(flame)
    err = 0.0
    for name, (verts, faces, h, w) in cases.items():
        vt, ft = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)
        out = rasterize_buffers(vt, ft, h, w)
        again = rasterize_buffers(vt, ft, h, w)
        r_depth, r_tri_id, r_bary = rasterize_buffers_reference(vt, ft, h, w)
        depth, tri_id, bary = out
        flipped = int((tri_id != r_tri_id).sum().item())
        e = max((depth - r_depth).abs().max().item(), (bary - r_bary).abs().max().item())
        same_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, again))
        covered = int((r_tri_id >= 0).sum().item())
        print(f"[rasterize] {name}: {covered} covered pixels, {flipped} with another triangle id, "
              f"depth/bary max abs diff {e:.3g}, second launch identical {same_bits}")
        assert flipped == 0 and e <= 1e-4 and same_bits and (covered > 0 or len(faces) == 0), (name, flipped, e)
        err = max(err, e)
    for case in ("nan_z", "inf_x"):
        check_non_finite(case)
    timed = {}
    for name in ("flame 512x640", "uv spherical 256x256"):
        verts, faces, h, w = cases[name]
        vt, ft = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)
        k_ms, k_host_ms = kernel_ms(lambda: rasterize_buffers(vt, ft, h, w), flush)
        p_ms = median_ms(lambda: rasterize_buffers_reference(vt, ft, h, w), reps=5, warmup=1, flush=flush, spin=True)
        b_ms, b_by = bound(*raster_work(verts, faces, h, w))
        print(f"[rasterize] {name} ({len(faces)} faces): kernel {k_ms:.4f} ms ({k_host_ms:.4f} with the "
              f"host's dispatch), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        timed[name] = (k_ms, k_host_ms, p_ms, b_ms, b_by, len(faces))
    k_ms, k_host_ms, p_ms, b_ms, b_by, n_faces = timed["flame 512x640"]
    uv_ms, uv_host_ms, uv_plain_ms, uv_b_ms, _, uv_faces = timed["uv spherical 256x256"]
    return {"rasterize_buffers": {
        "route": "cuda", "source": "dad3dheads_tpu_torch/csrc/rasterize.cu",
        "replaces": "dad3dheads_tpu/render/rasterizer_pallas.py:120",
        "max_abs_err": err, "ms": k_ms, "ms_host": k_host_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "library_ms_host": None, "shape": f"{n_faces} faces -> 512x640",
        "uv_table": {"ms": uv_ms, "ms_host": uv_host_ms, "plain_ms": uv_plain_ms, "bound_ms": uv_b_ms,
                     "shape": f"{uv_faces} faces -> {IMG}x{IMG}"}}}


# --------------------------------------------------------------------------
# 4, 4b, 4c: the main paths
# --------------------------------------------------------------------------


def compare_predictions(out: list, ref: list, tag: str) -> None:
    """Card vs CPU, per image: 3DMM and vertices atol 1e-3, projected 0.5 px,
    points (truncated to ints after the readjustment) within 1 px."""
    tol = {"3dmm_params": 1e-3, "3d_vertices": 1e-3, "projected_vertices": 0.5, "points": 1.0}
    for key, atol in tol.items():
        gap = max(float(np.abs(np.asarray(o[key], np.float64) - np.asarray(r[key], np.float64)).max())
                  for o, r in zip(out, ref))
        print(f"[{tag}] card vs cpu {key}: max abs gap {gap:.3g} (atol {atol})")
        assert gap <= atol, (tag, key, gap)


def phase4_slice(config: dict, tag: str = "slice") -> tuple[FaceMeshPredictor, dict]:
    pred = FaceMeshPredictor(config, device="cuda", seed=SEED)
    randomize_bn_stats(pred.model, torch.Generator().manual_seed(SEED + 1))
    images = np.random.default_rng(SEED).integers(0, 256, (SLICE_B, IMG, IMG, 3), dtype=np.uint8)

    reset_launches()
    t0 = time.perf_counter()
    out = pred.predict_batch(images)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] predict_batch B={SLICE_B} (first call) {seconds:.3f} s, launches {launches}")
    assert launches["blend_shapes_fused"] >= 1 and launches["normalize_images"] >= 1, launches

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
        print(f"[{tag}] card vs cpu {key}: max abs gap {gap:.3g} (atol {atol})")
        assert gap <= atol, (key, gap)
    return pred, launches


def frames_4b_sizes(n: int) -> tuple[np.random.Generator, list]:
    """Phase 4b's generator and ``n`` frame sizes up to 1920x1080; its frames
    and boxes are ``seeded_frames`` and then ``face_boxes`` of them."""
    sizes_hw = [(512, 640), (1080, 1920), (720, 1280), (480, 854), (1080, 1440), (360, 640), (600, 800),
                (768, 1024)]
    return np.random.default_rng(SEED + 30), (sizes_hw * (n // len(sizes_hw) + 1))[:n]


def phase4b_frames(pred: FaceMeshPredictor, config: dict, n: int = FRAMES_B, tag: str = "frames",
                   device_images: bool = True) -> tuple[list, dict]:
    """predict_frames on ``n`` frames of mixed sizes against the CPU on 4;
    with ``device_images``, predict_images on a CUDA tensor too."""
    rng, sizes_hw = frames_4b_sizes(n)
    frames = seeded_frames(rng, sizes_hw)
    boxes = face_boxes(rng, sizes_hw)

    reset_launches()
    t0 = time.perf_counter()
    out = pred.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] predict_frames {n} frames up to 1920x1080 (first call) {seconds:.3f} s, "
          f"launches {launches}")
    assert launches["resample_normalize"] >= 1 and launches["blend_shapes_fused"] >= 1, launches
    assert len(out) == n
    V = pred.flame.num_vertices
    for o in out:
        assert o["points"].shape == (68, 2) and o["3dmm_params"].shape == (1, 413)
        assert o["3d_vertices"].shape == (V, 3) and o["projected_vertices"].shape == (1, V, 2)
        assert o["3dmm_params"].dtype == np.float32 and o["3d_vertices"].dtype == np.float32
        assert all(np.isfinite(v).all() for v in o.values())

    cpu = FaceMeshPredictor(config, device="cpu", seed=SEED)
    cpu.model.load_state_dict(pred.model.state_dict())
    compare_predictions(out[:4], cpu.predict_frames(frames[:4], bboxes=boxes[:4], batch_size=4), tag)
    if not device_images:
        return frames, launches

    # predict_images on a CUDA uint8 tensor: the device branch, normalize kernel
    images = torch.from_numpy(rng.integers(0, 256, (2 * FRAMES_B + 3, IMG, IMG, 3), dtype=np.uint8)).cuda()
    before = normalize_images.launches
    dev_out = pred.predict_images(images, batch_size=FRAMES_B)
    print(f"[frames] predict_images on a CUDA tensor {tuple(images.shape)}: "
          f"{normalize_images.launches - before} normalize launches")
    assert len(dev_out) == images.shape[0] and normalize_images.launches - before >= 1
    compare_predictions(dev_out[:4], cpu.predict_images(images[:4].cpu(), batch_size=4), "images")
    return frames, launches


def phase4c_render(flame: FlameModel, frame: np.ndarray) -> dict:
    # a random-weight network puts its head outside the frame, so the
    # renders draw a seeded head that fills 60% of the mesh's image
    pred = {"3dmm_params": head_params()}
    reset_launches()
    pncc = PNCCEstimator(HeadMesh(model=flame))(frame, pred)
    uv = UVTextureCreator(resolution=IMG, head_mesh=HeadMesh(model=flame))(frame, pred)
    launches = read_launches()
    print(f"[render] PNCC {pncc.shape}, UV texture {uv.shape}: launches {launches}")
    assert launches["rasterize_buffers"] >= 1, launches
    ref_pncc = PNCCEstimator(device="cpu")(frame, pred)
    ref_uv = UVTextureCreator(resolution=IMG, device="cpu")(frame, pred)
    # the mesh comes from the FLAME decode on each device, which differ by
    # float rounding: a pixel on a triangle's edge may change its coverage,
    # so at most 0.1% of the values may differ by more than one level
    for name, out, ref in (("pncc", pncc, ref_pncc), ("uv_texture", uv, ref_uv)):
        assert out.shape == ref.shape and out.dtype == np.uint8, (name, out.shape, out.dtype)
        gap = np.abs(out.astype(int) - ref.astype(int))
        far = int((gap > 1).sum())
        drawn = int((ref != 0).any(-1).sum())
        print(f"[render] {name} card vs cpu: {far} of {gap.size} values differ by more than one level "
              f"(max {gap.max()}), {drawn} pixels drawn")
        assert drawn > 0 and far <= 1e-3 * gap.size, (name, drawn, far)
    return launches


@contextlib.contextmanager
def cast_route():
    """The bf16 trunk's route before its preprocess wrote bf16: the
    predictor's normalize and resample write fp32, which autocast casts to
    bf16 before the stem conv. cuDNN deterministic, inside and out, so that
    two runs differ only by their input."""
    norm, frames = predictor_module.normalize_images, predictor_module.preprocess_frames_device
    predictor_module.normalize_images = lambda *a, **kw: norm(*a, **{**kw, "out_dtype": torch.float32})
    predictor_module.preprocess_frames_device = lambda *a, **kw: frames(*a, **{**kw, "out_dtype": torch.float32})
    try:
        yield
    finally:
        predictor_module.normalize_images, predictor_module.preprocess_frames_device = norm, frames


@contextlib.contextmanager
def cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def assert_same_outputs(new, old, tag: str) -> None:
    """Bit for bit, every key of every result."""
    pairs = list(zip(new, old)) if isinstance(new, list) else [(new, old)]
    same = all(np.array_equal(a[key], b[key]) for a, b in pairs for key in b) and len(new) == len(old)
    print(f"[bf16 route] {tag}: outputs bit for bit those of the fp32 preprocess cast by autocast {same}")
    assert same, tag


def phase5_throughput(pred: FaceMeshPredictor, config: dict, tag: str = "throughput") -> tuple[FaceMeshPredictor, dict]:
    images = np.random.default_rng(SEED + 2).integers(0, 256, (BENCH_B, IMG, IMG, 3), dtype=np.uint8)
    bf16_config = {**config, "model": {**config["model"], "dtype": "bfloat16"}}
    bf16 = FaceMeshPredictor(bf16_config, device="cuda", seed=SEED)
    bf16.model.load_state_dict(pred.model.state_dict())
    for name, p, bf16_launches in (("fp32", pred, 0), ("bf16", bf16, 1)):
        reset_launches()
        p.predict_batch(images)
        counts = (normalize_images.launches, normalize_images.bf16_launches)
        print(f"[{tag}] predict_batch B={BENCH_B} {name}: normalize launches {counts[0]}, "
              f"{counts[1]} of them writing bf16")
        assert counts == (1, bf16_launches), (name, counts)
    with cudnn_deterministic():
        new = bf16.predict_batch(images[:SLICE_B])
        with cast_route():
            old = bf16.predict_batch(images[:SLICE_B])
    assert_same_outputs(new, old, f"predict_batch B={SLICE_B}, bf16 trunk")
    outs, rates = {}, {}
    for name, p in (("fp32", pred), ("bf16", bf16)):
        ms = median_ms(lambda: outs.__setitem__(name, p.predict_batch(images)), reps=5, warmup=2)
        rates[name] = BENCH_B / ms * 1e3
        print(f"[{tag}] predict_batch B={BENCH_B} {name}: {ms:.2f} ms, {BENCH_B / ms * 1e3:.1f} img/s")
        assert all(np.isfinite(v).all() for v in outs[name].values()), name
    gap = float(np.abs(outs["bf16"]["3dmm_params"] - outs["fp32"]["3dmm_params"]).max())
    print(f"[{tag}] bf16 vs fp32 3dmm_params max abs gap {gap:.3g}")
    return bf16, rates


def phase5b_frames_throughput(pred: FaceMeshPredictor, bf16: FaceMeshPredictor, tag: str = "throughput") -> dict:
    rng = np.random.default_rng(SEED + 40)
    n = 4 * FRAMES_B
    sizes_hw = [(720, 1280)] * n
    frames = seeded_frames(rng, sizes_hw[:16]) * (n // 16)
    boxes = face_boxes(rng, sizes_hw)
    with cudnn_deterministic():
        new = bf16.predict_frames(frames[:FRAMES_B], bboxes=boxes[:FRAMES_B], batch_size=FRAMES_B)
        with cast_route():
            old = bf16.predict_frames(frames[:FRAMES_B], bboxes=boxes[:FRAMES_B], batch_size=FRAMES_B)
    assert_same_outputs(new, old, f"predict_frames {FRAMES_B} frames 1280x720, bf16 trunk")
    rates = {}
    for name, p in (("fp32", pred), ("bf16", bf16)):
        ms = median_ms(lambda: p.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B), reps=5, warmup=1)
        rates[name] = n / ms * 1e3
        print(f"[{tag}] predict_frames {n} frames 1280x720, batches of {FRAMES_B}, {name}: {ms:.2f} ms, "
              f"{n / ms * 1e3:.1f} img/s")
    # the host's part of each batch: pasting the frames into one buffer, in
    # the planar layout predict_frames uses and in NHWC, which the kernel
    # reads too
    for planar in (True, False):
        t0 = time.perf_counter()
        for lo in range(0, n, FRAMES_B):
            pack_frames_host(frames[lo : lo + FRAMES_B], boxes[lo : lo + FRAMES_B], FRAMES_B, planar=planar)
        pack_ms = (time.perf_counter() - t0) / (n // FRAMES_B) * 1e3
        print(f"[{tag}] pack_frames_host ({'planar' if planar else 'nhwc'}) per batch of {FRAMES_B}: "
              f"{pack_ms:.2f} ms")
    return rates


# --------------------------------------------------------------------------
# 3d: the blendshape backward kernel
# --------------------------------------------------------------------------


def phase3d_blend_backward(flame: FlameModel, flush: torch.Tensor) -> dict:
    """d_betas, d_template and d_shapedirs against the plain version, each
    within 1e-5 of its sum of absolute products (fp32 sums in another
    order); the same bits on a second launch; timed at the train batch."""
    dev = torch.device("cuda")
    dirs = flame.shapedirs
    L, N = dirs.shape
    gen = torch.Generator(device="cpu").manual_seed(SEED + 50)
    err = 0.0
    for B in (7, TRAIN_B, 2 * TRAIN_B):
        g = torch.randn((B, N), generator=gen).to(dev)
        betas = torch.randn((B, L), generator=gen).to(dev)
        out = blend_shapes_fused_backward(g, betas, dirs)
        again = blend_shapes_fused_backward(g, betas, dirs)
        ref = blend_shapes_fused_backward_reference(g, betas, dirs)
        scales = ((g.abs() @ dirs.abs().T).max().item(), (betas.abs().T @ g.abs()).max().item(),
                  g.abs().sum(0).max().item())
        for name, o, a, r, scale in zip(("d_betas", "d_shapedirs", "d_template"), out, again, ref, scales):
            e = (o - r).abs().max().item()
            print(f"[blend backward] B={B} {name} {tuple(o.shape)}: max abs diff {e:.3g} "
                  f"(bound 1e-5 x {scale:.3g}), second launch identical {torch.equal(o, a)}")
            assert o.shape == r.shape and torch.equal(o, a) and e <= 1e-5 * scale, (B, name, e, scale)
            err = max(err, e)

    # the train step's call: d_betas and d_template at B = 64 (FLAME is a constant)
    B = TRAIN_B
    g = torch.randn((B, N), generator=gen).to(dev)
    betas = torch.randn((B, L), generator=gen).to(dev)
    needs = (True, False, True)
    k_ms, k_host_ms = kernel_ms(lambda: blend_shapes_fused_backward(g, betas, dirs, needs), flush)
    p_ms = median_ms(lambda: blend_shapes_fused_backward_reference(g, betas, dirs, needs), flush=flush, spin=True)
    assert not torch.backends.cuda.matmul.allow_tf32
    lib_ms, lib_host_ms = kernel_ms(lambda: (torch.matmul(g, dirs.T), g.sum(0)), flush)
    all_ms = median_ms(lambda: blend_shapes_fused_backward(g, betas, dirs), flush=flush, spin=True)
    (b_ms, b_by), simt_ms = blend_bounds(4 * (B * N + L * N + B * L + N), B * L * N)
    print(f"[blend backward] B={B} d_betas + d_template: kernel {k_ms:.4f} ms ({k_host_ms:.4f} with the host's "
          f"dispatch), plain {p_ms:.4f} ms, torch.matmul + sum (fp32, TF32 off) {lib_ms:.4f} ms ({lib_host_ms:.4f} "
          f"with the host's dispatch), bound {b_ms:.4f} ms ({b_by}; fp32 outside "
          f"the tensor cores {simt_ms:.4f} ms); with d_shapedirs {all_ms:.4f} ms")
    return {"blend_shapes_fused_backward": {
        "route": "cuda", "source": "dad3dheads_tpu_torch/csrc/blendshapes_bwd.cu",
        "replaces": "dad3dheads_tpu/ops/blendshapes.py:86",
        "max_abs_err": err, "ms": k_ms, "ms_host": k_host_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_ms_host": lib_host_ms, "fp32_bound_ms": simt_ms,
        "shape": f"g ({B}, {N}) -> d_betas ({B}, {L}) + d_template ({N},)"}}


# --------------------------------------------------------------------------
# 6: the training path
# --------------------------------------------------------------------------


def _train_parity(model: dict | None = None, tag: str = "train parity", optimizer: dict | None = None) -> dict:
    """Two train steps on the card and on the CPU from the same seeded
    weights (the JAX package's initialisation of ``model``'s network, dropout 0, fp32) and one
    synthetic batch (B = 8, 256x256), with the config's Adam, clip and
    warmup. The card runs cuDNN in full fp32 (TF32 off) and
    deterministically. Tolerances: losses 1e-3 relative; grad_norm 2e-2
    (this random-init network in train mode amplifies rounding in its
    gradient; tests/test_torch_train_step.py measures it); the updates' L2
    gap under 25% of their norm (the bound tests/test_torch_train_step.py
    holds the port to against JAX); the parameter checksum (their sum)
    within 5% of the update's L1; BN statistics within 1e-3 of each tensor's
    largest value. ``optimizer`` replaces the config's. Returns the kernels'
    launches in the card's two steps."""
    from dad3dheads_tpu_torch.core import LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.train import build_train_step, init_train_state
    from dad3dheads_tpu_torch.train.config import load_config

    config = load_config("configs/train.yaml")
    warmup = int(config["scheduler"]["warmup_steps"])
    runs = {}
    batch = synthetic_batch(torch.Generator().manual_seed(SEED + 60), FlameModel.load(), LandmarkEmbedding.load(), 8, IMG)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for device in ("cpu", "cuda"):
            state = init_train_state({**(model or {}), "dropout": 0.0}, optimizer or config["optimizer"],
                                     torch.Generator().manual_seed(SEED + 61), device,
                                     float(config["gradient_clip_val"]))
            start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
            step = build_train_step(img_size=IMG, warmup_steps=warmup)
            flame = FlameModel.load(device=device)
            b = {k: v.to(device) for k, v in batch.items()}
            reset_launches()
            logs = [{k: float(v) for k, v in step(state, flame, b).items()} for _ in range(2)]
            if device == "cuda":
                launches = read_launches()
            delta = {k: (v.detach() - start[k]).cpu() for k, v in state.model.named_parameters()}
            checksum = sum(float(v.detach().double().sum()) for v in state.model.parameters())
            stats = {k: v.detach().cpu() for k, v in state.model.state_dict().items() if "running" in k}
            runs[device] = (logs, delta, checksum, stats)
    finally:
        torch.backends.cudnn.deterministic = prev
    (cl, cd, cs, cst), (gl, gd, gs, gst) = runs["cpu"], runs["cuda"]
    for i, (c, g) in enumerate(zip(cl, gl)):
        for key in ("loss", "heatmap_loss", "vertices3d_loss", "reprojection_loss", "landmarks_loss", "grad_norm"):
            rel = abs(g[key] - c[key]) / abs(c[key])
            tol = 2e-2 if key == "grad_norm" else 1e-3
            print(f"[{tag}] step {i} {key}: card {g[key]:.6f} cpu {c[key]:.6f} (rel {rel:.2e}, tol {tol})")
            assert rel <= tol, (i, key, g[key], c[key])
    gap = sum(float(((gd[k] - cd[k]) ** 2).sum()) for k in cd) ** 0.5
    norm = sum(float((cd[k] ** 2).sum()) for k in cd) ** 0.5
    stat_gap = max(float((gst[k] - cst[k]).abs().max() / (cst[k].abs().max() + 1e-12)) for k in cst)
    moved = sum(float(v.abs().sum()) for v in cd.values())
    print(f"[{tag}] parameter updates: L2 gap {gap:.3g} of norm {norm:.3g}; parameter checksum card "
          f"{gs:.6f} cpu {cs:.6f} (gap <= 5% of the update's L1 {moved:.4g}); BN statistics gap {stat_gap:.2e} "
          f"of each tensor's largest value")
    assert norm > 0 and gap <= 0.25 * norm, (gap, norm)
    assert abs(gs - cs) <= 0.05 * moved and stat_gap <= 1e-3, (gs, cs, moved, stat_gap)
    print(f"[{tag}] the card's two steps: launches {launches}")
    assert launches["blend_shapes_fused"] >= 2 and launches["blend_shapes_fused_backward"] >= 2, launches
    return launches


def _train_cli(backbone: str = "resnet50", tag: str = "train cli") -> dict:
    """cli.train main at full width (``model.backbone=backbone``) to an export
    that the port's predictor of that backbone loads; the kernels' launches
    on that run."""
    from dad3dheads_tpu_torch.cli.train import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp")
        reset_launches()
        t0 = time.perf_counter()
        train_main(["--config", "configs/train.yaml", "--synthetic", "4", "--device", "cuda",
                    "max_epochs=1", f"model.backbone={backbone}", f"experiment_dir={exp}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        print(f"[{tag}] --synthetic 4, batch {TRAIN_B}, 1 epoch: {seconds:.1f} s, launches {launches}")
        assert launches["blend_shapes_fused"] >= 1 and launches["blend_shapes_fused_backward"] >= 1, launches
        ck = os.path.join(exp, "checkpoints")
        for name in ("last.pt", "dad_3dnet.msgpack"):
            assert os.path.isfile(os.path.join(ck, name)), name
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            epoch = [json.loads(line) for line in f if "train/loss" in line][-1]
        print(f"[{tag}] epoch 0: train/loss {epoch['train/loss']:.4f}, "
              f"valid/metrics/reproject_nme_2d {epoch['valid/metrics/reproject_nme_2d']:.4f}")
        assert all(np.isfinite(v) for v in epoch.values())
        pred = FaceMeshPredictor({"img_size": IMG, "model": {"backbone": backbone}},
                                 checkpoint_path=os.path.join(ck, "dad_3dnet.msgpack"), device="cuda",
                                 require_weights=True)
        assert pred.model.backbone == backbone
        images = np.random.default_rng(SEED + 62).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
        out = pred.predict_batch(images)
        assert all(np.isfinite(v).all() for v in out.values())
        print(f"[{tag}] the port's predictor loads the export: 3dmm {out['3dmm_params'].shape}, finite")
    return launches


def _train_throughput(model: dict | None = None, tag: str = "train throughput") -> dict:
    """Train-step img/s at B = 64 and 128, fp32 and bf16 trunk, the step
    alone as bench.py's ``train_step_ips`` times it (no metric panel): after
    5 warm-up steps, CUDA events around 5 windows of 3 back-to-back steps
    on a fixed batch; the median window's rate and the slowest and fastest
    windows'. Then the kernels' launches in one step. Returns the median
    rates by (B, dtype)."""
    from dad3dheads_tpu_torch.core import LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.train import build_train_step, init_train_state

    flame, emb = FlameModel.load(device="cuda"), LandmarkEmbedding.load(device="cuda")
    step = build_train_step(img_size=IMG, warmup_steps=400, with_metrics=False)
    rates = {}
    for B in (TRAIN_B, 2 * TRAIN_B):
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(SEED + 63), flame, emb, B, IMG)
        for dtype in ("float32", "bfloat16"):
            state = init_train_state({**(model or {}), "dtype": dtype}, {"name": "adam", "lr": 1e-4},
                                     torch.Generator().manual_seed(SEED + 64), "cuda", 5.0)

            def window():
                for _ in range(3):
                    step(state, flame, batch)

            for _ in range(5):
                step(state, flame, batch)
            ips = sorted(3 * B / ms * 1e3 for ms in (median_ms(window, reps=1, warmup=0) for _ in range(5)))
            reset_launches()
            logs = step(state, flame, batch)
            launches = read_launches()
            assert np.isfinite(float(logs["loss"])), (B, dtype)
            print(f"[{tag}] B={B} {dtype}: {ips[2]:.1f} img/s (windows {ips[0]:.1f} to {ips[-1]:.1f}), "
                  f"{B / ips[2] * 1e3:.2f} ms per step; per step: {launches['blend_shapes_fused']} blendshape, "
                  f"{launches['blend_shapes_fused_backward']} blendshape backward launches; "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
            assert launches["blend_shapes_fused"] == 1 and launches["blend_shapes_fused_backward"] == 1, launches
            rates[B, dtype] = ips[2]
            del state
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return rates


def phase6_train() -> tuple[dict, dict]:
    _train_parity()
    launches = _train_cli()
    return launches, _train_throughput()


# --------------------------------------------------------------------------
# 8: the second model family, mobilenet_w1
# --------------------------------------------------------------------------


def add_launches(*runs: dict) -> dict:
    return {name: sum(r[name] for r in runs) for name in runs[0]}


def phase8_mobilenet() -> dict:
    """The mobilenet_w1 DAD-3DNet through the port's entry points, each
    entry point's launches counted from 0 and summed into this path's. Then
    its img/s. Returns the path's launches."""
    model = {"backbone": "mobilenet_w1"}
    config = {"img_size": IMG, "model": {**model, "dtype": "float32"}}
    pred, batch_launches = phase4_slice(config, "mobilenet slice")
    assert pred.model.backbone == "mobilenet_w1"
    _, frame_launches = phase4b_frames(pred, config, n=8, tag="mobilenet frames", device_images=False)
    parity_launches = _train_parity(model, "mobilenet train parity")
    cli_launches = _train_cli("mobilenet_w1", "mobilenet train cli")
    launches = add_launches(batch_launches, frame_launches, parity_launches, cli_launches)
    print(f"[mobilenet] this path's launches: {launches}")
    for name in ("normalize_images", "resample_normalize", "blend_shapes_fused", "blend_shapes_fused_backward"):
        assert launches[name] >= 1, (name, launches)

    bf16, batch_ips = phase5_throughput(pred, config, "mobilenet throughput")
    frames_ips = phase5b_frames_throughput(pred, bf16, "mobilenet throughput")
    del pred, bf16
    torch.cuda.empty_cache()
    train_ips = _train_throughput(model, "mobilenet train throughput")
    print(json.dumps({"mobilenet_path": {
        "launches": launches, "predict_batch_ips_B256": batch_ips, "predict_frames_ips_720p": frames_ips,
        "train_step_ips": {f"B{b} {dtype}": ips for (b, dtype), ips in train_ips.items()}}}))
    return launches


# --------------------------------------------------------------------------
# 7: the dataset path
# --------------------------------------------------------------------------

DATA_IMG = 128  # the acceptance run's image size
DATA_TRAIN, DATA_VAL, DATA_B = 64, 16, 32


def _dataset_overrides(root: str, img: int) -> list:
    base = os.path.join(root, "DAD-3DHeadsDataset")
    return [f"img_size={img}", f"train.ann_path={base}/train/train.json", f"train.dataset_root={base}/train",
            f"train.img_size={img}", f"val.ann_path={base}/val/val.json", f"val.dataset_root={base}/val",
            f"val.img_size={img}", "val.output_uint8=true", "val.device_heatmap=true"]


def _scorer_card_vs_cpu(gt_path: str, sub_path: str, tmp: str) -> dict:
    """The evaluator on the card and on the CPU on one submission: pose and
    NME equal, Chamfer within 1e-6 relative, Z_5 within 1e-3 per sample;
    then the time of one whole scoring (json to metrics) of a 32-item
    submission (the 16 items twice, under new ids) on each, median of 3."""
    from dad3dheads_tpu_torch.benchmark_harness import DADEvaluator

    per = {}
    for dev in ("cuda", "cpu"):
        ev = DADEvaluator(gt_path, sub_path, device=dev)
        per[dev] = ev.score_batched(*ev.load())
    for key in ("pose_error", "nme", "chamfer", "z5"):
        gap = np.abs(per["cuda"][key] - per["cpu"][key])
        rel = float((gap / np.abs(per["cpu"][key])).max())
        print(f"[dataset] scorer card vs cpu {key}: max abs gap {gap.max():.3g} (rel {rel:.3g})")
        limit = {"pose_error": 0.0, "nme": 0.0, "chamfer": 1e-6 * np.abs(per["cpu"][key]), "z5": 1e-3}[key]
        assert np.all(gap <= limit), (key, gap)
    gt, sub = json.load(open(gt_path)), json.load(open(sub_path))
    gt32 = gt + [dict(g, id=g["id"] + "_b") for g in gt]
    sub32 = {**sub, **{k + "_b": v for k, v in sub.items()}}
    gt32_path, sub32_path = os.path.join(tmp, "gt32.json"), os.path.join(tmp, "sub32.json")
    json.dump(gt32, open(gt32_path, "w"))
    json.dump(sub32, open(sub32_path, "w"))
    ms = {}
    for dev in ("cuda", "cpu"):
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            overall, _ = DADEvaluator(gt32_path, sub32_path, device=dev)()
            if dev == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[dev] = float(np.median(times[1:]))
        print(f"[dataset] scorer, {len(gt32)}-item submission on {dev}: {ms[dev]:.1f} ms (median of 3 after one), "
              f"{overall}")
    return ms


def _loader_fed_rate(root: str, flame: FlameModel, synthetic: dict) -> dict:
    """Train steps at B = 64, 256x256, fed by the port's DataLoader (uint8
    batches, device heatmaps) from the rendered 128x128 train set, its index
    repeated 5 times: steps 2-5 of the epoch, timed on the host's clock
    around the loader, the Trainer's ``device_prefetch`` (pinned copies on a
    side stream) and the step; beside phase 6's rate on a batch already on
    the card. Thread workers (the config's 16, clamped to the cores), then
    spawned process workers (one per core) beside this CUDA parent, which
    must give the same batches. Also each loader alone: ms per item over its
    second epoch."""
    from dad3dheads_tpu_torch.data.dataset import DataLoader, FlameDataset
    from dad3dheads_tpu_torch.parallel import device_prefetch, one_device_mesh
    from dad3dheads_tpu_torch.train import build_train_step, init_train_state

    base = os.path.join(root, "DAD-3DHeadsDataset", "train")
    ds = FlameDataset.from_config({"ann_path": os.path.join(base, "train.json"), "dataset_root": base,
                                   "img_size": IMG, "output_uint8": True, "device_heatmap": True})
    ds.data = ds.data * 5
    step = build_train_step(img_size=IMG, warmup_steps=400, with_metrics=False)
    rates, orders = {}, {}
    for mode, workers in (("thread", 16), ("process", os.cpu_count() or 8)):
        loader = DataLoader(ds, TRAIN_B, shuffle=True, num_workers=workers, seed=SEED, worker_mode=mode)
        orders[mode] = [[int(i) for i in b["SAMPLE_INDEX_KEY"]] for b in loader]  # the workers start
        t0 = time.perf_counter()
        n = sum(len(b["SAMPLE_INDEX_KEY"]) for b in loader)
        item_ms = (time.perf_counter() - t0) * 1e3 / n
        print(f"[dataset] loader alone, {loader.num_workers} {mode} workers, {IMG}x{IMG} from {DATA_IMG}x{DATA_IMG} "
              f"PNGs: {item_ms:.3f} ms per item (the second epoch, {n} items)")
        rates[mode] = {"loader_ms_per_item": item_ms}
        for dtype in ("float32", "bfloat16"):
            state = init_train_state({"dtype": dtype}, {"name": "adam", "lr": 1e-4},
                                     torch.Generator().manual_seed(SEED), "cuda", 5.0)
            t0, steps = None, 0
            for batch in device_prefetch(loader, one_device_mesh("cuda")):  # as the Trainer feeds its steps
                logs = step(state, flame, batch)
                if t0 is None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                else:
                    steps += 1
            torch.cuda.synchronize()
            ips = steps * TRAIN_B / (time.perf_counter() - t0)
            assert np.isfinite(float(logs["loss"])), (mode, dtype)
            print(f"[dataset] loader-fed train B={TRAIN_B} {IMG}x{IMG}, {mode} workers, {dtype}: {ips:.1f} img/s over "
                  f"{steps} steps; phase 6 on a batch already on the card: {synthetic[TRAIN_B, dtype]:.1f} img/s")
            rates[mode][dtype] = ips
            del state
            torch.cuda.empty_cache()
        loader.close()
    print(f"[dataset] process workers give the thread workers' batches: {orders['process'] == orders['thread']}")
    assert orders["process"] == orders["thread"]
    return rates


def phase7_dataset(synthetic: dict) -> dict:
    """Render a dataset on the card, train on it through cli.train, predict
    its val set through host crops and predict_frames, generate the GT and
    score on the card and the CPU; the kernels' launches on that path. Then
    the loader-fed train rate."""
    from dad3dheads_tpu_torch.cli.acceptance import evaluate_checkpoint
    from dad3dheads_tpu_torch.benchmark_harness import generate_gt
    from dad3dheads_tpu_torch.cli.make_dataset import make_dataset
    from dad3dheads_tpu_torch.cli.train import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        make_dataset(tmp, "train", DATA_TRAIN, DATA_IMG, seed=SEED, device="cuda")
        make_dataset(tmp, "val", DATA_VAL, DATA_IMG, seed=SEED + 1, device="cuda")
        t_render = time.perf_counter()
        exp = os.path.join(tmp, "exp")
        train_main(["--config", "configs/train.yaml", "--device", "cuda", "max_epochs=1", f"batch_size={DATA_B}",
                    f"experiment_dir={exp}", *_dataset_overrides(tmp, DATA_IMG)])
        torch.cuda.synchronize()
        t_train = time.perf_counter()
        ckpt = os.path.join(exp, "checkpoints", "dad_3dnet.msgpack")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            epoch = [json.loads(line) for line in f if "train/loss" in line][-1]
        assert epoch["step"] == DATA_TRAIN // DATA_B and all(np.isfinite(v) for v in epoch.values()), epoch
        gt_path = generate_gt(tmp, "val", output_dir=os.path.join(tmp, "gt"))
        host = evaluate_checkpoint(tmp, DATA_IMG, ckpt, gt_path, "host", "cuda")
        frames = evaluate_checkpoint(tmp, DATA_IMG, ckpt, gt_path, "frames", "cuda", device_preprocess=True)
        torch.cuda.synchronize()
        t_score = time.perf_counter()
        launches = read_launches()
        print(f"[dataset] rendered {DATA_TRAIN} + {DATA_VAL} images at {DATA_IMG}x{DATA_IMG} in "
              f"{t_render - t0:.1f} s; cli.train on disk, batch {DATA_B}, 1 epoch: {t_train - t_render:.1f} s "
              f"(train/loss {epoch['train/loss']:.4f}); predict + score both legs {t_score - t_train:.1f} s")
        for name, leg in (("host crops", host), ("predict_frames", frames)):
            metrics = {k: v for k, v in leg.items() if not k.startswith("_")}
            print(f"[dataset] {name}: {metrics}")
            assert all(np.isfinite(v) for v in metrics.values()), (name, metrics)
        print(f"[dataset] this path's launches: {launches}")
        assert all(n >= 1 for n in launches.values()), launches
        scorer_ms = _scorer_card_vs_cpu(gt_path, os.path.join(tmp, "submission_host.json"), tmp)
        rates = _loader_fed_rate(tmp, FlameModel.load(device="cuda"), synthetic)
    print(json.dumps({"dataset_path": {"launches": launches, "render_s": t_render - t0, "train_s": t_train - t_render,
                                       "score_s": t_score - t_train, "scorer_ms_32": scorer_ms, "loader": rates}}))
    return launches


# --------------------------------------------------------------------------
# 9: the deployment artifact
# --------------------------------------------------------------------------

IMAGES_N = 2 * FRAMES_B + 3  # predict_images: two whole chunks and a ragged one
# what the artifact's loader and server must not import
EXPORT_BLOCKED = ("dad3dheads_tpu_torch.models", "dad3dheads_tpu_torch.core.flame", "dad3dheads_tpu_torch.assets",
                  "dad3dheads_tpu", "jax", "jaxlib", "flax")
# The child: load the artifact on the card in a process that cannot import
# the models, the FLAME code and assets or JAX, serve the three entry points
# on the parent's inputs (made from the same seeds), then time predict_batch
# and predict_frames. It writes its outputs to an .npz and prints one JSON
# line: load seconds, the kernel ops' nodes in its graphs, launch counts of
# the serving run, rates.
EXPORT_CHILD = r"""
import importlib.abc, json, sys, time

BLOCKED = %r


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
import numpy as np
import torch

from dad3dheads_tpu_torch.api import ExportedFaceMeshPredictor
from dad3dheads_tpu_torch.kernel_timing import face_boxes, median_ms, seeded_frames
from dad3dheads_tpu_torch.ops.blendshapes import blend_shapes_fused, blend_shapes_fused_backward
from dad3dheads_tpu_torch.ops.preprocess import normalize_images, normalize_scale_bias
from dad3dheads_tpu_torch.ops.resample import resample_normalize

a = json.loads(sys.argv[1])
S = a["img"]
t0 = time.perf_counter()
pred = ExportedFaceMeshPredictor(a["path"], device="cuda")
load_s = time.perf_counter() - t0
targets = {name: [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
           for name, prog in pred._programs.items()}
nodes = {"decode_blend": targets["decode"].count("dad3d.blend_shapes.default"),
         "frames_resample": targets["frames"].count("dad3d.resample_normalize_u8.default"),
         "frames_plain_resample": sum("einsum" in t or "arange" in t for t in targets["frames"]),
         "pipeline_dad3d": sum(t.startswith("dad3d.") for t in targets["pipeline"])}
counted = (blend_shapes_fused, normalize_images, resample_normalize, blend_shapes_fused_backward)
for fn in counted:
    fn.launches = 0
images = np.random.default_rng(a["batch_seed"]).integers(0, 256, (a["batch"], S, S, 3), dtype=np.uint8)
batch = pred.predict_batch(images)
rng = np.random.default_rng(a["frames_seed"])
sizes = [tuple(hw) for hw in a["frame_sizes"]]
frames = seeded_frames(rng, sizes)
boxes = face_boxes(rng, sizes)
framed = pred.predict_frames(frames, bboxes=boxes, batch_size=a["frames_batch"])
imgs = list(np.random.default_rng(a["images_seed"]).integers(0, 256, (a["images"], S, S, 3), dtype=np.uint8))
imaged = pred.predict_images(imgs, batch_size=a["frames_batch"])
torch.cuda.synchronize()
launches = {fn.__name__: fn.launches for fn in counted}
raster = sys.modules.get("dad3dheads_tpu_torch.render.rasterizer")
launches["rasterize_buffers"] = raster.rasterize_buffers.launches if raster else 0
out = {"batch_" + k: v for k, v in batch.items()}
for tag, results in (("frames_", framed), ("images_", imaged)):
    out.update({tag + k: np.stack([r[k] for r in results]) for k in results[0]})
np.savez(a["out"], **out)

scale, bias = normalize_scale_bias("imagenet")
x = np.random.default_rng(a["rate_seed"]).integers(0, 256, (a["rate_batch"], S, S, 3), dtype=np.uint8)
x = x.astype(np.float32) * scale + bias
batch_ms = median_ms(lambda: pred.predict_batch(x), reps=5, warmup=2)
rng = np.random.default_rng(a["rate_frames_seed"])
n = a["rate_frames"]
sizes = [(720, 1280)] * n
frames = seeded_frames(rng, sizes[:16]) * (n // 16)
boxes = face_boxes(rng, sizes)
frames_ms = median_ms(lambda: pred.predict_frames(frames, bboxes=boxes, batch_size=a["frames_batch"]),
                      reps=5, warmup=1)
print(json.dumps({"load_s": load_s, "nodes": nodes, "launches": launches,
                  "predict_batch_ips": a["rate_batch"] / batch_ms * 1e3, "predict_frames_ips": n / frames_ms * 1e3}))
""" % (EXPORT_BLOCKED,)


def _stack(results: list) -> dict:
    return {k: np.stack([r[k] for r in results]) for k in results[0]}


def _gaps(got: dict, ref: dict, tol: dict, tag: str) -> dict:
    gaps = {}
    for key, atol in tol.items():
        gaps[key] = float(np.abs(np.asarray(got[key], np.float64) - np.asarray(ref[key], np.float64)).max())
        print(f"[{tag}] artifact vs live {key}: max abs gap {gaps[key]:.3g} (atol {atol})")
        assert got[key].shape == ref[key].shape and gaps[key] <= atol, (tag, key, got[key].shape, gaps[key])
    return gaps


def _images_reference(live: FaceMeshPredictor, images: np.ndarray, chunk: int) -> dict:
    """The live network on predict_images' chunks of network-size images,
    normalized as the artifact's host does it (``preprocess_image_np``), so
    that both run the same batches on the same bits; the readjustment of a
    network-size image is the identity up to fp32 rounding and the points'
    truncation to ints."""
    from dad3dheads_tpu_torch.ops.preprocess import preprocess_image_np

    outs = [live.predict_batch(np.stack([preprocess_image_np(im, IMG)[0] for im in images[lo : lo + chunk]]))
            for lo in range(0, len(images), chunk)]
    out = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    for key in ("3dmm_params", "projected_vertices"):  # per image: (1, 413), (1, V, 2)
        out[key] = out[key][:, None]
    return out


def _export_one(live: FaceMeshPredictor, name: str, live_ips: dict, tmp: str,
                exact: bool = False) -> tuple[dict, dict]:
    """Export ``live``'s network (its int8 mirror where it has ``quant_amax``)
    on the card, serve the artifact in a child process, hold it against
    ``live``; returns (this run's numbers, the child's launches). With
    ``exact`` the batch is normalized on the host for both, as the
    artifact's ``predict_batch`` does, and the batch and frames outputs must
    be the live predictor's bit for bit."""
    from dad3dheads_tpu_torch.api.export import export_predictor, read_meta

    path = os.path.join(tmp, f"{name}.aot.zip")
    t0 = time.perf_counter()
    export_predictor(live.model, live.flame, path, img_size=IMG, devices=("cuda",), quant_amax=live.quant_amax)
    seconds = time.perf_counter() - t0
    meta = read_meta(path)
    mb = os.path.getsize(path) / 1e6
    print(f"[export] resnet50 {name}: exported in {seconds:.1f} s ({', '.join(f'{k} {v:.2f} s' for k, v in meta['export_seconds'].items())}), "
          f"{mb:.1f} MB")
    assert meta["devices"] == ["cuda"] and meta["dtype"] == str(live.model.dtype).replace("torch.", "")
    assert meta["quantized"] == (live.quant_amax is not None), meta

    rng, sizes_hw = frames_4b_sizes(FRAMES_B)
    args = {"path": path, "img": IMG, "out": os.path.join(tmp, f"{name}.npz"), "batch": SLICE_B, "batch_seed": SEED,
            "frame_sizes": sizes_hw, "frames_seed": SEED + 30, "frames_batch": FRAMES_B, "images": IMAGES_N,
            "images_seed": SEED + 90, "rate_batch": BENCH_B, "rate_seed": SEED + 2, "rate_frames": 4 * FRAMES_B,
            "rate_frames_seed": SEED + 40}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, json.dumps(args)], capture_output=True, text=True,
                          timeout=600)
    child_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-6000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[export] {name}: child process {child_s:.1f} s (artifact loaded in {report['load_s']:.2f} s), "
          f"graph nodes {report['nodes']}, launches {report['launches']}")
    nodes, launches = report["nodes"], report["launches"]
    assert nodes["decode_blend"] == 1 and nodes["frames_resample"] == 1, nodes
    assert nodes["frames_plain_resample"] == 0 and nodes["pipeline_dad3d"] == 0, nodes
    assert launches["blend_shapes_fused"] >= 1 and launches["resample_normalize"] >= 1, launches
    assert launches["normalize_images"] == launches["blend_shapes_fused_backward"] == 0, launches
    assert launches["rasterize_buffers"] == 0, launches

    got = dict(np.load(args["out"]))
    pick = lambda prefix: {k[len(prefix):]: v for k, v in got.items() if k.startswith(prefix)}
    images = np.random.default_rng(SEED).integers(0, 256, (SLICE_B, IMG, IMG, 3), dtype=np.uint8)
    batch_tol = {"3dmm_params": 1e-3, "3d_vertices": 1e-3, "points": 0.5, "projected_vertices": 0.5}
    frames_tol = {**batch_tol, "points": 1.0}  # integers after the readjustment
    if exact:
        scale, bias = normalize_scale_bias("imagenet")
        images = images.astype(np.float32) * scale + bias
    exact_tol = {k: 0.0 for k in batch_tol}
    gaps = {"predict_batch": _gaps(pick("batch_"), live.predict_batch(images), exact_tol if exact else batch_tol,
                                   f"export {name} batch")}
    frames, boxes = seeded_frames(rng, sizes_hw), face_boxes(rng, sizes_hw)
    frames_ref = _stack(live.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B))
    gaps["predict_frames"] = _gaps(pick("frames_"), frames_ref, exact_tol if exact else frames_tol,
                                   f"export {name} frames")
    imgs = np.random.default_rng(SEED + 90).integers(0, 256, (IMAGES_N, IMG, IMG, 3), dtype=np.uint8)
    gaps["predict_images"] = _gaps(pick("images_"), _images_reference(live, imgs, FRAMES_B), frames_tol,
                                   f"export {name} images")
    print(f"[export] {SMI}: {name} artifact predict_batch B={BENCH_B} (pre-normalized fp32) "
          f"{report['predict_batch_ips']:.1f} img/s, live {live_ips['batch']:.1f} img/s on the same batch, phase 5 "
          f"(uint8) {live_ips['phase5']:.1f}; predict_frames {4 * FRAMES_B} frames 1280x720 "
          f"{report['predict_frames_ips']:.1f} img/s, phase 5b live {live_ips['frames']:.1f}")
    numbers = {"export_s": seconds, "export_seconds": meta["export_seconds"], "artifact_mb": mb,
               "load_s": report["load_s"], "child_s": child_s, "gaps": gaps,
               "predict_batch_ips": report["predict_batch_ips"], "live_predict_batch_ips_fp32_input": live_ips["batch"],
               "predict_frames_ips": report["predict_frames_ips"]}
    return numbers, launches


def _train_export_aot(tmp: str) -> dict:
    """cli.train at full width with ``export_aot=true``: the artifact beside
    the msgpack, with programs for the card and the CPU, loads on the card and
    serves what the msgpack gives the live predictor."""
    from dad3dheads_tpu_torch.api.export import ExportedFaceMeshPredictor, read_meta
    from dad3dheads_tpu_torch.cli.train import main as train_main

    exp = os.path.join(tmp, "exp")
    t0 = time.perf_counter()
    train_main(["--config", "configs/train.yaml", "--synthetic", "4", "--device", "cuda", "max_epochs=1",
                "export_aot=true", f"experiment_dir={exp}"])
    seconds = time.perf_counter() - t0
    ck = os.path.join(exp, "checkpoints")
    aot = os.path.join(ck, "dad_3dnet.aot.zip")
    meta = read_meta(aot)
    print(f"[export] cli.train --synthetic 4 export_aot=true: {seconds:.1f} s, artifact {os.path.getsize(aot) / 1e6:.1f} MB "
          f"for {meta['devices']}, traces {', '.join(f'{k} {v:.2f} s' for k, v in meta['export_seconds'].items())}")
    assert meta["devices"] == ["cuda", "cpu"] and meta["img_size"] == IMG
    images = np.random.default_rng(SEED + 62).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    got = ExportedFaceMeshPredictor(aot, device="cuda").predict_batch(images)
    live = FaceMeshPredictor({"img_size": IMG}, checkpoint_path=os.path.join(ck, "dad_3dnet.msgpack"), device="cuda",
                             require_weights=True)
    gaps = _gaps(got, live.predict_batch(images), {"3dmm_params": 1e-3, "3d_vertices": 1e-3, "points": 0.5,
                                                    "projected_vertices": 0.5}, "export train")
    return {"train_s": seconds, "export_seconds": meta["export_seconds"], "gaps": gaps}


def phase9_export(config: dict, phase5_ips: dict, phase5b_ips: dict) -> dict:
    """The deployment artifact at the resnet50's full width, fp32 and the
    bf16 trunk: exported on the card, served from a child process that
    cannot import the models, held against the live predictor; then
    cli.train's export_aot. Returns the path's launches (both children)."""
    pred = FaceMeshPredictor(config, device="cuda", seed=SEED)
    randomize_bn_stats(pred.model, torch.Generator().manual_seed(SEED + 1))
    bf16 = FaceMeshPredictor({**config, "model": {**config["model"], "dtype": "bfloat16"}}, device="cuda", seed=SEED)
    bf16.model.load_state_dict(pred.model.state_dict())
    x = np.random.default_rng(SEED + 2).integers(0, 256, (BENCH_B, IMG, IMG, 3), dtype=np.uint8)
    x = x.astype(np.float32) * normalize_scale_bias("imagenet")[0] + normalize_scale_bias("imagenet")[1]
    numbers, runs = {}, []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, live in (("fp32", pred), ("bf16", bf16)):
            live_ips = {"batch": BENCH_B / median_ms(lambda: live.predict_batch(x), reps=5, warmup=2) * 1e3,
                        "phase5": phase5_ips[name], "frames": phase5b_ips[name]}
            numbers[name], launches = _export_one(live, name, live_ips, tmp)
            runs.append(launches)
        del pred, bf16
        torch.cuda.empty_cache()
        numbers["train_export_aot"] = _train_export_aot(tmp)
    launches = add_launches(*runs)
    print(f"[export] this path's launches: {launches}; phase 9 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"export_path": {"launches": launches, **numbers}}))
    return launches


# --------------------------------------------------------------------------
# 10: int8 inference
# --------------------------------------------------------------------------

# (batch, size, cin, cout, kernel, stride) of int8 conv sites at 256x256: the
# stem (K 147 -> 152), a 3x3 stride-2 conv (stage 2's first), the fusion conv
# (K 1,348 -> 1,352), the heatmap head (N 68 -> 72), BiFPN's p7 at batch 1
# (M = 4 rows, padded past 16), and stage 4's 3x3 depth at the int8 extremes
# (sums of 4,608 products of 127 * 127, past 2**24)
INT8_SITES = {
    "stem 7x7/2": (8, 256, 3, 64, 7, 2),
    "stage2 3x3/2": (8, 64, 128, 128, 3, 2),
    "fusion 1x1 K=1348": (8, 16, 1348, 1024, 1, 1),
    "heatmap head N=68": (8, 64, 256, 68, 3, 1),
    "p7 3x3/2 at B=1 (M=4)": (1, 4, 256, 256, 3, 2),
    "stage4 3x3 at +-127": (2, 8, 512, 512, 3, 1),
}
INT8_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _int8_route() -> None:
    """The im2col + ``torch._int_mm`` route's int32 sums on the card, bit
    for bit a float64 convolution of the same int8 values (exact below
    2**53), at the sites' shapes."""
    from dad3dheads_tpu_torch.models.quant import conv_int8_accumulator, conv_int8_accumulator_reference, gemm_weight

    rng = np.random.default_rng(SEED + 100)
    for name, (B, S, C, N, k, stride) in INT8_SITES.items():
        x = rng.integers(-127, 128, (B, S, S, C), dtype=np.int8)
        kq = rng.integers(-127, 128, (N, C, k, k), dtype=np.int8)
        if "127" in name:
            x[:] = 127
            kq = np.where(kq >= 0, 127, -127).astype(np.int8)
            kq[0] = 127  # its interior sums: 4,608 * 127 * 127 = 74,322,432
        x, kq = torch.from_numpy(x).cuda(), torch.from_numpy(kq).cuda()
        got = conv_int8_accumulator(x, gemm_weight(kq), k, stride, k // 2)[..., :N]
        ref = conv_int8_accumulator_reference(x, kq, stride, k // 2)
        same = got.dtype == torch.int32 and torch.equal(got, ref)
        print(f"[int8] _int_mm route, {name}: int32 sums {tuple(got.shape)}, largest |sum| {int(ref.abs().max())}, "
              f"bit for bit the float64 conv {same}")
        assert same, name


def _int8_calibration(card: FaceMeshPredictor, cpu: FaceMeshPredictor, images: np.ndarray) -> dict:
    """``calibrate`` on phase 4's 64 images (two batches of 32) on the card
    and on the CPU, fp32 and bf16: the card's tables, and the gaps. fp32 at
    rtol 1e-5; bf16 rounds every activation to 8 bits before its max, so
    only its spread is printed (and held under 5%)."""
    from dad3dheads_tpu_torch.models.quantized import calibrate

    x = normalize_images(torch.from_numpy(images).cuda())
    tables = {}
    for name, dtype in INT8_DTYPES.items():
        t0 = time.perf_counter()
        on_card = calibrate(card.model, [x[: SLICE_B // 2], x[SLICE_B // 2 :]], dtype=dtype)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_cpu = calibrate(cpu.model, [x[: SLICE_B // 2].cpu(), x[SLICE_B // 2 :].cpu()], dtype=dtype)
        rel = max(abs(on_card[k].item() - on_cpu[k].item()) / on_cpu[k].item() for k in on_cpu)
        print(f"[int8] calibrate {name}, 64 images: {len(on_card)} sites, card {card_s:.2f} s, "
              f"largest relative gap to the CPU's amax {rel:.3g}")
        assert sorted(on_card) == sorted(on_cpu) and len(on_card) == 168, name
        assert rel <= (1e-5 if dtype == torch.float32 else 5e-2), (name, rel)
        tables[name] = on_card
    return tables


def _drift(out: dict, ref: dict) -> tuple[float, float, float]:
    """The int8 path against the float one: landmark displacement (max,
    mean, px) and the largest 3DMM gap."""
    disp = np.linalg.norm(np.asarray(out["points"], np.float64) - np.asarray(ref["points"], np.float64), axis=-1)
    return float(disp.max()), float(disp.mean()), float(np.abs(out["3dmm_params"] - ref["3dmm_params"]).max())


def _int8_serve(name: str, config: dict, ck: str, amax: dict, images: np.ndarray, frames: list, boxes: list,
                rates: dict) -> tuple[FaceMeshPredictor, dict]:
    """One dtype: the int8 predictor on the card against the CPU through
    predict_batch, __call__ and predict_frames (phase 4's tolerances), its
    drift from the float path, this path's launches, and its img/s."""
    cfg = {**config, "model": {**config["model"], "dtype": "float32" if name == "fp32" else "bfloat16"}}
    card = FaceMeshPredictor({**cfg, "quant_amax": amax}, checkpoint_path=ck, device="cuda")
    cpu = FaceMeshPredictor({**cfg, "quant_amax": amax}, checkpoint_path=ck, device="cpu")
    tag = f"int8 {name}"

    reset_launches()
    out = card.predict_batch(images)
    batch_launches = read_launches()
    print(f"[{tag}] predict_batch B={SLICE_B}: launches {batch_launches}")
    assert batch_launches["normalize_images"] >= 1 and batch_launches["blend_shapes_fused"] >= 1, batch_launches
    assert all(np.isfinite(v).all() for v in out.values()) and out["points"].shape == (SLICE_B, 68, 2)
    ref = cpu.predict_batch(images[:4])
    for key, atol in {"3dmm_params": 1e-3, "3d_vertices": 1e-3, "points": 0.5, "projected_vertices": 0.5}.items():
        gap = float(np.abs(out[key][:4] - ref[key]).max())
        print(f"[{tag}] predict_batch card vs cpu {key}: max abs gap {gap:.3g} (atol {atol})")
        assert gap <= atol, (tag, key, gap)
    image = np.random.default_rng(SEED + 110).integers(0, 256, (300, 220, 3), dtype=np.uint8)
    compare_predictions([card(image)], [cpu(image)], f"{tag} __call__")

    reset_launches()
    framed = card.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B)
    frame_launches = read_launches()
    print(f"[{tag}] predict_frames {len(frames)} frames: launches {frame_launches}")
    assert frame_launches["resample_normalize"] >= 1 and frame_launches["blend_shapes_fused"] >= 1, frame_launches
    compare_predictions(framed[:4], cpu.predict_frames(frames[:4], bboxes=boxes[:4], batch_size=4), f"{tag} frames")
    del cpu

    float_path = FaceMeshPredictor(cfg, checkpoint_path=ck, device="cuda")
    batch_drift = _drift(out, float_path.predict_batch(images))
    frames_drift = _drift(_stack(framed), _stack(float_path.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B)))
    del float_path
    for what, (dmax, dmean, mm) in (("predict_batch", batch_drift), ("predict_frames", frames_drift)):
        print(f"[{tag}] {what} against the {name} float path: landmark displacement max {dmax:.3f} px, "
              f"mean {dmean:.3f} px; 3DMM drift max {mm:.4f}")

    x = np.random.default_rng(SEED + 2).integers(0, 256, (BENCH_B, IMG, IMG, 3), dtype=np.uint8)
    batch_ips = BENCH_B / median_ms(lambda: card.predict_batch(x), reps=5, warmup=2) * 1e3
    rng = np.random.default_rng(SEED + 40)
    n = 4 * FRAMES_B
    sizes_hw = [(720, 1280)] * n
    rate_frames = seeded_frames(rng, sizes_hw[:16]) * (n // 16)
    rate_boxes = face_boxes(rng, sizes_hw)
    frames_ips = n / median_ms(lambda: card.predict_frames(rate_frames, bboxes=rate_boxes, batch_size=FRAMES_B),
                               reps=5, warmup=1) * 1e3
    print(f"[{tag}] {SMI}: predict_batch B={BENCH_B} uint8 {batch_ips:.1f} img/s (phase 5, not int8: "
          f"{rates['phase5'][name]:.1f}); predict_frames {n} frames 1280x720 {frames_ips:.1f} img/s "
          f"(phase 5b: {rates['phase5b'][name]:.1f})")
    numbers = {"predict_batch_ips": batch_ips, "predict_frames_ips": frames_ips,
               "drift_predict_batch": batch_drift, "drift_predict_frames": frames_drift,
               "launches": add_launches(batch_launches, frame_launches)}
    return card, numbers


def phase10_int8(config: dict, phase5_ips: dict, phase5b_ips: dict) -> dict:
    """int8 inference of the resnet50 at 256x256, nothing cut, on phase 4's
    weights (through a checkpoint): the _int_mm route against float64,
    calibration on the card and the CPU, the int8 predictor in fp32 and bf16
    against the CPU, its drift, launches and img/s, and the fp32 int8
    artifact served from a child process with a gap of 0. Returns the
    path's launches (predict_batch and predict_frames, both dtypes)."""
    from dad3dheads_tpu_torch.weights import flax_from_state_dict, save_flax_msgpack

    t0 = time.perf_counter()
    _int8_route()
    fp = FaceMeshPredictor(config, device="cuda", seed=SEED)
    randomize_bn_stats(fp.model, torch.Generator().manual_seed(SEED + 1))
    images = np.random.default_rng(SEED).integers(0, 256, (SLICE_B, IMG, IMG, 3), dtype=np.uint8)
    rng, sizes_hw = frames_4b_sizes(FRAMES_B)
    frames, boxes = seeded_frames(rng, sizes_hw), face_boxes(rng, sizes_hw)
    numbers, runs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        ck = save_flax_msgpack(flax_from_state_dict(fp.model.state_dict()), os.path.join(tmp, "phase4.msgpack"))
        cpu = FaceMeshPredictor(config, checkpoint_path=ck, device="cpu")
        tables = _int8_calibration(fp, cpu, images)
        del fp, cpu
        rates = {"phase5": phase5_ips, "phase5b": phase5b_ips}
        for name in INT8_DTYPES:
            live, numbers[name] = _int8_serve(name, config, ck, tables[name], images, frames, boxes, rates)
            runs.append(numbers[name]["launches"])
            if name == "fp32":
                x = np.random.default_rng(SEED + 2).integers(0, 256, (BENCH_B, IMG, IMG, 3), dtype=np.uint8)
                x = x.astype(np.float32) * normalize_scale_bias("imagenet")[0] + normalize_scale_bias("imagenet")[1]
                live_ips = {"batch": BENCH_B / median_ms(lambda: live.predict_batch(x), reps=5, warmup=2) * 1e3,
                            "phase5": numbers[name]["predict_batch_ips"], "frames": numbers[name]["predict_frames_ips"]}
                numbers["artifact_int8_fp32"], child_launches = _export_one(live, "int8_fp32", live_ips, tmp, exact=True)
                numbers["artifact_int8_fp32"]["child_launches"] = child_launches
            del live
            torch.cuda.empty_cache()
    launches = add_launches(*runs)
    print(f"[int8] this path's launches: {launches}; phase 10 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"int8_path": {"launches": launches, **numbers}}))
    return launches


# --------------------------------------------------------------------------
# 11: the rest of training
# --------------------------------------------------------------------------

# the auto_bs probe's cap: at B = 2048 and 256x256 the stem's output passes
# 2**31 elements, which is no out-of-memory error
AUTO_BS_MAX = 1024
LAMB = {"name": "lamb", "lr": 1e-4, "weight_decay": 1e-2}


class _Recorder:
    """TensorBoard's writer in memory (scalars and image shapes), for a
    machine where ``torch.utils.tensorboard`` does not import."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, img.shape, step))

    def flush(self):
        pass


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _blend_pair_at(flame: FlameModel, B: int) -> float:
    """The blendshape forward (phase 3's bounds) and backward (phase 3d's)
    at batch ``B`` against their plain versions, each the same bits on a
    second launch; returns the largest forward gap."""
    dirs, template = flame.shapedirs, flame.v_template
    gen = torch.Generator(device="cpu").manual_seed(SEED + 110)
    betas = torch.randn((B, dirs.shape[0]), generator=gen).to("cuda")
    out, again = blend_shapes_fused(betas, dirs, template), blend_shapes_fused(betas, dirs, template)
    ref = blend_shapes_fused_reference(betas, dirs, template)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"[rest of training] blendshapes B={B}: max abs diff {err:.3g} (rel {rel:.3g}), second launch identical "
          f"{torch.equal(out, again)}")
    assert err <= 1e-4 and rel <= 1e-5 and torch.equal(out, again), (B, err, rel)
    g = torch.randn((B, dirs.shape[1]), generator=gen).to("cuda")
    out, again = blend_shapes_fused_backward(g, betas, dirs), blend_shapes_fused_backward(g, betas, dirs)
    ref = blend_shapes_fused_backward_reference(g, betas, dirs)
    scales = ((g.abs() @ dirs.abs().T).max().item(), (betas.abs().T @ g.abs()).max().item(),
              g.abs().sum(0).max().item())
    for name, o, a, r, scale in zip(("d_betas", "d_shapedirs", "d_template"), out, again, ref, scales):
        e = (o - r).abs().max().item()
        print(f"[rest of training] blend backward B={B} {name}: max abs diff {e:.3g} (bound 1e-5 x {scale:.3g}), "
              f"second launch identical {torch.equal(o, a)}")
        assert o.shape == r.shape and torch.equal(o, a) and e <= 1e-5 * scale, (B, name, e, scale)
    return err


def _panels_card_vs_cpu(state) -> dict:
    """The panel forward on 8 seeded uint8 images at 256x256 (the normalize
    kernel on the card), card against the CPU on the same weights: images
    equal, the heatmap map within one level, the landmarks within 1e-3."""
    import copy
    import types

    from dad3dheads_tpu_torch.constants import INPUT_IMAGE_KEY, TARGET_2D_LANDMARKS
    from dad3dheads_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 111)
    batch = {INPUT_IMAGE_KEY: torch.from_numpy(rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)),
             TARGET_2D_LANDMARKS: torch.from_numpy(rng.uniform(0.1, 0.9, (8, 68, 2)).astype(np.float32))}
    state.model.train()  # as the train step leaves it (fit ends on a validation)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer({"img_size": IMG, "experiment_dir": tmp}, flame=FlameModel.load(), device="cpu")
        card = [t.cpu() for t in trainer.panel_forward(state, {k: v.cuda() for k, v in batch.items()})]
        cpu_state = types.SimpleNamespace(model=copy.deepcopy(state.model).cpu())
        ref = trainer.panel_forward(cpu_state, batch)
    assert state.model.training and cpu_state.model.training
    gaps = {"images": int((card[0].int() - ref[0].int()).abs().max()),
            "heatmap_levels": int((card[1].int() - ref[1].int()).abs().max()),
            "landmarks": float((card[2] - ref[2]).abs().max())}
    print(f"[rest of training] panel forward, card against CPU: {gaps}")
    assert gaps["images"] == 0 and gaps["heatmap_levels"] <= 1 and gaps["landmarks"] <= 1e-3, gaps
    return gaps


def phase11_rest_of_training() -> dict:
    """lamb's two train steps card against CPU; then a full-width Trainer
    with auto_bs, auto_lr, image panels and async checkpoints on synthetic
    batches; the blendshape pair at every probed batch; the panel forward
    card against CPU; the async checkpoints against synchronous saves. Returns
    the Trainer's launches (the tuners' probes and sweep, the fit)."""
    from dad3dheads_tpu_torch.cli.train import SyntheticLoader
    from dad3dheads_tpu_torch.core import LandmarkEmbedding
    from dad3dheads_tpu_torch.train.checkpoint import CheckpointManager
    from dad3dheads_tpu_torch.train.config import load_config
    from dad3dheads_tpu_torch.train.loop import Trainer, _is_oom

    t0 = time.perf_counter()
    lamb_launches = _train_parity(tag="lamb parity", optimizer=LAMB)
    flame, emb = FlameModel.load(device="cuda"), LandmarkEmbedding.load(device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp")
        config = load_config("configs/train.yaml", [
            f"experiment_dir={exp}", "max_epochs=2", "auto_lr=true", "auto_lr_steps=8", "auto_bs=true",
            f"auto_bs_max={AUTO_BS_MAX}", "images_log_freq=2", "async_checkpoint=true"])
        # cli.train --synthetic 4's loaders: 4 train batches an epoch, 1 val batch
        trainer = Trainer(config, SyntheticLoader(flame, emb, TRAIN_B, IMG, 4, 0, "cuda"),
                          SyntheticLoader(flame, emb, TRAIN_B, IMG, 1, 1, "cuda"), flame=flame, device="cuda")
        writer = "torch.utils.tensorboard"
        if not trainer._tb_writer():
            trainer._tb, writer = _Recorder(), "an in-memory recorder (torch.utils.tensorboard does not import)"
        probes, probe = [], trainer._probe

        def recorded(sample, bs0, bs):
            torch.cuda.reset_peak_memory_stats()
            try:
                probe(sample, bs0, bs)
            except Exception as e:
                probes.append((bs, "out of memory" if _is_oom(e) else type(e).__name__,
                               torch.cuda.max_memory_allocated()))
                raise
            probes.append((bs, "ran", torch.cuda.max_memory_allocated()))

        trainer._probe = recorded
        reset_launches()
        t_fit = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        launches = read_launches()
        peak_after = torch.cuda.max_memory_allocated()
        tuned_bs, tuned_lr = trainer.tuned_batch_size, trainer.tuned_lr
        oom = any(outcome == "out of memory" for _, outcome, _ in probes)
        print(f"[rest of training] {SMI}: auto_bs probes (batch, outcome, peak GiB): "
              f"{[(b, o, round(m / 2**30, 2)) for b, o, m in probes]}; tuned batch {tuned_bs}; out of memory "
              f"caught {oom}, then fit ran {state.step} steps; tuned lr {tuned_lr:.4g} (base "
              f"{trainer.base_lr:.4g}); max_memory_allocated since the last probe began {peak_after / 2**30:.2f} "
              f"GiB; fit {fit_s:.1f} s; writer {writer}; launches {launches}")
        assert all(o in ("ran", "out of memory") for _, o, _ in probes), probes
        assert tuned_bs == max(b for b, o, _ in probes if o == "ran") and state.step == 8, (tuned_bs, state.step)
        assert tuned_lr is not None and 1e-6 <= tuned_lr <= 1.0
        assert launches["blend_shapes_fused"] >= 1 and launches["blend_shapes_fused_backward"] >= 1, launches
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f if "train/loss" in line]
        assert len(epochs) == 2 and all(np.isfinite(v) for e in epochs for v in e.values()), epochs
        if isinstance(trainer._tb, _Recorder):
            images = [(tag, step) for tag, _, step in trainer._tb.images]
        else:
            from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

            acc = EventAccumulator(os.path.join(exp, "tb"))
            acc.Reload()
            images = [(tag, e.step) for tag in acc.Tags()["images"] for e in acc.Images(tag)]
        print(f"[rest of training] panels written: {sorted(images)}")
        assert sorted(images) == sorted((t, s) for t in ("train/heatmap", "train/landmarks") for s in (2, 4, 6, 8))

        # the async last.pt against a synchronous save of the same state, and
        # the host time of a save each way
        sync = CheckpointManager(os.path.join(tmp, "sync"), monitor=trainer.ckpt.monitor)
        t_sync = time.perf_counter()
        sync.save(state, state.epoch, {})
        sync_s = time.perf_counter() - t_sync
        again = CheckpointManager(os.path.join(tmp, "async"), monitor=trainer.ckpt.monitor, async_save=True)
        t_async = time.perf_counter()
        again.save(state, state.epoch, {})
        async_s = time.perf_counter() - t_async
        again.flush()
        same = (_same_bytes(os.path.join(exp, "checkpoints", "last.pt"), sync.last_path),
                _same_bytes(again.last_path, sync.last_path))
        mb = os.path.getsize(sync.last_path) / 1e6
        print(f"[rest of training] {SMI}: save of the {mb:.1f} MB state on the host's clock: synchronous "
              f"{sync_s * 1e3:.1f} ms, async {async_s * 1e3:.1f} ms (the rest on the writer thread); the fit's "
              f"async last.pt and a second async save byte for byte the synchronous one: {same}")
        assert all(same), same
        # every batch the probes asked for: the tuned one, and the one past it,
        # whose probe may have run out of memory before its decode
        probed = sorted({b for b, _, _ in probes})
        blend_err = max(_blend_pair_at(flame, B) for B in probed)
        panels = _panels_card_vs_cpu(state)
        del trainer, state
    torch.cuda.empty_cache()
    numbers = {"probes": [{"batch": b, "outcome": o, "peak_bytes": m} for b, o, m in probes], "tuned_batch": tuned_bs,
               "tuned_lr": tuned_lr, "oom_caught": oom, "fit_s": fit_s, "writer": writer, "sync_save_s": sync_s,
               "async_save_s": async_s, "last_pt_mb": mb, "blend_pair_batches": probed, "blend_err": blend_err,
               "panel_gaps": panels,
               "lamb_parity_launches": lamb_launches}
    print(f"[rest of training] phase 11 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"rest_of_training_path": {"launches": launches, **numbers}}))
    return launches

# --------------------------------------------------------------------------
# 12: parallel
# --------------------------------------------------------------------------

PARALLEL_MODEL = {"backbone": "resnet50", "dtype": "float32", "dropout": 0.0}
# the child of 12a: cli.train's main, then its process's launches on a line
CLI_CHILD = """
import json, sys
from dad3dheads_tpu_torch.cli.train import main
from dad3dheads_tpu_torch.ops import blendshapes
main(sys.argv[1:])
print("LAUNCHES " + json.dumps({"blend_shapes_fused": blendshapes.blend_shapes_fused.launches,
                                "blend_shapes_fused_backward": blendshapes.blend_shapes_fused_backward.launches}))
"""


def _cli_child(exp: str, distributed: bool) -> tuple[float, dict]:
    """``cli.train --synthetic 4`` at full width, batch 64, one epoch, dropout
    0, in a child process; with ``distributed``, as torchrun starts a world
    of one (NCCL on cuda:0). Returns its seconds and launches."""
    from tests.torch_parallel_worker import free_port

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    args = ["--config", "configs/train.yaml", "--synthetic", "4", "--device", "cuda", "max_epochs=1",
            "model.dropout=0.0", f"experiment_dir={exp}"]
    if distributed:
        env.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        args.append("distributed=true")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_CHILD, *args], env=env, capture_output=True, text=True,
                          timeout=400)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    if distributed:
        assert "rank 0 of 1 on cuda:0" in proc.stderr, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("LAUNCHES ")][-1]
    return seconds, json.loads(line[len("LAUNCHES "):])


def _update_gaps(start: dict, got: dict, ref: dict) -> tuple[float, float, float]:
    """The L2 gap of two updates of ``start``'s parameters, the reference
    update's L2 norm, and the largest BN-statistics gap over each tensor's
    largest value."""
    keys = [k for k in start if "running" not in k and "num_batches" not in k]
    gap = sum(float(((got[k].double() - ref[k].double()) ** 2).sum()) for k in keys) ** 0.5
    norm = sum(float(((ref[k].double() - start[k].double()) ** 2).sum()) for k in keys) ** 0.5
    stats = max(float((got[k] - ref[k]).abs().max() / (ref[k].abs().max() + 1e-12)) for k in start
                if "running" in k)
    return gap, norm, stats


def _parallel_cli(tmp: str) -> dict:
    """12a: ``cli.train distributed=true`` in a world of one on NCCL against
    the same run without it: the epoch's train, valid and best-checkpoint
    losses within 1e-3 relative, the fit's update of every parameter (from
    the config's seeded init to ``last.pt``) within 25% of its norm, BN
    statistics within 1e-3 of each tensor's largest value (phase 6's
    tolerances)."""
    from dad3dheads_tpu_torch.models import create_model
    from dad3dheads_tpu_torch.train.config import load_config

    runs = {}
    for name, distributed in (("plain", False), ("distributed", True)):
        exp = os.path.join(tmp, name)
        seconds, launches = _cli_child(exp, distributed)
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        last = torch.load(os.path.join(exp, "checkpoints", "last.pt"), map_location="cpu", weights_only=True)
        runs[name] = (lines, last["model"], launches)
        print(f"[parallel a] cli.train --synthetic 4 {name}: {seconds:.1f} s, {len(lines)} metrics lines, "
              f"launches {launches}")
        assert launches["blend_shapes_fused"] >= 4 and launches["blend_shapes_fused_backward"] == 4, launches
    (pl, psd, _), (dl, dsd, launches) = runs["plain"], runs["distributed"]
    assert len(pl) == len(dl) == 2, (pl, dl)
    for key in ("train/loss", "train/heatmap_loss", "train/vertices3d_loss", "valid/loss", "best/loss"):
        line = 0 if not key.startswith("best") else 1
        a, b = dl[line][key], pl[line][key]
        print(f"[parallel a] {key}: distributed {a:.6f} plain {b:.6f} (rel {abs(a - b) / abs(b):.2e}, tol 1e-3)")
        assert abs(a - b) <= 1e-3 * abs(b), (key, a, b)
    config = load_config("configs/train.yaml")
    start = create_model({**config.get("model", {}), "dropout": 0.0},
                         torch.Generator().manual_seed(int(config.get("seed", 0)))).state_dict()
    gap, norm, stats = _update_gaps(start, dsd, psd)
    print(f"[parallel a] the fit's update: L2 gap {gap:.3g} of norm {norm:.3g}; BN statistics gap {stats:.2e}")
    assert 0 < norm and gap <= 0.25 * norm and stats <= 1e-3, (gap, norm, stats)
    return launches


def _parallel_inputs(tmp: str, batch: int) -> tuple[dict, dict]:
    """12b/d: the seeded resnet50 (dropout 0) and a synthetic global batch
    at 256x256, saved where the worker ranks read them."""
    from dad3dheads_tpu_torch.core import LandmarkEmbedding
    from dad3dheads_tpu_torch.data.synthetic import synthetic_batch
    from dad3dheads_tpu_torch.models import create_model

    start = create_model(PARALLEL_MODEL, torch.Generator().manual_seed(SEED + 120)).state_dict()
    data = synthetic_batch(torch.Generator().manual_seed(SEED + 121), FlameModel.load(), LandmarkEmbedding.load(),
                           batch, IMG)
    torch.save(start, os.path.join(tmp, "state.pt"))
    torch.save(data, os.path.join(tmp, "batch.pt"))
    return start, data


def _parallel_spec() -> dict:
    from dad3dheads_tpu_torch.train.config import load_config

    config = load_config("configs/train.yaml")
    return {"model": PARALLEL_MODEL, "optimizer": config["optimizer"], "clip": float(config["gradient_clip_val"]),
            "warmup": int(config["scheduler"]["warmup_steps"]), "img_size": IMG}


def _parallel_step(tmp: str) -> dict:
    """12b: two gloo ranks sharing cuda:0, each on half of a global batch of
    16, two data-parallel steps, against one process on the whole batch
    (cuDNN deterministic on both): the step-0 loss within 1e-5 relative, its
    other losses within 1e-3 and grad_norm within 2e-2; after the first
    step the update within 25% of its norm and the BN statistics within
    1e-3 of each tensor's largest value (phase 6's); the second step's
    losses within 10% (trajectory only: tests/test_distributed_multiprocess.py)."""
    from dad3dheads_tpu_torch.models import create_model
    from dad3dheads_tpu_torch.train import TrainState, build_train_step, get_optimizer
    from tests.torch_parallel_worker import World

    start, data = _parallel_inputs(tmp, 16)
    spec = _parallel_spec()
    t0 = time.perf_counter()
    world = World("step", tmp, device="cuda:0", spec=spec, steps=2)
    model = create_model(PARALLEL_MODEL)
    model.load_state_dict(start)
    model = model.cuda()
    state = TrainState(model, get_optimizer(spec["optimizer"], model.parameters(), gradient_clip_val=spec["clip"]))
    step = build_train_step(img_size=IMG, warmup_steps=spec["warmup"])
    flame, batch = FlameModel.load(device="cuda"), {k: v.cuda() for k, v in data.items()}
    with cudnn_deterministic():
        ref_logs = [{k: float(v) for k, v in step(state, flame, batch).items()}]
        ref_first = {k: v.cpu() for k, v in model.state_dict().items()}
        ref_logs.append({k: float(v) for k, v in step(state, flame, batch).items()})
    ranks = [r["step"] for r in world.results(timeout=600)]
    seconds = time.perf_counter() - t0
    logs = ranks[0]["logs"]
    assert ranks[1]["logs"] == logs
    for i, (got, ref) in enumerate(zip(logs, ref_logs)):
        for key in ("loss", "heatmap_loss", "vertices3d_loss", "reprojection_loss", "landmarks_loss", "grad_norm"):
            rel = abs(got[key] - ref[key]) / abs(ref[key])
            tol = (1e-5 if key == "loss" else 2e-2 if key == "grad_norm" else 1e-3) if i == 0 else 0.1
            print(f"[parallel b] step {i} {key}: two ranks {got[key]:.6f} one process {ref[key]:.6f} "
                  f"(rel {rel:.2e}, tol {tol})")
            assert rel <= tol, (i, key, got[key], ref[key])
    gap, norm, stats = _update_gaps(start, ranks[0]["state_dict"], ref_first)
    print(f"[parallel b] first update: L2 gap {gap:.3g} of norm {norm:.3g}; global-batch BN statistics gap "
          f"{stats:.2e}; two ranks and the reference {seconds:.1f} s; launches by rank "
          f"{[r['launches'] for r in ranks]}")
    assert 0 < norm and gap <= 0.25 * norm and stats <= 1e-3, (gap, norm, stats)
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def _parallel_serving() -> dict:
    """12c: ``FaceMeshPredictor(mesh=make_mesh([cuda:0, cuda:0]))`` against
    the unsharded predictor on one checkpoint (phase 4's weights):
    predict_batch at B = 255 (padded to 256, two chunks) and predict_frames
    on phase 4b's frames, phase 4's tolerances. Returns the mesh
    predictor's launches."""
    from dad3dheads_tpu_torch.parallel import make_mesh
    from dad3dheads_tpu_torch.weights import flax_from_state_dict, save_flax_msgpack

    config = {"img_size": IMG, "model": {"backbone": "resnet50", "dtype": "float32"}}
    with tempfile.TemporaryDirectory() as tmp:
        src = FaceMeshPredictor(config, device="cuda", seed=SEED)
        randomize_bn_stats(src.model, torch.Generator().manual_seed(SEED + 1))
        ck = save_flax_msgpack(flax_from_state_dict(src.model.state_dict()), os.path.join(tmp, "p.msgpack"))
        del src
        one = FaceMeshPredictor(config, checkpoint_path=ck, device="cuda")
        two = FaceMeshPredictor(config, checkpoint_path=ck, mesh=make_mesh(["cuda:0", "cuda:0"]))
    images = np.random.default_rng(SEED + 122).integers(0, 256, (BENCH_B - 1, IMG, IMG, 3), dtype=np.uint8)
    rng, sizes_hw = frames_4b_sizes(FRAMES_B)
    frames, boxes = seeded_frames(rng, sizes_hw), face_boxes(rng, sizes_hw)
    ref = one.predict_batch(images)
    ref_frames = one.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B)
    reset_launches()
    t0 = time.perf_counter()
    out = two.predict_batch(images)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    batch_launches = read_launches()
    t0 = time.perf_counter()
    out_frames = two.predict_frames(frames, bboxes=boxes, batch_size=FRAMES_B)
    t_frames = time.perf_counter() - t0
    launches = read_launches()
    print(f"[parallel c] mesh [cuda:0, cuda:0]: predict_batch B={BENCH_B - 1} (first call) {t_batch:.3f} s, "
          f"launches {batch_launches}; predict_frames {FRAMES_B} frames (first call) {t_frames:.3f} s; "
          f"launches in all {launches}")
    assert batch_launches["normalize_images"] == 2 and batch_launches["blend_shapes_fused"] == 2, batch_launches
    assert launches["resample_normalize"] == 2, launches
    for key, atol in (("3dmm_params", 1e-3), ("3d_vertices", 1e-3), ("points", 0.5), ("projected_vertices", 0.5)):
        assert out[key].shape == ref[key].shape, key
        gap = float(np.abs(out[key] - ref[key]).max())
        print(f"[parallel c] predict_batch mesh vs one device {key}: max abs gap {gap:.3g} (atol {atol})")
        assert gap <= atol, (key, gap)
    compare_predictions(out_frames, ref_frames, "parallel c frames")
    return launches


def _parallel_heads(tmp: str) -> dict:
    """12d: the three heads split over two gloo ranks sharing cuda:0 (a
    (1, 2) mesh) against the replicated step in the same ranks, from one
    seeded state on a batch of 16 (cuDNN deterministic): logs within 2e-4
    relative, the updated head weights within 1e-5 (the JAX package's
    bounds, tests/test_model_axis_tp.py); the gathered state dict has the
    replicated layout."""
    from tests.torch_parallel_worker import World

    _parallel_inputs(tmp, 16)
    t0 = time.perf_counter()
    ranks = [r["tp"] for r in World("tp", tmp, device="cuda:0", spec=_parallel_spec()).results(timeout=600)]
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    worst = max(abs(r0["split_logs"][k] - v) / max(abs(v), 1e-12) for k, v in r0["replicated_logs"].items())
    heads = max(float((r0["split_heads"][k] - r0["replicated_heads"][k]).abs().max()) for k in r0["split_heads"])
    print(f"[parallel d] head tensor parallelism over 2 ranks: logs max rel gap {worst:.2e} (tol 2e-4), head "
          f"weights max abs gap {heads:.3g} (tol 1e-5), shards {r0['shard_shapes']}, {seconds:.1f} s; launches "
          f"split step by rank {[r['split_launches'] for r in ranks]}")
    for k, v in r0["replicated_logs"].items():
        assert abs(r0["split_logs"][k] - v) <= 2e-4 * abs(v) + 1e-12, (k, r0["split_logs"][k], v)
    assert heads <= 1e-5 and r0["split_layout"] == r0["replicated_layout"], heads
    return {k: sum(r["split_launches"][k] + r["replicated_launches"][k] for r in ranks)
            for k in r0["split_launches"]}


def phase12_parallel() -> dict:
    """Data parallelism, serving over a mesh and head tensor parallelism on
    the one card (legs a-d). Returns the kernels' launches on this path:
    the blendshape pair in the distributed children and ranks, normalize,
    resample and blendshape in the mesh predictor."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, leg in (("a", lambda: _parallel_cli(tmp)), ("b", lambda: _parallel_step(tmp)),
                          ("c", _parallel_serving), ("d", lambda: _parallel_heads(tmp))):
            t = time.perf_counter()
            for k, v in leg().items():
                launches[k] += v
            print(f"[parallel] leg {name}: {time.perf_counter() - t:.1f} s")
    print(f"[parallel] this path's launches: {launches}; phase 12 took {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase1_card()
    phase2_build()
    flame = FlameModel.load(device="cuda")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    kernels = phase3_kernels(flame, flush)
    kernels.update(phase3b_resample(flush))
    kernels.update(phase3c_raster(flame, flush))
    kernels.update(phase3d_blend_backward(flame, flush))
    del flush
    config = {"img_size": IMG, "model": {"backbone": "resnet50", "dtype": "float32"}}
    pred, slice_launches = phase4_slice(config)
    frames, frame_launches = phase4b_frames(pred, config)
    render_launches = phase4c_render(flame, frames[0])
    bf16, phase5_ips = phase5_throughput(pred, config)
    phase5b_ips = phase5b_frames_throughput(pred, bf16)
    del pred, bf16
    torch.cuda.empty_cache()
    train_launches, synthetic_rates = phase6_train()
    dataset_launches = phase7_dataset(synthetic_rates)
    mobilenet_launches = phase8_mobilenet()
    export_launches = phase9_export(config, phase5_ips, phase5b_ips)
    int8_launches = phase10_int8(config, phase5_ips, phase5b_ips)
    training_launches = phase11_rest_of_training()
    parallel_launches = phase12_parallel()
    # each kernel's launches on the path that serves it, on the dataset path,
    # on the mobilenet path, on the export path, on the int8 path and on the
    # rest of training's
    path_of = {"blend_shapes_fused": slice_launches, "normalize_images": slice_launches,
               "resample_normalize": frame_launches, "rasterize_buffers": render_launches,
               "blend_shapes_fused_backward": train_launches}
    summary = []
    for name in KERNELS:
        entry = {"name": name, **kernels[name], "launches": path_of[name][name],
                 "launches_dataset_path": dataset_launches[name],
                 "launches_mobilenet_path": mobilenet_launches[name],
                 "launches_export_path": export_launches[name],
                 "launches_int8_path": int8_launches[name],
                 "launches_rest_of_training_path": training_launches[name],
                 "launches_parallel_path": parallel_launches[name]}
        assert entry["launches"] >= 1 and entry["launches_dataset_path"] >= 1, entry
        if name in ("blend_shapes_fused", "normalize_images", "resample_normalize"):
            assert entry["launches_int8_path"] >= 1, entry
        if name != "rasterize_buffers":
            assert entry["launches_parallel_path"] >= 1, entry
        summary.append(entry)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
