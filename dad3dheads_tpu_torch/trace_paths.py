"""Where the time goes on the card: one traced call of each bulk entry point,
device time summed by kernel bucket.

    python -m dad3dheads_tpu_torch.trace_paths [--trace-dir DIR]

Drives ``predict_batch`` (256 uint8 images of 256x256), ``predict_frames``
(64 frames of 1280x720 with face boxes, one batch) and one train step
(``build_train_step`` on a synthetic batch of 64 at 256x256, Adam, clip 5)
with each DAD-3DNet (resnet50, then mobilenet_w1) at its published widths,
random weights from a seeded generator, fp32 and bf16 trunk. After 3 warm-up
calls, one call of each is traced with ``torch.profiler``. Prints, per
backbone, entry point and dtype, the device milliseconds of each bucket and
their sum, the device's busy time (the union of its kernel and copy
intervals), the call's wall time on the host clock and the idle share of
that wall; the call's first device events in order (name and ms), which
show what runs between the upload and the stem convolution: the normalize
kernel and the type it writes, any cast, any layout transform of cuDNN's;
the kernels that took the most device time, by name; and how many times
each convolution operator ran (``aten::cudnn_convolution`` against
``aten::_conv_depthwise2d``, ATen's own NCHW depthwise kernel, which a
channels_last input reaches through layout copies); and, for mobilenet_w1,
its 13 depthwise convolutions alone at B = 256, forward and backward, to
name their kernels. Then the int8 ``predict_batch`` (resnet50, ``quant_amax``
calibrated on 64 of the images, B = 256, fp32 and bf16), with the int8
mirror's stages labelled for the profiler (``int8_stages_ms``: the im2col
copies, ``torch._int_mm``, the epilogue, the residual joins, the
(re)quantization and the dequantization of the dense taps). With
``--trace-dir`` it also writes each chrome trace there.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .api import FaceMeshPredictor
from .models import randomize_bn_stats

# bucket -> substrings of a kernel or copy name (lowercase), first match wins
BUCKETS = (
    ("kernel: resample_normalize", ("resample_kernel",)),
    ("kernel: normalize_images", ("normalize_vec_kernel", "normalize_scalar_kernel")),
    ("kernel: blend_shapes_fused", ("blend_shapes_kernel",)),
    ("kernel: blend_shapes_fused_backward", ("dbetas_partial_kernel", "dbetas_reduce_kernel", "ddirs_kernel")),
    ("optimizer (Adam, clip: foreach kernels)", ("multi_tensor_apply", "foreach")),
    ("memcpy HtoD", ("memcpy htod",)),
    ("memcpy DtoH", ("memcpy dtoh",)),
    ("depthwise conv (cuDNN's *_c1_k1_nhwc and xmma depthwise, ATen's conv_depthwise2d)",
     ("_c1_k1_", "depthwise_convolution", "conv_depthwise2d")),
    ("layout transposes, cuDNN's", ("nhwctonchw", "nchwtonhwc")),
    ("copies and casts, ATen's (layout copies included)", ("copy_kernel",)),
    ("batch norm (cuDNN's in fp32, ATen's in bf16)", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv (cuDNN/CUTLASS/GEMM, FFT)", ("cudnn", "xmma", "cutlass", "gemm", "conv", "sm90_", "wgrad", "dgrad",
                                        "fft", "pointwise_mult_and_sum_complex")),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
)
OTHER = "elementwise and other"
INT8_LABEL = "int8: "  # the prefix of the int8 mirror's stage labels
FIRST_EVENTS = 12  # device events listed in order from the start of each traced call
TOP_KERNELS = 12  # kernels listed by their device time in each traced call


def bucket_of(name: str) -> str:
    low = name.lower()
    for bucket, keys in BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return OTHER


def device_events(prof) -> list:
    """(name, start_us, end_us) of every kernel, copy and memset on the card
    (not the device-side spans of annotations such as ``Optimizer.step``,
    which cover kernels already counted)."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not out:
        raise RuntimeError("the profiler recorded no device activity on this machine")
    return out


def union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace(fn, label: str, trace_dir: str | None) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    buckets: dict = {}
    by_name: dict = {}
    for name, s, e in events:
        b = bucket_of(name)
        buckets[b] = buckets.get(b, 0.0) + (e - s) / 1e3
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    conv_ops = {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::") and "conv" in e.key}
    busy_ms = union_us([(s, e) for _, s, e in events]) / 1e3
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
    first = [(name[:160], (e - s) / 1e3) for name, s, e in sorted(events, key=lambda ev: ev[1])[:FIRST_EVENTS]]
    return {"path": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "buckets_sum_ms": sum(buckets.values()),
            "buckets_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1])), "first_events": first,
            "top_kernels_ms": [(name[:160], ms) for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]],
            "conv_ops": conv_ops,
            "int8_stages_ms": {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                               if e.key.startswith(INT8_LABEL)}}


def trace_train_step(backbone: str, dtype: str, seed: int, trace_dir: str | None) -> dict:
    """One train step at B = 64, 256x256, the config's optimizer settings,
    without the metric panel (as ``chip_smoke.py`` times it)."""
    from .core import FlameModel, LandmarkEmbedding
    from .data.synthetic import synthetic_batch
    from .train import build_train_step, init_train_state

    flame, emb = FlameModel.load(device="cuda"), LandmarkEmbedding.load(device="cuda")
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(seed), flame, emb, 64, 256)
    state = init_train_state({"backbone": backbone, "dtype": dtype}, {"name": "adam", "lr": 1e-4},
                             torch.Generator().manual_seed(seed), "cuda", 5.0)
    step = build_train_step(img_size=256, warmup_steps=400, with_metrics=False)
    return trace(lambda: step(state, flame, batch), f"{backbone}_train_step_B64_{dtype}", trace_dir)


def trace_depthwise(dtype: str, trace_dir: str | None) -> dict:
    """The mobilenet_w1 encoder's 13 depthwise convolutions alone, on the
    inputs that a B = 256 batch of 256x256 images gives them (channels_last,
    captured by hooks), forward and backward (input and weight gradients),
    in the trunk's mode: fp32 with cuDNN's TF32 off, or bf16 under
    autocast. Names the kernels that run them, and the layout transposes."""
    from .models import MobileNetStages
    from .precision import fp32_exact

    encoder = MobileNetStages().cuda()
    convs = [m.dw_conv.conv for m in encoder.modules() if hasattr(m, "dw_conv")]
    inputs = []
    hooks = [c.register_forward_pre_hook(lambda mod, args: inputs.append((mod, args[0].detach()))) for c in convs]
    x = torch.randn(256, 256, 256, 3, device="cuda").permute(0, 3, 1, 2)
    with torch.no_grad():
        encoder(x)
    for h in hooks:
        h.remove()
    context = (lambda: torch.autocast("cuda", dtype=torch.bfloat16)) if dtype == "bfloat16" else fp32_exact
    inputs = [(mod, t.to(torch.bfloat16) if dtype == "bfloat16" else t) for mod, t in inputs]

    def run():
        for mod, t in inputs:
            t = t.detach().requires_grad_()
            with context():
                y = mod(t)
            y.backward(torch.ones_like(y))

    result = trace(run, f"mobilenet_w1_depthwise_convs_B256_{dtype}", trace_dir)
    result["shapes"] = [tuple(t.shape) for _, t in inputs]
    return result


def _int8_stages():
    """(module, function, label) of the int8 mirror's leaf stages, none of
    which calls another."""
    from .models import quant, quantized

    return (
        (quant, "_im2col", INT8_LABEL + "im2col (padding, window copy)"),
        (torch, "_int_mm", INT8_LABEL + "torch._int_mm (int8 x int8 -> int32)"),
        (quant, "_epilogue", INT8_LABEL + "epilogue (dequantize the sums, bias, ReLU)"),
        (quant, "_residual", INT8_LABEL + "residual joins (dequantize, add, ReLU)"),
        (quant, "quantize", INT8_LABEL + "(re)quantize (divide, round, clamp, cast)"),
        (quantized, "quantize", INT8_LABEL + "(re)quantize (divide, round, clamp, cast)"),
        (quantized, "dequantize", INT8_LABEL + "dequantize (dense taps, upsample inputs)"),
    )


def _labelled(fn, label: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def trace_int8(images: np.ndarray, seed: int, trace_dir: str | None) -> list:
    """int8 ``predict_batch`` of the resnet50 at B = 256, fp32 and bf16: the
    weights of the other traces (seeded, BN statistics randomized) through a
    checkpoint, ``quant_amax`` calibrated in the model's dtype on the first
    64 images; the mirror's stages labelled while it is traced."""
    from .models import create_model
    from .models.quantized import calibrate
    from .ops.preprocess import normalize_images
    from .weights import flax_from_state_dict, save_flax_msgpack

    model = create_model({}, torch.Generator().manual_seed(seed))
    randomize_bn_stats(model, torch.Generator().manual_seed(seed + 1))
    results = []
    stages = _int8_stages()
    with tempfile.TemporaryDirectory() as tmp:
        ck = save_flax_msgpack(flax_from_state_dict(model.state_dict()), os.path.join(tmp, "ck.msgpack"))
        for dtype in ("float32", "bfloat16"):
            config = {"img_size": 256, "model": {"dtype": dtype}}
            fp = FaceMeshPredictor(config, checkpoint_path=ck, device="cuda")
            x = normalize_images(torch.from_numpy(images[:64]).cuda())
            amax = calibrate(fp.model, [x[:32], x[32:]])
            del fp
            pred = FaceMeshPredictor({**config, "quant_amax": amax}, checkpoint_path=ck, device="cuda")
            for mod, name, label in stages:
                setattr(mod, name, _labelled(getattr(mod, name), label))
            try:
                results.append(trace(lambda: pred.predict_batch(images), f"resnet50_int8_predict_batch_B256_{dtype}",
                                     trace_dir))
            finally:
                for mod, name, _ in stages:
                    setattr(mod, name, getattr(mod, name).__wrapped__)
            del pred
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace-dir", default=None, help="write each chrome trace here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_paths needs a CUDA device; none is available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(8)] * 8
    boxes = []
    for _ in frames:
        side = int(rng.integers(200, 500))
        x0, y0 = int(rng.integers(0, 1280 - side)), int(rng.integers(0, 720 - side))
        boxes.append([x0, y0, x0 + side, y0 + side])
    for backbone in ("resnet50", "mobilenet_w1"):
        for dtype in ("float32", "bfloat16"):
            pred = FaceMeshPredictor({"img_size": 256, "model": {"backbone": backbone, "dtype": dtype}},
                                     device="cuda", seed=args.seed)
            randomize_bn_stats(pred.model, torch.Generator().manual_seed(args.seed + 1))
            results = [trace(lambda: pred.predict_batch(images), f"{backbone}_predict_batch_B256_{dtype}",
                             args.trace_dir),
                       trace(lambda: pred.predict_frames(frames, bboxes=boxes, batch_size=64),
                             f"{backbone}_predict_frames_B64_720p_{dtype}", args.trace_dir)]
            del pred
            results.append(trace_train_step(backbone, dtype, args.seed, args.trace_dir))
            if backbone == "mobilenet_w1":
                results.append(trace_depthwise(dtype, args.trace_dir))
            for r in results:
                print(json.dumps(r), flush=True)
            torch.cuda.empty_cache()
    for r in trace_int8(images, args.seed, args.trace_dir):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
