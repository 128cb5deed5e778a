"""CUDA-event times of one call on the card, and the blendshape kernels of a
checkout of the port timed beside their library calls.

:func:`median_ms` is the timer of ``chip_smoke.py``. :func:`kernel_ms` times a
kernel two ways, each on a cold L2: the card's time, with the call queued
behind a ~0.5 ms spin of the card so that the host has issued all of it
before its start event runs; and the time with the host's dispatch, without
the spin, where a wrapper that takes longer to launch than the L2 flush takes
to run leaves the card idle inside the timed span (the only kernel timing of
``chip_smoke.py`` before the spin).

Run as a file, it times the FLAME blendshape forward (B = 64 and 256) and its
backward (d_betas + d_template, B = 64) of the port in the checkout ROOT
(default: the one holding this file) against ``torch.addmm`` and
``torch.matmul`` + ``sum`` (fp32, TF32 off), both ways, with the host's
microseconds per call, and prints one JSON line. Two checkouts are compared
by running it on each, one after the other on one card (parent, change,
change, parent)::

    python3 dad3dheads_tpu_torch/kernel_timing.py [ROOT]

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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


def _row(name: str, kernel, library, err: float, flush: torch.Tensor) -> dict:
    k_ms, k_host_ms = kernel_ms(kernel, flush)
    l_ms, l_host_ms = kernel_ms(library, flush)
    return {"name": name, "ms": k_ms, "ms_host": k_host_ms, "host_us": host_us(kernel),
            "library_ms": l_ms, "library_ms_host": l_host_ms, "library_host_us": host_us(library),
            "max_abs_err_vs_library": err}


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
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
