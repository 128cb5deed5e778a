"""Build and bind the hand-written CUDA kernels of ``dad3dheads_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, which ``ctypes`` loads. The library is built
on first use into ``dad3dheads_tpu_torch/build/`` (git-ignored) and named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads in milliseconds. Nothing here runs at import time.

Every C entry point takes device pointers, int sizes, the device ordinal and a
``cudaStream_t``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, static shared memory and spills, kept in the build log
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C name -> argtypes; every function returns a cudaError_t as int, but those of _RESTYPES
_SIGNATURES = {
    # betas, dirs, template, out, B, K, N, dirs row stride, device, stream
    "d3d_blend_shapes_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # g, dirs, betas, partial, tmpl_partial, d_betas, d_tmpl, d_dirs (or null), B, K, N,
    # g row stride, dirs row stride, chunk, device, stream
    "d3d_blend_shapes_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # images, out, B, H, W, out_bf16, scale[3], bias[3], device, stream
    "d3d_normalize_u8": (_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P),
    # frames, scalars, out, B, Hmax, Wmax, S, planar, out_bf16, band, scale[3], bias[3], device, stream
    "d3d_resample_normalize_u8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P),
    # vertices, faces, scratch, scratch bytes, depth, tri_id, bary, V, T, H, W, device, stream
    "d3d_rasterize": (_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # T, H, W
    "d3d_rasterize_scratch_bytes": (_I, _I, _I),
}
_RESTYPES = {"d3d_rasterize_scratch_bytes": _L}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdad3d_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of dad3dheads_tpu_torch are built on first use on a "
            "machine with the CUDA toolkit"
        )
    return found


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and return their error outputs; raise
    with every failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    failures, outputs = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        outputs.append(err)
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return outputs


def build_log_path() -> Path:
    """The compiler's report (``-Xptxas -v``) for the library of
    :func:`library_path`, one section per source."""
    return library_path().with_suffix(".log")


def build() -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists: one
    ``nvcc`` per source, all at once, then one link. Returns the library's
    path and the seconds spent compiling (0.0 when cached)."""
    path = library_path()
    if path.is_file():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    reports = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
    ])
    build_log_path().write_text("".join(f"== {src.name}\n{report}" for src, report in zip(sources, reports)))
    tmp = BUILD_DIR / f"{stem}.tmp.so"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink()
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    return path, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, _I)
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {code}")


def launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(device ordinal, current stream handle) for a launch next to ``t``."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
