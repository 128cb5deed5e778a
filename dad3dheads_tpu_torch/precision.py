"""Full fp32 where the JAX package pins ``Precision.HIGHEST``.

The JAX package fixes its geometry matmuls to ``Precision.HIGHEST`` op by op
(``dad3dheads_tpu/core/lbs.py``). PyTorch instead reads a process-wide
setting at each fp32 product: cuBLAS and cuDNN run TF32 when the caller has
asked for it, through the legacy flags (``torch.backends.cuda.matmul.
allow_tf32``, ``torch.set_float32_matmul_precision("high")``,
``torch.backends.cudnn.allow_tf32``, on by default for convolutions) or the
per-backend ``fp32_precision`` settings. :func:`fp32_exact` turns TF32 off
for both inside, and gives the caller back its settings on exit.

It sets and restores the ``fp32_precision`` settings only: the legacy flags
write them too, so they hold the effective state whichever API the caller
used, and the kernels read them. The legacy flags themselves are left alone,
so that a caller who used them reads them back unchanged afterwards (the two
APIs disagree inside the block, where torch refuses to read the legacy
flags; nothing in the port reads them).
"""

from __future__ import annotations

import contextlib

import torch


def _settings() -> tuple:
    return (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


@contextlib.contextmanager
def fp32_exact():
    """cuBLAS matmuls and cuDNN convolutions in full fp32 (no TF32) inside."""
    saved = [(s, s.fp32_precision) for s in _settings()]
    for s, _ in saved:
        s.fp32_precision = "ieee"
    try:
        yield
    finally:
        for s, value in saved:
            s.fp32_precision = value
