"""Host-side bbox utilities (numpy). The port's own copy of
``dad3dheads_tpu/data/bbox.py``: ``extend_bbox`` grows [x, y, w, h] by
per-side fractions (int32 truncation), ``ensure_bbox_boundaries`` clamps to
the image, ``random_extended_bbox`` is the dataset's per-sample jitter."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def extend_bbox(bbox: np.ndarray, offset: Union[Tuple[float, ...], float] = 0.1) -> np.ndarray:
    """Grow [x, y, w, h] by offset*dim per side.

    offset: scalar, (w_offset, h_offset), or (left, right, top, bottom)."""
    x, y, w, h = bbox
    if isinstance(offset, tuple):
        if len(offset) == 4:
            left, right, top, bottom = offset
        elif len(offset) == 2:
            w_off, h_off = offset
            left = right = w_off
            top = bottom = h_off
        else:
            raise ValueError(offset)
    else:
        left = right = top = bottom = offset
    return np.array(
        [x - w * left, y - h * top, w * (1.0 + right + left), h * (1.0 + top + bottom)]
    ).astype("int32")


def ensure_bbox_boundaries(bbox: np.ndarray, img_shape: Tuple[int, int]) -> np.ndarray:
    """Clamp [x, y, w, h] to an (h, w) image."""
    x1, y1, w, h = bbox
    x1 = min(max(0, x1), img_shape[1])
    y1 = min(max(0, y1), img_shape[0])
    x2 = min(max(0, x1 + w), img_shape[1])
    y2 = min(max(0, y1 + h), img_shape[0])
    return np.array([x1, y1, x2 - x1, y2 - y1]).astype("int32")


def random_extended_bbox(bbox: np.ndarray, img_shape: Tuple[int, int], rng: np.random.Generator) -> np.ndarray:
    """The dataset's per-sample jitter: each side grows by U(0.05, 0.15)."""
    offset = tuple(0.1 * rng.uniform(size=4) + 0.05)
    return ensure_bbox_boundaries(extend_bbox(np.asarray(bbox), offset), img_shape)
