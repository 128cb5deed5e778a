"""Image file reading for the CLIs. Mirrors ``read_as_rgb`` of
``dad3dheads_tpu/data/dataset.py``; cv2 (and PIL, for what cv2 cannot read)
are imported only when a file is read."""

from __future__ import annotations

import numpy as np


def read_as_rgb(path: str) -> np.ndarray:
    """Read an image file as RGB uint8 (H, W, 3)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
