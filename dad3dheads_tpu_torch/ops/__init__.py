from .blendshapes import (
    blend_shapes_fused,
    blend_shapes_fused_backward,
    blend_shapes_fused_backward_reference,
    blend_shapes_fused_reference,
)
from .preprocess import normalize_images, normalize_images_reference
from .preprocess_device import pack_frames_host, preprocess_frames_device
from .resample import resample_normalize, resample_normalize_reference

# the kernels' launch counters, (op, attribute). They count on the host, in the
# ops' CUDA bodies, which a CUDA graph's replay does not run: whoever replays
# one adds the launches it holds (train/step.py)
LAUNCH_COUNTERS = (
    (normalize_images, "launches"),
    (normalize_images, "bf16_launches"),
    (blend_shapes_fused, "launches"),
    (blend_shapes_fused_backward, "launches"),
    (resample_normalize, "launches"),
)


def launch_counts() -> tuple:
    """The counters of :data:`LAUNCH_COUNTERS` as they stand."""
    return tuple(getattr(op, name) for op, name in LAUNCH_COUNTERS)


def add_launches(counts) -> None:
    """Add ``counts`` (in :data:`LAUNCH_COUNTERS`' order) to the counters."""
    for (op, name), n in zip(LAUNCH_COUNTERS, counts):
        setattr(op, name, getattr(op, name) + n)


__all__ = [
    "LAUNCH_COUNTERS",
    "add_launches",
    "blend_shapes_fused",
    "blend_shapes_fused_backward",
    "blend_shapes_fused_backward_reference",
    "blend_shapes_fused_reference",
    "launch_counts",
    "normalize_images",
    "normalize_images_reference",
    "pack_frames_host",
    "preprocess_frames_device",
    "resample_normalize",
    "resample_normalize_reference",
]
