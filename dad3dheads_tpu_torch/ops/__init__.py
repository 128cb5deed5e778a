from .blendshapes import (
    blend_shapes_fused,
    blend_shapes_fused_backward,
    blend_shapes_fused_backward_reference,
    blend_shapes_fused_reference,
)
from .preprocess import normalize_images, normalize_images_reference
from .preprocess_device import pack_frames_host, preprocess_frames_device
from .resample import resample_normalize, resample_normalize_reference

__all__ = [
    "blend_shapes_fused",
    "blend_shapes_fused_backward",
    "blend_shapes_fused_backward_reference",
    "blend_shapes_fused_reference",
    "normalize_images",
    "normalize_images_reference",
    "pack_frames_host",
    "preprocess_frames_device",
    "resample_normalize",
    "resample_normalize_reference",
]
