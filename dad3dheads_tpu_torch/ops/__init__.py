from .blendshapes import blend_shapes_fused, blend_shapes_fused_reference
from .preprocess import normalize_images, normalize_images_reference

__all__ = [
    "blend_shapes_fused",
    "blend_shapes_fused_reference",
    "normalize_images",
    "normalize_images_reference",
]
