from .lighting import RenderPipeline, norm_vertices
from .pncc import PNCCEstimator, compute_ncc_color_codes, pncc
from .rasterizer import get_normal, rasterize, rasterize_buffers, rasterize_buffers_reference, shade
from .uv_texture import UVTextureCreator

__all__ = [
    "rasterize",
    "rasterize_buffers",
    "rasterize_buffers_reference",
    "shade",
    "get_normal",
    "PNCCEstimator",
    "pncc",
    "compute_ncc_color_codes",
    "UVTextureCreator",
    "RenderPipeline",
    "norm_vertices",
]
