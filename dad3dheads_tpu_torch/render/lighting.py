"""Phong-style per-vertex lighting. Port of
``dad3dheads_tpu/render/lighting.py``: ambient + diffuse + specular
per-vertex intensities computed on vertices normalized to [-1, 1] with one
directional light, multiplied into per-vertex colours and rasterized by
:func:`rasterizer.rasterize` (on CUDA tensors the kernel of
``csrc/rasterize.cu``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .rasterizer import get_normal, rasterize


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def norm_vertices(vertices: torch.Tensor) -> torch.Tensor:
    """Shift and scale the vertices: min -> 0, divide by the global max,
    times 2, then subtract half the per-axis max."""
    v = vertices - torch.min(vertices, dim=0, keepdim=True).values
    v = v / torch.max(v)
    v = v * 2.0
    return v - torch.max(v, dim=0, keepdim=True).values / 2.0


class RenderPipeline:
    def __init__(
        self,
        intensity_ambient: float = 0.3,
        intensity_directional: float = 0.6,
        intensity_specular: float = 0.1,
        specular_exp: float = 5.0,
        color_ambient: Tuple[float, float, float] = (1, 1, 1),
        color_directional: Tuple[float, float, float] = (1, 1, 1),
        light_pos: Tuple[float, float, float] = (0, 0, 5),
        view_pos: Tuple[float, float, float] = (0, 0, 5),
    ):
        self.intensity_ambient = intensity_ambient
        self.intensity_directional = intensity_directional
        self.intensity_specular = intensity_specular
        self.specular_exp = specular_exp
        self.color_ambient = torch.tensor(color_ambient, dtype=torch.float32)
        self.color_directional = torch.tensor(color_directional, dtype=torch.float32)
        self.light_pos = torch.tensor(light_pos, dtype=torch.float32)
        self.view_pos = torch.tensor(view_pos, dtype=torch.float32)

    def update_light_pos(self, light_pos) -> None:
        self.light_pos = torch.tensor(light_pos, dtype=torch.float32)

    def compute_light(self, vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
        """Per-vertex RGB light intensities in [0, 1], on the vertices' device."""
        dev = vertices.device
        normal = get_normal(vertices, triangles.to(dev))
        color_dir = self.color_directional.to(dev)
        light = torch.zeros_like(vertices)
        if self.intensity_ambient > 0:
            light = light + self.intensity_ambient * self.color_ambient.to(dev)
        if self.intensity_directional > 0:
            vn = norm_vertices(vertices)
            direction = _norm(self.light_pos.to(dev)[None] - vn)
            cos = torch.sum(normal * direction, dim=1, keepdim=True)
            light = light + self.intensity_directional * (color_dir * torch.clamp(cos, 0.0, 1.0))
            if self.intensity_specular > 0:
                v2v = _norm(self.view_pos.to(dev)[None] - vn)
                reflection = 2.0 * cos * normal - direction
                spe = torch.sum((v2v * reflection) ** self.specular_exp, dim=1, keepdim=True)
                spe = torch.where(cos != 0, torch.clamp(spe, 0.0, 1.0), torch.zeros_like(spe))
                light = light + self.intensity_specular * color_dir * torch.clamp(spe, 0.0, 1.0)
        return torch.clamp(light, 0.0, 1.0)

    def __call__(
        self,
        vertices: torch.Tensor,
        triangles: torch.Tensor,
        bg: torch.Tensor,
        texture: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Render the lit mesh over the uint8 (H, W, 3) ``bg`` on the
        vertices' device."""
        vertices = vertices.float()
        light = self.compute_light(vertices, triangles)
        colors = light if texture is None else texture.to(light) * light
        return rasterize(vertices, triangles, colors, bg=bg)
