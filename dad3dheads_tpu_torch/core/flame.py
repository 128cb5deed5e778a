"""FLAME parameters and the FLAME decoder. Mirrors
``dad3dheads_tpu/core/flame.py``: the packed 413-dim 3DMM slicing, betas
zero-padded to [shape 300 | expression 100], a zero root rotation inside LBS,
the +MESH_OFFSET_Z shift, then the optional 6DoF global rotation."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import assets
from ..constants import (
    EYE_COEFFS,
    FLAME_3DMM_ORDER,
    FLAME_CONSTS,
    JAW_COEFFS,
    MAX_EXPRESSION,
    MAX_SHAPE,
    MESH_OFFSET_Z,
    NECK_COEFFS,
    ROT_COEFFS,
)

from ..ops.blendshapes import blend_shapes_fused
from .lbs import lbs_from_shaped
from .rotation import rot_mat_from_6dof, rotate_vertices


@dataclasses.dataclass
class FlameParams:
    """Unpacked 3DMM groups, each (B, k); groups of size 0 are (B, 0)."""

    shape: torch.Tensor
    expression: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor
    scale: torch.Tensor
    jaw: torch.Tensor
    eyeballs: torch.Tensor
    neck: torch.Tensor

    @classmethod
    def from_3dmm(
        cls,
        tensor_3dmm: torch.Tensor,
        constants: Optional[Dict[str, int]] = None,
        zero_expr: bool = False,
    ) -> "FlameParams":
        """Slice a packed (B, 413) 3DMM vector into named groups."""
        constants = constants or FLAME_CONSTS
        if tensor_3dmm.ndim != 2:
            raise ValueError(f"expected (B, P), got {tuple(tensor_3dmm.shape)}")
        out = {}
        idx = 0
        for key in FLAME_3DMM_ORDER:
            size = constants.get(key, 0)
            out[key] = tensor_3dmm[:, idx : idx + size]
            idx += size
        if zero_expr:
            out["expression"] = torch.zeros_like(out["expression"])
        return cls(**out)


@dataclasses.dataclass
class FlameModel:
    """FLAME decoder constants on one device. ``shapedirs`` is kept
    pre-transposed to the (400, V*3) layout the blendshape kernels read, as
    a view of a buffer whose rows are padded to a multiple of 4 floats, so
    that every row starts 16-byte aligned and the kernels copy it 16 bytes at
    a time (V*3 = 15,069 would put the rows 60,276 bytes apart, 4 mod 16)."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (400, V*3)
    posedirs: torch.Tensor  # (36, V*3)
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: Tuple[int, ...] = (-1, 0, 1, 1, 1)

    @classmethod
    def from_arrays(
        cls, arrays: assets.FlameModelArrays, device: torch.device | str = "cpu"
    ) -> "FlameModel":
        V = arrays.v_template.shape[0]

        def put(a):
            return torch.as_tensor(a, dtype=torch.float32).contiguous().to(device)

        return cls(
            v_template=put(arrays.v_template),
            shapedirs=_rows_aligned(torch.as_tensor(arrays.shapedirs.reshape(V * 3, -1).T, dtype=torch.float32),
                                    device),
            posedirs=put(arrays.posedirs),
            j_regressor=put(arrays.j_regressor),
            lbs_weights=put(arrays.lbs_weights),
            parents=tuple(int(p) for p in arrays.parents),
        )

    @classmethod
    def load(
        cls, path: Optional[str] = None, device: torch.device | str = "cpu"
    ) -> "FlameModel":
        return cls.from_arrays(assets.load_flame_model(path), device)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def to(self, device: torch.device | str) -> "FlameModel":
        """A copy on ``device`` (shapedirs' rows aligned there too); this
        model when it is there already."""
        device = torch.device(device)
        if self.v_template.device == device:
            return self
        return dataclasses.replace(
            self,
            v_template=self.v_template.to(device),
            shapedirs=_rows_aligned(self.shapedirs, device),
            posedirs=self.posedirs.to(device),
            j_regressor=self.j_regressor.to(device),
            lbs_weights=self.lbs_weights.to(device),
        )


def _rows_aligned(t: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """``t`` (rows, n) fp32 on ``device`` as a view of a buffer whose rows are
    padded to a multiple of 4 floats."""
    rows, n = t.shape
    buf = torch.zeros((rows, -(-n // 4) * 4), dtype=torch.float32, device=device)
    buf[:, :n] = t
    return buf[:, :n]


def _pad_group(x: torch.Tensor, full: int) -> torch.Tensor:
    """Right-pad a (B, k) coefficient group with zeros up to k == full."""
    return F.pad(x, (0, full - x.shape[-1]))


def _pose_group(x: torch.Tensor, size: int) -> torch.Tensor:
    """A pose group: an empty (B, 0) group decodes as the neutral pose."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1] + (size,))
    if x.shape[-1] != size:
        raise ValueError(f"pose group of width {x.shape[-1]}, expected {size}")
    return x


def flame_decode(
    model: FlameModel,
    params: FlameParams,
    zero_rot: bool = False,
    zero_jaw: bool = False,
) -> torch.Tensor:
    """FLAME 3DMM parameters -> mesh vertices (B, V, 3)."""
    B = params.shape.shape[0]
    dtype = model.v_template.dtype

    betas = torch.cat(
        [
            _pad_group(params.shape.to(dtype), MAX_SHAPE),
            _pad_group(params.expression.to(dtype), MAX_EXPRESSION),
        ],
        dim=-1,
    )

    jaw = _pose_group(params.jaw.to(dtype), JAW_COEFFS)
    if zero_jaw:
        jaw = torch.zeros_like(jaw)
    full_pose = torch.cat(
        [
            betas.new_zeros((B, ROT_COEFFS)),
            _pose_group(params.neck.to(dtype), NECK_COEFFS),
            jaw,
            _pose_group(params.eyeballs.to(dtype), EYE_COEFFS),
        ],
        dim=-1,
    )

    v_shaped = blend_shapes_fused(betas, model.shapedirs, model.v_template)
    vertices, _ = lbs_from_shaped(
        v_shaped,
        full_pose,
        model.posedirs,
        model.j_regressor,
        list(model.parents),
        model.lbs_weights,
    )

    vertices[:, :, 2] += MESH_OFFSET_Z  # in place: lbs_from_shaped made a fresh tensor
    if not zero_rot:
        R = rot_mat_from_6dof(params.rotation.to(dtype))
        vertices = rotate_vertices(R, vertices)
    return vertices
