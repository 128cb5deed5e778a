"""The FLAME decode in plain PyTorch, fp32: 3DMM vector -> mesh vertices and
their weak-perspective projection.

The 413 values are [shape 300 | expression 100 | jaw 3 | rotation 6 |
translation 3 | scale 1] (DAD-3DHeads' ``flame_constants``: no eyeball or
neck pose). The decode follows FLAME 2020's linear blend skinning: the
template plus the blendshapes (betas = shape and expression, 400), joints
regressed from the shaped mesh, Rodrigues rotations of the pose (a zero root,
a zero neck, the jaw, zero eyeballs), the pose-corrective blendshapes, the
rigid transforms along the 5-joint chain and the skinning, then +0.05 on z.
The 6D rotation (Gram-Schmidt) is applied after the skinning, then
(v * clip(scale + 1, 1e-8) + [tx, ty, 0] + 1) / 2 * image_size.

``matmul``: the product used for the blendshapes, the regressor, the
pose correctives and the skinning; the control passes one that rounds its
operands to TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

PARENTS = (-1, 0, 1, 1, 1)
MESH_OFFSET_Z = 0.05
EPS = 1e-8
Matmul = Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]


def split_3dmm(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"shape": x[:, :300], "expression": x[:, 300:400], "jaw": x[:, 400:403], "rotation": x[:, 403:409],
            "translation": x[:, 409:412], "scale": x[:, 412:413]}


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=EPS * EPS))


def rotation_6d(v: torch.Tensor) -> torch.Tensor:
    """(B, 6) -> (B, 3, 3) with columns b1, b2, b3."""
    b1 = _unit(v[:, :3])
    b3 = _unit(torch.linalg.cross(b1, v[:, 3:], dim=-1))
    b2 = -torch.linalg.cross(b1, b3, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3)."""
    angle = torch.sqrt(torch.clamp((aa * aa).sum(-1, keepdim=True), min=EPS * EPS))
    axis = aa / angle
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = axis.unbind(-1)
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return c * eye + (1.0 - c) * axis[..., :, None] * axis[..., None, :] + s * K


def rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) applied to (B, V, 3), as an exact fp32 multiply-add."""
    return (R[:, None, :, :] * v[:, :, None, :]).sum(-1)


def decode(flame: Dict[str, torch.Tensor], x: torch.Tensor, image_size: int,
           matmul: Matmul = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3DMM (B, 413) -> (vertices without the global rotation (B, V, 3),
    rotated vertices (B, V, 3), projection (B, V, 2)). ``flame`` holds
    v_template (V, 3), shapedirs (V, 3, 400), posedirs (36, 3V),
    j_regressor (5, V), lbs_weights (V, 5)."""
    mm = matmul or torch.matmul
    p = split_3dmm(x)
    B = x.shape[0]
    V = flame["v_template"].shape[0]
    betas = torch.cat([p["shape"], p["expression"]], dim=1)
    dirs = flame["shapedirs"].reshape(V * 3, -1)
    v_shaped = flame["v_template"][None] + mm(betas, dirs.T).reshape(B, V, 3)
    joints = mm(flame["j_regressor"], v_shaped)  # (B, 5, 3)
    zeros3 = x.new_zeros(B, 3)
    pose = torch.cat([zeros3, zeros3, p["jaw"], zeros3, zeros3], dim=1).reshape(B, 5, 3)
    R = rodrigues(pose)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    v_posed = v_shaped + mm((R[:, 1:] - eye).reshape(B, 36), flame["posedirs"]).reshape(B, V, 3)
    rel = joints.clone()
    for j in range(1, 5):
        rel[:, j] = joints[:, j] - joints[:, PARENTS[j]]
    bottom = x.new_zeros(B, 5, 1, 4)
    bottom[..., 3] = 1.0
    local = torch.cat([torch.cat([R, rel[..., None]], dim=-1), bottom], dim=-2)  # (B, 5, 4, 4)
    chain = [local[:, 0]]
    for j in range(1, 5):
        chain.append(chain[PARENTS[j]] @ local[:, j])
    A = torch.stack(chain, dim=1)
    t = A[:, :, :3, 3] - (A[:, :, :3, :3] * joints[:, :, None, :]).sum(-1)
    A = torch.cat([torch.cat([A[:, :, :3, :3], t[..., None]], dim=-1), A[:, :, 3:]], dim=-2)
    T = mm(flame["lbs_weights"], A.reshape(B, 5, 16)).reshape(B, V, 4, 4)
    v0 = (T[:, :, :3, :3] * v_posed[:, :, None, :]).sum(-1) + T[:, :, :3, 3]
    v0 = v0 + torch.tensor([0.0, 0.0, MESH_OFFSET_Z], device=x.device)
    v_rot = rotate(rotation_6d(p["rotation"]), v0)
    scale = torch.clamp(p["scale"][:, None] + 1.0, min=1e-8)
    t = torch.cat([p["translation"][:, :2], x.new_zeros(B, 1)], dim=1)
    proj = (v_rot * scale + t[:, None] + 1.0) / 2.0 * image_size
    return v0, v_rot, proj[..., :2]
