"""Linear blend skinning in fp32. Mirrors ``dad3dheads_tpu/core/lbs.py``.

  1. v_shaped  = v_template + shapedirs . betas   (ops.blendshapes in flame_decode)
  2. joints    = J_regressor . v_shaped
  3. rot_mats  = rodrigues(pose)
  4. v_posed   = v_shaped + posedirs . (rot_mats[1:] - I)
  5. A         = rigid transforms along the 5-joint kinematic chain
  6. verts     = (sum_j lbs_weights[:, j] * A[j]) . v_posed

The reference runs its geometry matmuls at ``Precision.HIGHEST``; here the
matmuls are plain fp32 ``torch.matmul``, which on CUDA stays full fp32 as long
as ``torch.backends.cuda.matmul.allow_tf32`` keeps its default (False).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .rotation import rodrigues


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """j_regressor (J, V) x vertices (B, V, 3) -> joints (B, J, 3)."""
    return torch.matmul(j_regressor, vertices)


def _make_tf(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid transforms along a kinematic tree (parents[0] == -1).

    Returns the posed joints (B, J, 3) and the (B, J, 4, 4) transforms that
    act on rest-pose vertex coordinates directly."""
    J = joints.shape[1]
    rel_joints = joints.clone()
    for j in range(1, J):
        rel_joints[:, j] = joints[:, j] - joints[:, parents[j]]
    local_tf = _make_tf(rot_mats, rel_joints)

    # the tree is tiny (5 joints) and static: unroll the chain
    chains = [local_tf[:, 0]]
    for j in range(1, J):
        chains.append(torch.matmul(chains[parents[j]], local_tf[:, j]))
    transforms = torch.stack(chains, dim=1)

    posed_joints = transforms[:, :, :3, 3]
    rot_joint = torch.sum(transforms[:, :, :3, :3] * joints[:, :, None, :], dim=-1)
    rel = transforms.clone()
    rel[:, :, :3, 3] = transforms[:, :, :3, 3] - rot_joint
    return posed_joints, rel


def lbs_from_shaped(
    v_shaped: torch.Tensor,
    pose: torch.Tensor,
    posedirs: torch.Tensor,
    j_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LBS steps 2-6 given the blendshaped vertices (B, V, 3)."""
    B, V = v_shaped.shape[0], v_shaped.shape[1]
    J = j_regressor.shape[0]

    joints = vertices2joints(j_regressor, v_shaped)
    rot_mats = rodrigues(pose.reshape(B, J, 3))

    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(B, V, 3)

    posed_joints, rel_tf = batch_rigid_transform(rot_mats, joints, parents)

    # skinning: T = W (V, J) x A (B, J, 16) -> (B, V, 4, 4)
    T = torch.matmul(lbs_weights, rel_tf.reshape(B, J, 16)).reshape(B, V, 4, 4)
    verts = torch.sum(T[:, :, :3, :3] * v_posed[:, :, None, :], dim=-1) + T[:, :, :3, 3]
    return verts, posed_joints


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor) -> torch.Tensor:
    """betas (B, L) x shape_dirs (V, 3, L) -> per-vertex offsets (B, V, 3)."""
    V = shape_dirs.shape[0]
    return torch.matmul(betas, shape_dirs.reshape(V * 3, -1).T).reshape(betas.shape[0], V, 3)


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    j_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full decode with shapedirs in the (V, 3, L) layout; returns vertices
    (B, V, 3) and posed joints (B, J, 3). ``flame_decode`` takes the fused
    blendshape kernel instead and enters at ``lbs_from_shaped``."""
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    return lbs_from_shaped(v_shaped, pose, posedirs, j_regressor, parents, lbs_weights)
