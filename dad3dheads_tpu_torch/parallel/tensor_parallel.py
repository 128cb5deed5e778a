"""Head tensor parallelism over the mesh's model group, the counterpart of
``dad3dheads_tpu/parallel/mesh.py::head_tp_shardings``, built by hand on
``torch.distributed`` (no DTensor).

Each of the three regression heads (``models/dad3dnet.py::ClassificationHead``)
is Linear(2048 -> 512) -> ReLU -> Dropout -> Linear(512 -> out). Over a
model group of m ranks, which all see the same batch rows:

- the first Linear is column-parallel: each rank keeps 512/m of its output
  rows and their bias, so its GEMM writes only its own 512/m activations;
  its input passes an identity whose backward sums the input gradient over
  the group (each rank's is the part from its own rows);
- the second is row-parallel: each rank keeps the matching 512/m input
  columns, its partial products are summed over the group by an all-reduce
  whose backward is the identity (every rank computes the same loss from
  the same sum, so the sum's gradient is each rank's own), then the bias is
  added once, after the sum.

``torch.distributed.nn.functional.all_reduce`` is not used here: its
backward sums the gradients over the group, which fits a sum of per-rank
losses (the global-batch BN) but would count the replicated loss m times.
Gradients of the sharded weights are averaged over the data group like any
other (each data group is one model column, so it never mixes shards), and
the global gradient norm adds the shards' squares over the model group
(``train/optimizers.py::clip_by_global_norm_``).
:func:`gather_state_dict` gives the replicated layout back, so checkpoints
and ``weights.py`` read as before.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.resnet import GroupRef
from .mesh import MODEL_AXIS, Mesh

HEADS = ("shape", "pose", "landmarks")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The forward sums the partial products over the group; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelLinear(nn.Module):
    """This rank's ``index``-th of ``size`` blocks of ``full``'s output
    rows (weight and bias)."""

    def __init__(self, full: nn.Linear, group, index: int, size: int):
        super().__init__()
        if full.out_features % size:
            raise ValueError(f"{full.out_features} output features do not split over {size} ranks")
        k = full.out_features // size
        rows = slice(index * k, (index + 1) * k)
        self.weight = nn.Parameter(full.weight.detach()[rows].clone())
        self.bias = nn.Parameter(full.bias.detach()[rows].clone())
        self._group = GroupRef(group)

    @property
    def group(self):
        return self._group.group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's ``index``-th of ``size`` blocks of ``full``'s input
    columns; the bias whole, added after the sum over the group."""

    def __init__(self, full: nn.Linear, group, index: int, size: int):
        super().__init__()
        if full.in_features % size:
            raise ValueError(f"{full.in_features} input features do not split over {size} ranks")
        k = full.in_features // size
        self.weight = nn.Parameter(full.weight.detach()[:, index * k : (index + 1) * k].clone())
        self.bias = nn.Parameter(full.bias.detach().clone())
        self._group = GroupRef(group)

    @property
    def group(self):
        return self._group.group

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(F.linear(h, self.weight), self.group) + self.bias


def shard_heads(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split the three heads' Linears over ``mesh``'s model group in place
    (same module names, so the state dict keeps its keys; the shards'
    shapes are 1/m of the full ones). A mesh with one model column leaves
    the model as it is. Build the optimizer after this: the head
    parameters are new objects. Returns the model."""
    m = mesh.shape[MODEL_AXIS]
    if m == 1:
        return model
    if not mesh.distributed:
        raise ValueError("head tensor parallelism runs one process per device, under torch.distributed")
    index = mesh.model_index()
    for name in HEADS:
        seq = getattr(model, name).logit_image
        seq[0] = ColumnParallelLinear(seq[0], mesh.model_group, index, m)
        seq[3] = RowParallelLinear(seq[3], mesh.model_group, index, m)
    return model


def sharded_parameters(model: nn.Module) -> Optional[Tuple[List[nn.Parameter], object]]:
    """The parameters split over a model group, and that group; None when
    the model has none. The row-parallel bias is whole on every rank."""
    params, group = [], None
    for mod in model.modules():
        if isinstance(mod, ColumnParallelLinear):
            params += [mod.weight, mod.bias]
            group = mod.group
        elif isinstance(mod, RowParallelLinear):
            params.append(mod.weight)
            group = mod.group
    return (params, group) if params else None


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the replicated layout: each sharded head
    weight gathered over its model group (collective: every rank of the
    group calls it) and concatenated in rank order. Keys and shapes equal an
    unsharded model's, so ``weights.flax_from_state_dict`` and the
    checkpoints read it as before."""
    sd = model.state_dict()
    for name, mod in model.named_modules():
        if isinstance(mod, ColumnParallelLinear):
            sd[f"{name}.weight"] = _gather(mod.weight, mod.group, 0)
            sd[f"{name}.bias"] = _gather(mod.bias, mod.group, 0)
        elif isinstance(mod, RowParallelLinear):
            sd[f"{name}.weight"] = _gather(mod.weight, mod.group, 1)
    return sd
