"""Data parallelism over ``torch.distributed``: what XLA inserts into the JAX
package's sharded train step (``dad3dheads_tpu/train/step.py``), written out.

- :func:`set_sync_bn`: every train-mode BatchNorm of the model computes its
  statistics over the data group's global batch
  (``models/resnet.py::BatchNorm2d``), keeping flax's biased running
  variance with the global count. ``torch.nn.SyncBatchNorm`` is not used:
  its running variance takes the unbiased batch variance (the fault the
  port's ``BatchNorm2d`` repairs), ``convert_sync_batchnorm`` would swap
  that class and the BiFPN's momenta out, and its forward refuses CPU
  tensors, so the CPU tests could not run it.
- :func:`all_reduce_gradients`: the gradients averaged over the data group
  after the backward, before clipping and the update, as one coalesced
  all-reduce of the flattened gradients. A ``DistributedDataParallel``
  wrapper would overlap buckets with the backward, but it wraps the model
  (checkpoints, the export and the panels read ``state.model``) and
  broadcasts buffers that the global-batch BN already keeps equal.
- :func:`all_reduce_mean`: the step's logs as the global batch's means.
- :func:`init_distributed`: the process group from torchrun's environment.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.resnet import BatchNorm2d
from .mesh import Mesh


def data_group(mesh: Optional[Mesh]):
    """The mesh's data group when gradients and statistics must cross
    processes (a distributed mesh with more than one data row), else None:
    a world of one runs the one-process path."""
    if mesh is None or not mesh.distributed or mesh.shape["data"] == 1:
        return None
    return mesh.data_group


def set_sync_bn(model: torch.nn.Module, group) -> torch.nn.Module:
    """Point every port ``BatchNorm2d`` of ``model`` at ``group``; None, or
    a group of one rank, keeps (or restores) the local batch norm. Set it
    once, where the distributed model is built (the ``Trainer`` does, for
    every state it trains). Returns the model."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return model


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.nn.Parameter], group) -> None:
    """Average the parameters' gradients over ``group`` in place, as one
    all-reduce of their concatenation (a parameter without a gradient
    contributes zeros, as optax sees it)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset : offset + n].view(p.grad.shape))
        offset += n


@torch.no_grad()
def all_reduce_mean(logs: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """0-d logs averaged over ``group`` in one all-reduce: each rank's log is
    the mean over its equal share of the global batch."""
    keys = list(logs)
    values = torch.stack([logs[k].float() for k in keys])
    dist.all_reduce(values, group=group)
    values /= dist.get_world_size(group)
    return dict(zip(keys, values.unbind()))


# how long a collective, the rendezvous included, may wait for a rank: a
# rank that died fails the run instead of hanging it
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(device: str = "cuda") -> torch.device:
    """``torch.distributed.init_process_group`` from the variables torchrun
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), the counterpart of ``jax.distributed.initialize()``:
    NCCL on ``cuda:LOCAL_RANK`` for ``device="cuda"``, gloo on the CPU for
    ``device="cpu"``. Returns this rank's device. A missing variable or a
    failed rendezvous raises: the run never goes on as one process."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed=true needs torchrun's environment; {missing} not set")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        local = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world, timeout=TIMEOUT,
                                device_id=local)
        return local
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world, timeout=TIMEOUT)
    return torch.device("cpu")
