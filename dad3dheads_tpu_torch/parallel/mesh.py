"""The device mesh. Mirrors ``dad3dheads_tpu/parallel/mesh.py``.

The JAX package puts one ``jax.sharding.Mesh`` with a ``data`` and a
``model`` axis over its devices; the train step is jitted with the batch
sharded over ``data`` and XLA inserts the gradient all-reduce, the metric
reductions and the global-batch BN statistics. PyTorch has no such compiler,
so the port's :class:`Mesh` is a (data, model) grid of ``torch.device`` s
and, under ``torch.distributed`` (one process per device, as torchrun starts
them), of ranks, with the process groups that the collectives run over:

- a rank's **data group** is its model column: the ranks that hold the same
  weights and see different batch rows. Gradients are averaged and BN
  statistics summed over it (``parallel/data_parallel.py``);
- its **model group** is its data row: the ranks that see the same batch
  rows and split the heads' weights (``parallel/tensor_parallel.py``).

In one process the mesh's devices may repeat (``[cpu, cpu]``,
``[cuda:0, cuda:0]``), which lets the split run on the CPU and on one card.
``jax.sharding.NamedSharding`` has no counterpart, so the JAX package's
``batch_sharding`` and ``replicated`` are folded into :func:`shard_batch`
(one chunk of the batch per data row, each on its row's device) and
:func:`replicate` (one copy per distinct device).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _grid(items: Sequence[Any], data: int, model: int) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr.reshape(data, model)


class Mesh:
    """A (data, model) grid of devices; ``ranks`` is the grid of
    ``torch.distributed`` ranks (None in one process). Building a mesh of
    ranks makes every data and model group (``dist.new_group`` is
    collective: every rank builds them all, in one order) and keeps this
    rank's."""

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None):
        self.devices = devices
        self.ranks = ranks
        self.shape: Dict[str, int] = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}
        self.data_group = self.model_group = None
        if ranks is not None:
            me = dist.get_rank()
            for column in ranks.T:
                group = dist.new_group([int(r) for r in column])
                if me in column:
                    self.data_group = group
            for row in ranks:
                group = dist.new_group([int(r) for r in row])
                if me in row:
                    self.model_group = group

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    def _position(self, rank: Optional[int] = None) -> tuple:
        rank = dist.get_rank() if rank is None else rank
        (i,), (j,) = np.nonzero(self.ranks == rank)
        return int(i), int(j)

    def data_index(self, rank: Optional[int] = None) -> int:
        """This rank's row: its shard of the batch (0 in one process)."""
        return self._position(rank)[0] if self.distributed else 0

    def model_index(self, rank: Optional[int] = None) -> int:
        """This rank's column: its shard of the heads (0 in one process)."""
        return self._position(rank)[1] if self.distributed else 0

    @property
    def local_device(self) -> torch.device:
        """This rank's device; in one process, the first of the grid."""
        if self.distributed:
            return self.devices[self._position()]
        return self.devices.flat[0]

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of this process's data rows, one per row."""
        if self.distributed:
            return [self.local_device]
        return [self.devices[i, 0] for i in range(self.shape[DATA_AXIS])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, distributed={self.distributed})"


def _device(d) -> torch.device:
    """A ``torch.device`` with its index, checked against this machine: a
    mesh naming a card that is not there raises."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the mesh names {d}, but CUDA is not available")
        d = torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(f"the mesh names {d}, but this machine has {torch.cuda.device_count()} CUDA devices")
    return d


def make_mesh(
    devices: Optional[Sequence[torch.device | str]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """Build a (data, model) mesh; by default every device on the data axis.

    In one process ``devices`` defaults to every CUDA device (none raises:
    pass ``[torch.device("cpu"), ...]`` for the CPU). Under
    ``torch.distributed`` the grid holds one device per rank in rank order:
    ``devices`` lists them, else each rank gives its own (under NCCL the
    current CUDA device, which ``init_distributed`` sets to
    ``cuda:LOCAL_RANK``; under gloo the CPU) and the ranks exchange them."""
    ranks = None
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if devices is None:
            local = torch.device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
            gathered: List[Any] = [None] * world
            dist.all_gather_object(gathered, str(_device(local)))
            devices = gathered
        if len(devices) != world:
            raise ValueError(f"a mesh under torch.distributed has one device per rank: {len(devices)} for {world}")
        ranks = np.arange(world)
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu'), ...] for the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if data is None:
        if model < 1 or n % model:
            raise ValueError(f"{n} devices do not split into model columns of {model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, got {n}")
    return Mesh(_grid(devices, data, model), None if ranks is None else ranks.reshape(data, model))


def one_device_mesh(device: torch.device | str) -> Mesh:
    """A (1, 1) mesh of ``device`` in this process, whether or not
    ``torch.distributed`` is initialised."""
    return Mesh(_grid([_device(device)], 1, 1))


def local_data_parallel_mesh() -> Mesh:
    """Single-axis data mesh over every device (every rank's, under
    ``torch.distributed``)."""
    return make_mesh(model=1)


def pad_batch_to_devices(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch size >= batch_size divisible by the data-axis size."""
    d = mesh.shape[DATA_AXIS]
    return ((batch_size + d - 1) // d) * d


def _is_array(v: Any) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _split(value: Any, rows: int, n: int, devices: Sequence[torch.device]) -> List[Any]:
    """One batch entry in ``rows`` chunks of its leading axis (length ``n``),
    each on its device: arrays and tensors cut and moved (numpy through a
    zero-copy view), per-sample lists cut alike, anything else repeated."""
    if _is_array(value):
        t = torch.as_tensor(value)
        step = t.shape[0] // rows
        return [t[i * step : (i + 1) * step].to(d, non_blocking=True) for i, d in enumerate(devices)]
    if isinstance(value, list) and len(value) == n:
        step = n // rows
        return [value[i * step : (i + 1) * step] for i in range(rows)]
    return [value] * rows


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """Split a batch's leading axis over this process's data rows of the
    mesh (``mesh.local_devices``): a list with one chunk per row (in row
    order), each on that row's device. ``batch`` is a dict or a tuple of
    arrays, numpy or tensors, on the host or a device. The batch must split
    evenly."""
    devices = mesh.local_devices
    rows = len(devices)
    arrays = [v for v in batch.values() if _is_array(v)] if isinstance(batch, dict) else list(batch)
    n = int(arrays[0].shape[0])
    for v in arrays:
        if v.shape[0] % rows:
            raise ValueError(f"batch axis ({v.shape[0]}) must be divisible by {rows} (local data-axis rows)")
    if isinstance(batch, dict):
        parts = {k: _split(v, rows, n, devices) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(rows)]
    parts = [_split(v, rows, n, devices) for v in batch]
    return [tuple(p[i] for p in parts) for i in range(rows)]


def _module_device(module: torch.nn.Module) -> Optional[torch.device]:
    p = next(module.parameters(), None)
    return None if p is None else p.device


def _to(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, torch.nn.Module):
        return obj if _module_device(obj) == device else copy.deepcopy(obj).to(device)
    if hasattr(obj, "to"):  # tensors, FlameModel
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def replicate(obj: Any, mesh: Mesh) -> Dict[torch.device, Any]:
    """One copy of ``obj`` per distinct device of this process's rows:
    ``{device: copy}``. A module already on a device is used there as it is
    and deep-copied to the others; tensors, ``FlameModel`` s and dicts,
    tuples and lists of them are moved leaf by leaf."""
    return {d: _to(obj, d) for d in dict.fromkeys(mesh.local_devices)}
