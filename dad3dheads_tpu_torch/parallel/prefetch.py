"""Device prefetcher: overlap host batch preparation with device compute.
Mirrors ``dad3dheads_tpu/parallel/prefetch.py``.

The JAX package relies on asynchronous dispatch to put batch N+1 on the
device while the step for batch N runs. PyTorch copies from pageable host
memory synchronously, so on a card :func:`device_prefetch` stages each host
batch in pinned memory and copies it on a side stream, and the consuming
stream waits on that copy's event; a batch already on the card (the
synthetic loader's) is handed through as it is; on the CPU it is a plain
queue.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .mesh import DATA_AXIS, Mesh, shard_batch


def local_data_row_count(mesh: Mesh, rank: Optional[int] = None) -> int:
    """Number of distinct data-axis rows holding >= 1 device of this process
    (``rank``, default this one; in one process every device is rank 0's).

    This, not the local device count, is how many batch shards this process
    contributes: a (data, model) mesh with model > 1 replicates each batch
    row across the model column."""
    if mesh.distributed:
        owners = mesh.ranks
        rank = torch.distributed.get_rank() if rank is None else rank
    else:
        owners = np.zeros(mesh.devices.shape, dtype=np.int64)
        rank = 0 if rank is None else rank
    rows = {i for i in range(mesh.shape[DATA_AXIS]) if (owners[i] == rank).any()}
    return max(1, len(rows))


def _check_divisible(batch: Dict[str, Any], mesh: Mesh) -> None:
    divisor = local_data_row_count(mesh) if mesh.distributed else mesh.shape[DATA_AXIS]
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.shape[0] % divisor != 0:
            raise ValueError(
                f"batch axis of {k} ({v.shape[0]}) must be divisible by {divisor} (local data-axis rows)"
            )


def put_global_batch(batch: Dict[str, Any], mesh: Mesh) -> List[Dict[str, Any]]:
    """Place one batch on the mesh with the leading axis split over
    ``data``: a list with one chunk per data row of this process.

    One process: ``batch`` is the global batch, cut into one chunk per data
    row, each on its row's device. Under ``torch.distributed``: ``batch`` is
    this rank's LOCAL batch (``DataLoader`` with its data row's
    process_index/process_count yields exactly those rows), put whole on
    the rank's device, a list of one; no process materializes the global
    batch, as the reference's per-rank DistributedSampler feeds DDP.
    Per-sample lists (file names) are cut with the rows; other entries that
    are not arrays are kept as they are."""
    _check_divisible(batch, mesh)
    return shard_batch(batch, mesh)


class _InFlight:
    """One batch on its way to ``device``: host arrays and tensors staged in
    page-locked memory and copied on the ``side`` stream, with an event
    recorded there after the copies. Tensors already on a card are moved on
    the current stream (nothing, when they are on ``device``), so that every
    copy is ordered after the work that made them."""

    def __init__(self, batch: Dict[str, Any], device: torch.device, side: "torch.cuda.Stream"):
        self.device = device
        self.batch: Dict[str, Any] = {}
        self.copied: List[torch.Tensor] = []
        with torch.cuda.stream(side):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, torch.Tensor) and v.device.type == "cpu":
                    v = v.pin_memory().to(device, non_blocking=True)
                    self.copied.append(v)
                self.batch[k] = v
        for k, v in self.batch.items():
            if isinstance(v, torch.Tensor) and v.device != device:
                self.batch[k] = v.to(device)
        self.event = torch.cuda.Event()
        self.event.record(side)

    def ready(self) -> Dict[str, Any]:
        """The batch, once the current stream waits for its copies; each
        copied tensor is marked as used there, so that the allocator does
        not hand its memory back to the side stream while the step reads
        it."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(self.event)
        for v in self.copied:
            v.record_stream(current)
        return self.batch


def device_prefetch(iterator: Iterable[Dict[str, Any]], mesh: Mesh, size: int = 2) -> Iterator[Dict[str, Any]]:
    """Yield the batches of ``iterator`` on this process's device, its one
    data row of ``mesh`` (a rank's local batch under ``torch.distributed``;
    a one-process mesh with several rows splits a batch with
    :func:`put_global_batch`), keeping ``size`` batches in flight: on a card
    host arrays and tensors are copied from pinned memory on a side stream
    while the previous step runs, and tensors already on the card pass
    through; on the CPU it is a plain queue."""
    if len(mesh.local_devices) != 1:
        raise ValueError(f"{mesh}: device_prefetch feeds one data row per process; split a batch over several "
                         "rows with put_global_batch")
    device = mesh.local_device
    if device.type == "cuda":
        side = torch.cuda.Stream(device)

        def put(batch):
            return _InFlight(batch, device, side)

        def take(item):
            return item.ready()
    else:

        def put(batch):
            return shard_batch(batch, mesh)[0]

        def take(item):
            return item

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= size:
            break
    while queue:
        item = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        yield take(item)
