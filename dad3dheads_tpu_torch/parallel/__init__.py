"""Meshes, data parallelism over ``torch.distributed``, the device
prefetcher and head tensor parallelism. Mirrors ``dad3dheads_tpu/parallel``."""

from .data_parallel import all_reduce_gradients, all_reduce_mean, data_group, init_distributed, set_sync_bn
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    local_data_parallel_mesh,
    make_mesh,
    one_device_mesh,
    pad_batch_to_devices,
    replicate,
    shard_batch,
)
from .prefetch import device_prefetch, local_data_row_count, put_global_batch
from .tensor_parallel import gather_state_dict, shard_heads, sharded_parameters

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "one_device_mesh",
    "shard_batch",
    "replicate",
    "pad_batch_to_devices",
    "local_data_parallel_mesh",
    "local_data_row_count",
    "put_global_batch",
    "device_prefetch",
    "data_group",
    "set_sync_bn",
    "all_reduce_gradients",
    "all_reduce_mean",
    "init_distributed",
    "shard_heads",
    "sharded_parameters",
    "gather_state_dict",
]
