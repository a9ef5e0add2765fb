"""Data parallelism over `torch.distributed` (counterpart of
`nerf_lidar_tpu/parallel/`): one process per GPU, the batch split over the
ranks of the `data` axis, parameters replicated. The reference trains with
DDP over NCCL; the JAX package shards the batch over a device mesh. There
is no model, sequence or pipeline parallelism: no layer of the workload is
large enough to shard."""

from .mesh import (DataMesh, barrier, data_mesh, host_count, host_index,
                   init_distributed, is_main, main_print, maybe_data_mesh)

__all__ = ["DataMesh", "barrier", "data_mesh", "host_count", "host_index",
           "init_distributed", "is_main", "main_print", "maybe_data_mesh"]
