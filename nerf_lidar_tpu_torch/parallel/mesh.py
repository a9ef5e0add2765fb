"""Data-parallel mesh and collectives over `torch.distributed` (counterpart
of `nerf_lidar_tpu/parallel/mesh.py`).

One process per GPU. The JAX package shards the batch over the `data` axis
of a device mesh and XLA inserts the gradient sum; here every rank holds
the whole model, computes its rows of the global batch, and the train step
sums the gradients itself (`train/train_step.py`). `DataMesh` says which
rows a rank owns; the collectives below are the only ones the port uses:
`all_reduce` (sum), `all_gather` (with autograd through it), `broadcast`
and `barrier`, which NCCL and gloo both implement on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Gradients at most this large are summed through one flat buffer; larger
# ones (the hash tables) are summed in place, one collective each.
BUCKET_BYTES = 32 << 20


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(multihost: bool = False,
                     device: Optional[torch.device] = None) -> None:
    """Join the process group of a `torchrun` launch (its `RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `GROUP_RANK` and
    `MASTER_ADDR` / `MASTER_PORT`), over NCCL for a CUDA device and gloo
    for the CPU. A group that is already initialised is kept as it is,
    backend included (a caller may build its own, e.g. gloo over CUDA
    tensors of one card). No-op for a world of 1. A group over several
    hosts needs `multihost`, as the JAX CLI brings up its multi-host
    runtime only under `--multihost`."""
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return
    if not multihost and _env_int("LOCAL_WORLD_SIZE", world) != world:
        raise SystemExit(
            f"this launch spans several hosts (WORLD_SIZE {world}, "
            f"LOCAL_WORLD_SIZE {os.environ['LOCAL_WORLD_SIZE']}): pass "
            "--multihost")
    cuda = device is not None and device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            rank=_env_int("RANK", 0), world_size=world,
                            device_id=device if cuda else None)


def host_index() -> int:
    """This process's host in a multi-host launch (torchrun's
    `GROUP_RANK`), the JAX `jax.process_index()` of `--multihost`."""
    return _env_int("GROUP_RANK", 0)


def host_count() -> int:
    """The hosts of the launch (WORLD_SIZE / LOCAL_WORLD_SIZE, 1 without
    torchrun), the JAX `jax.process_count()` of `--multihost`: one process
    a host there, so a loader that shards by host gives every rank of a
    host the host's share."""
    world = _env_int("WORLD_SIZE", 1)
    return max(world // _env_int("LOCAL_WORLD_SIZE", world), 1)


def is_main() -> bool:
    """True on rank 0, or without a process group: the one process that
    writes files and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def main_print(*args, **kwargs) -> None:
    if is_main():
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of the process group laid out as `np.arange(world)
    .reshape(shape)` with named axes, as the JAX mesh reshapes its device
    array. The batch is split over the axis named "data"; ranks that share
    a data index (replicas along the other axes) compute the same rows, as
    JAX's replicas do."""

    rank: int
    world: int
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def _grid(self) -> np.ndarray:
        return np.arange(self.world).reshape(self.shape)

    @property
    def _axis(self) -> int:
        return self.axes.index("data") if "data" in self.axes else 0

    @property
    def data_size(self) -> int:
        return self._grid.shape[self._axis]

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self._grid == self.rank)[0][self._axis])

    @property
    def shard_ranks(self) -> Tuple[int, ...]:
        """For each data index in order, the lowest rank that holds it: the
        ranks whose rows `all_gather_rows` puts in the global batch."""
        grid = np.moveaxis(self._grid, self._axis, 0)
        return tuple(int(g.min()) for g in grid)

    def rows(self, n: int) -> slice:
        """This rank's rows of an n-row global batch, as `P("data")`
        places them: [d n / D, (d + 1) n / D)."""
        if n % self.data_size:
            raise ValueError(f"{n} rows do not split over {self.data_size} "
                             "data shards")
        per = n // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over every rank, in place; returns it."""
        dist.all_reduce(t)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-row tensor [n, ...]: every data shard's
        rows in data order, [D n, ...]. Differentiable: the backward sums
        the gradient over the ranks and hands each shard rank its rows."""
        return _GatherRows.apply(t, self)

    def all_reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every parameter's gradient over the ranks, in place. A
        parameter without one gets zeros first (its rows may have taken no
        gradient on this rank only). Small gradients travel in flat buckets
        of up to BUCKET_BYTES of one dtype; larger ones alone."""
        bucket: List[torch.Tensor] = []
        size = 0

        def flush():
            nonlocal bucket, size
            if bucket:
                flat = torch.cat([g.reshape(-1) for g in bucket])
                dist.all_reduce(flat)
                for g, part in zip(bucket, flat.split(
                        [g.numel() for g in bucket])):
                    g.copy_(part.view_as(g))
            bucket, size = [], 0

        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad
            nbytes = g.numel() * g.element_size()
            if nbytes >= BUCKET_BYTES:
                dist.all_reduce(g)
                continue
            if bucket and (bucket[0].dtype != g.dtype
                           or size + nbytes > BUCKET_BYTES):
                flush()
            bucket.append(g)
            size += nbytes
        flush()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh: DataMesh):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t)
        ctx.mesh = mesh
        ctx.n = t.shape[0]
        return torch.cat([parts[r] for r in mesh.shard_ranks])

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g)
        if mesh.rank not in mesh.shard_ranks:
            return torch.zeros_like(g[:ctx.n]), None
        return g[mesh.rows(g.shape[0])], None


def data_mesh(rank: int, world: int, shape=(-1,),
              axes=("data",)) -> DataMesh:
    """The DataMesh of `rank` in a world of `world` ranks laid out as
    `shape` with axis names `axes`."""
    resolved = np.arange(world).reshape(tuple(shape)).shape
    return DataMesh(rank, world, tuple(int(s) for s in resolved),
                    tuple(axes) if axes else ("data",))


def maybe_data_mesh(shape=(-1,), axes=("data",)) -> Optional[DataMesh]:
    """The mesh of the initialised process group, or None without one or
    for a world of 1 (the single-GPU path needs no collective).
    shape / axes come from `Config.mesh_shape` / `mesh_axes`; a multi-axis
    shape such as (-1, 2) with ("data", "model") splits the batch over the
    "data" rows of the rank grid."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return data_mesh(dist.get_rank(), dist.get_world_size(), shape, axes)
