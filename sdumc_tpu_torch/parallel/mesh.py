"""The data axis of a data-parallel run, and a rank's rows of a batch.

The JAX package's ``parallel/mesh.py`` builds a device mesh over which one
jitted program shards the batch. Here every process is one rank with one
device, holding its own rows as local tensors: the mesh reduces to the data
axis: rank, world, device, and the default process group that carries its
collectives. ``make_hierarchical_mesh`` and the model axis wait for the
GPipe and tensor-parallel slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """One rank of the data axis. The default process group carries the
    step's collectives (rows, gradients, metric sums) on the rank's
    `device`; ``host_group`` carries host integers (each step's ``t_max``):
    a gloo group, None when the default group is gloo itself."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    host_group: Optional[Any] = None


def make_data_axis(device, data_parallel: int = -1) -> DataAxis:
    """The data axis of this process: every process of the initialized
    default group (``multihost.initialize_from_env``), else this process
    alone. ``data_parallel`` (``--data_parallel``) must be -1 or the number
    of processes. A collective when the default group is NCCL (it creates
    the gloo group for host integers): every rank calls it once."""
    import torch.distributed as dist

    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if data_parallel not in (-1, 1):
            raise ValueError(f"--data_parallel {data_parallel}: a single process trains on "
                             "one device; run N processes with --multihost")
        return DataAxis(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if data_parallel not in (-1, world):
        raise ValueError(f"--data_parallel {data_parallel} with {world} processes: give -1 or "
                         f"{world} (each process is one data-parallel rank)")
    host_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return DataAxis(rank, world, device, host_group)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of a global batch dict: rows ``rank::world`` of
    every array or tensor (the rows a sharded ``BatchIterator`` gives that
    rank), ``t_max`` and the frame buckets those of the global batch."""
    return {k: v if k == "t_max" else v[rank::world] for k, v in batch.items()}
