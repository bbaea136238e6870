"""The data and model axes of a multi-process run, and a rank's rows of a
batch.

The JAX package's ``parallel/mesh.py`` builds a device mesh over which one
jitted program shards the batch (the ``data`` axis) or the weights (the
``model`` axis, ``make_mesh(data_parallel=1, model_parallel=tp)``). Here
every process is one rank with one device, holding its own rows or its own
weight shards as local tensors: an axis is rank, world, device, and the
process group that carries its collectives. The model axis carries the two
collectives of tensor parallelism (forward only: JAX's tensor parallelism
serves the extractors and takes no gradient): a sum of partial outputs and
a gather along the last dimension. ``make_hierarchical_mesh`` waits for the
GPipe slice.
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


HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One rank of the model (tensor-parallel) axis: ``world`` ranks, each
    holding its shard of every split weight on ``device``; or of the
    sequence axis of ``parallel.wavlm_forward_sp``, each holding a slice of
    the frames. ``group`` carries the collectives (None: the default group).
    Each collective is an ``all_reduce`` on the rank's device, which gloo
    takes on CUDA tensors (ranks sharing a card) as NCCL does; half-precision
    tensors travel and sum in f32 and are rounded once. ``ring_shift`` is
    point-to-point (ring attention)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each rank's partial ``x`` (an f32 ``x``
        is summed in place and returned)."""
        import torch.distributed as dist

        buf = x.float() if x.dtype in HALF else x
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.dtype)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """[..., n] on each rank -> [..., world * n], rank r's columns at [r
        * n, (r + 1) * n): an all_reduce of a zeroed [world, ..., n] buffer
        that holds ``x`` in row ``rank`` (x plus zeros: exact)."""
        import torch.distributed as dist

        buf = x.new_zeros((self.world,) + tuple(x.shape),
                          dtype=torch.float32 if x.dtype in HALF else x.dtype)
        buf[self.rank] = x
        dist.all_reduce(buf, group=self.group)
        return buf.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,)).to(x.dtype)

    def ring_shift(self, tensors):
        """One turn of the ring: each of `tensors` goes to rank (rank + 1) %
        world, and the list returned holds rank (rank - 1) % world's, in new
        tensors of the same shapes, dtypes and device.

        Every send and receive is posted at once (``batch_isend_irecv``) and
        then waited for, so no rank blocks in a send that its peer has not
        matched. NCCL sends device tensors as they are. gloo's point-to-point
        reads a tensor's memory from the host, so a CUDA tensor on gloo (ranks
        sharing a card) travels through a page-locked host copy each way; its
        collectives take CUDA tensors, its send and recv do not. The group's
        timeout (``SDUMC_SHUTDOWN_TIMEOUT``) bounds each wait."""
        import torch.distributed as dist

        tensors = list(tensors)
        if self.world == 1:
            return tensors
        peers = [(self.rank + 1) % self.world, (self.rank - 1) % self.world]
        if self.group is not None:
            peers = [dist.get_global_rank(self.group, r) for r in peers]
        staged = (self.device.type == "cuda"
                  and dist.get_backend(self.group) == dist.Backend.GLOO)

        def buffer(t):
            if not staged:
                return torch.empty_like(t, memory_format=torch.contiguous_format)
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        outgoing = [t.contiguous() if not staged else buffer(t).copy_(t) for t in tensors]
        incoming = [buffer(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, peers[0], self.group) for t in outgoing]
               + [dist.P2POp(dist.irecv, t, peers[1], self.group) for t in incoming])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            return [t.to(self.device, non_blocking=True) for t in incoming]
        return incoming


def make_model_axis(device, tp: int = 1) -> ModelAxis:
    """The model axis of this process: this process alone for ``tp`` 1, else
    every process of the initialized default group
    (``multihost.initialize_from_env``), whose size must be ``tp``. Then a
    collective: a barrier and one all_reduce on ``device`` while the ranks
    are in step (a communicator that forms late can time out), so every
    rank calls it once."""
    import torch.distributed as dist

    device = torch.device(device)
    if tp == 1:
        return ModelAxis(device=device)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"--tp {tp} needs {tp} processes in one group "
                         "(multihost.initialize_from_env); none is initialized")
    if dist.get_world_size() != tp:
        raise ValueError(f"--tp {tp} with {dist.get_world_size()} processes")
    axis = ModelAxis(dist.get_rank(), tp, device)
    dist.barrier()
    axis.all_reduce(torch.zeros(1, device=device))
    return axis
