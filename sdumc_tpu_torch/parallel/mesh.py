"""The data, model and stage axes of a multi-process run, and a rank's rows
of a batch.

The JAX package's ``parallel/mesh.py`` builds a device mesh over which one
jitted program shards the batch (the ``data`` axis, or ``("dcn", "data")``
on a hierarchical mesh) or the weights (the ``model`` axis). Here every
process is one rank with one device, holding its own rows or its own weight
shards as local tensors: an axis is rank, world, device, and the process
group that carries its collectives.

* ``make_data_axis``: every process one data rank (``cli.train
  --multihost``).
* ``make_mesh``: a ``data x model`` grid, as JAX's ``make_mesh(data_parallel,
  model_parallel)``: process ``r = d * model_parallel + m`` (the row-major
  order of JAX's ``grid.reshape``) is data rank ``d`` and model rank ``m``,
  each axis over a process group of its own.
* ``make_hierarchical_mesh``: a data axis over ``dcn x ici`` ranks whose
  gradient sum is hierarchical (``DataAxis.all_reduce``).

The model axis carries the two collectives of tensor parallelism (forward
only: JAX's tensor parallelism serves the extractors and takes no
gradient), a sum of partial outputs and a gather along the last dimension;
the point-to-point exchange of ring attention and of the GPipe pipeline,
whose stages are the ranks of a model axis (``parallel/pipeline.py``); and
a broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

HALF = (torch.bfloat16, torch.float16)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` (contiguous) as every backend carries it exactly: a
    half-precision tensor as its bytes (a uint8 view; gloo's broadcast
    takes no int16), any other as it is."""
    return t.view(torch.uint8) if t.dtype in HALF else t


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """One rank of the data axis. ``group`` (None: the default group)
    carries the step's collectives (rows, gradients, metric sums) on the
    rank's `device`; ``host_group`` carries host integers (each step's
    ``t_max``): a gloo group, None when the default group is gloo itself
    and the axis spans it. ``ici`` > 1 (``make_hierarchical_mesh``): the
    ranks form pods of ``ici`` consecutive ranks, ``ici_group`` this rank's
    pod and ``dcn_group`` the ranks at its place in every pod."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    host_group: Optional[Any] = None
    group: Optional[Any] = None
    ici: int = 1
    ici_group: Optional[Any] = None
    dcn_group: Optional[Any] = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a 1-D ``x`` over the ranks, in place (returned). On a
        hierarchical axis it is the exchange XLA emits for JAX's ``("dcn",
        "data")`` sum: a reduce-scatter inside the pod (each of its ``ici``
        ranks sums one ``1 / ici`` part of ``x``), an all-reduce of that
        part across the pods, and an all-gather of the parts inside the
        pod; the same sum, added in another order."""
        import torch.distributed as dist

        if self.world == 1:
            return x
        if self.ici_group is None:
            dist.all_reduce(x, group=self.group)
            return x
        n = x.numel()
        part = -(-n // self.ici)
        buf = x.new_zeros(part * self.ici)
        buf[:n] = x
        parts = list(buf.split(part))
        mine = torch.empty_like(parts[0])
        dist.reduce_scatter(mine, parts, group=self.ici_group)
        dist.all_reduce(mine, group=self.dcn_group)
        dist.all_gather(parts, mine, group=self.ici_group)
        x.copy_(buf[:n])
        return x


def _host_group():
    """The gloo group for the host integers of an axis over every process:
    None (the default group) when that is gloo, else a new gloo group (a
    collective: every rank makes it)."""
    import torch.distributed as dist

    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


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
    return DataAxis(rank, world, device, _host_group())


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of a global batch dict: rows ``rank::world`` of
    every array or tensor (the rows a sharded ``BatchIterator`` gives that
    rank), ``t_max`` and the frame buckets those of the global batch."""
    return {k: v if k == "t_max" else v[rank::world] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One rank of the model (tensor-parallel) axis: ``world`` ranks, each
    holding its shard of every split weight on ``device``; or of the
    sequence axis of ``parallel.wavlm_forward_sp``, each holding a slice of
    the frames; or of the stage axis of ``parallel.pipeline``, each holding
    a stage's layers. ``group`` carries the collectives (None: the default
    group). ``all_reduce`` and ``gather_last`` are each an ``all_reduce``
    on the rank's device, which gloo takes on CUDA tensors (ranks sharing a
    card) as NCCL does; half-precision tensors travel and sum in f32 and are
    rounded once. ``exchange`` (ring attention, the pipeline) is
    point-to-point."""

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

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank `src`'s ``x`` on every rank, in place (returned); exact,
        half precision as its bit patterns."""
        import torch.distributed as dist

        if self.world > 1:
            root = src if self.group is None else dist.get_global_rank(self.group, src)
            dist.broadcast(_wire(x), src=root, group=self.group)
        return x

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]) -> list:
        """Point-to-point: each ``(tensor, peer)`` of `sends` goes to the
        axis's rank ``peer``, and for each ``(like, peer)`` of `recvs` a new
        tensor of ``like``'s shape and dtype, on the rank's device, is
        received from ``peer``; returns those, in order. Half precision
        travels as its bit patterns (exact).

        Every send and receive is posted at once (``batch_isend_irecv``) and
        then waited for, so no rank blocks in a send that its peer has not
        matched. NCCL sends device tensors as they are. gloo's point-to-point
        reads a tensor's memory from the host, so a CUDA tensor on gloo (ranks
        sharing a card) travels through a page-locked host copy each way; its
        collectives take CUDA tensors, its send and recv do not. The group's
        timeout (``SDUMC_SHUTDOWN_TIMEOUT``) bounds each wait."""
        import torch.distributed as dist

        staged = (self.device.type == "cuda"
                  and dist.get_backend(self.group) == dist.Backend.GLOO)

        def peer(r):
            return r if self.group is None else dist.get_global_rank(self.group, r)

        def buffer(t):
            if not staged:
                return torch.empty(t.shape, dtype=t.dtype, device=self.device)
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        outgoing = [t.contiguous() if not staged else buffer(t).copy_(t) for t, _ in sends]
        incoming = [buffer(t) for t, _ in recvs]
        ops = ([dist.P2POp(dist.isend, _wire(t), peer(r), self.group)
                for t, (_, r) in zip(outgoing, sends)]
               + [dist.P2POp(dist.irecv, _wire(t), peer(r), self.group)
                  for t, (_, r) in zip(incoming, recvs)])
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if staged:
            return [t.to(self.device, non_blocking=True) for t in incoming]
        return incoming

    def ring_shift(self, tensors):
        """One turn of the ring: each of `tensors` goes to rank (rank + 1) %
        world, and the list returned holds rank (rank - 1) % world's, in new
        tensors of the same shapes, dtypes and device (``exchange``)."""
        tensors = list(tensors)
        if self.world == 1:
            return tensors
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        return self.exchange([(t, nxt) for t in tensors], [(t, prv) for t in tensors])


def _warm(device, *groups) -> None:
    """A barrier, then one all_reduce on `device` over each group, while the
    ranks are in step (a communicator that forms late can time out)."""
    import torch.distributed as dist

    dist.barrier()
    for g in groups:
        dist.all_reduce(torch.zeros(1, device=device), group=g)


def make_model_axis(device, tp: int = 1) -> ModelAxis:
    """The model axis of this process: this process alone for ``tp`` 1, else
    every process of the initialized default group
    (``multihost.initialize_from_env``), whose size must be ``tp``. Then a
    collective: a barrier and one all_reduce on ``device`` while the ranks
    are in step, so every rank calls it once. A model axis over a subgroup
    comes from ``make_mesh``."""
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
    _warm(device, None)
    return axis


def _grid_world(shape: Tuple[int, int]) -> Tuple[int, int]:
    """(rank, world) of this process for a grid of `shape`'s size: (0, 1)
    when no group is initialized and the grid is one rank; raises unless
    the processes fill the grid."""
    import torch.distributed as dist

    size = shape[0] * shape[1]
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise ValueError(f"a {shape[0]} x {shape[1]} grid needs {size} processes in one "
                             "group (multihost.initialize_from_env); none is initialized")
        return 0, 1
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != size:
        raise ValueError(f"a {shape[0]} x {shape[1]} grid with {world} processes: each "
                         "process is one cell of the grid")
    return rank, world


def _groups(rows: Sequence[Sequence[int]], rank: int, backend: Optional[str] = None):
    """One new group for each list of ranks in `rows`, made in order on every
    rank (as torch requires); returns the one that holds `rank`."""
    import torch.distributed as dist

    mine = None
    for ranks in rows:
        g = dist.new_group(list(ranks), backend=backend)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(device, data_parallel: int = -1, model_parallel: int = 1
              ) -> Tuple[DataAxis, ModelAxis]:
    """(data axis, model axis) of this process on a ``data_parallel x
    model_parallel`` grid of every process of the initialized default group
    (``data_parallel`` -1: the processes over ``model_parallel``): process
    ``r = d * model_parallel + m``, JAX's ``make_mesh`` order, is data rank
    ``d`` (with the processes of its column ``m``) and model rank ``m``
    (with those of its row ``d``). Each axis has a group of its own. The
    grid of one cell needs no group. A collective: every rank calls it
    once, and it ends by warming every group it made."""
    import torch.distributed as dist

    device = torch.device(device)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if data_parallel == -1:
        if world % model_parallel:
            raise ValueError(f"{world} processes do not divide into model_parallel "
                             f"{model_parallel}")
        data_parallel = world // model_parallel
    D, M = data_parallel, model_parallel
    rank, world = _grid_world((D, M))
    if world == 1:
        return DataAxis(device=device), ModelAxis(device=device)
    d, m = divmod(rank, M)
    columns = [[dd * M + mm for dd in range(D)] for mm in range(M)]
    data = _groups(columns, rank)
    host = data if dist.get_backend() == "gloo" else _groups(columns, rank, "gloo")
    model = _groups([[dd * M + mm for mm in range(M)] for dd in range(D)], rank)
    _warm(device, data, model)
    return DataAxis(d, D, device, host, data), ModelAxis(m, M, device, model)


def make_hierarchical_mesh(device, dcn: int, ici: int) -> DataAxis:
    """The data axis of this process on a ``dcn x ici`` layout of every
    process of the initialized default group, as JAX's
    ``make_hierarchical_mesh(dcn, ici)`` with batches sharded over
    ``("dcn", "data")``: process ``r = o * ici + i`` holds the global
    batch's data rank ``r``; ``ici`` consecutive ranks form a pod (the fast
    inner level), ``dcn`` pods the slow outer one. Rows, metrics and
    predictions travel over the whole axis as on a flat one; the gradient
    sum is hierarchical (``DataAxis.all_reduce``). One rank needs no group.
    A collective: every rank calls it once."""
    import torch.distributed as dist

    device = torch.device(device)
    rank, world = _grid_world((dcn, ici))
    if world == 1:
        return DataAxis(device=device)
    pods = [[o * ici + i for i in range(ici)] for o in range(dcn)]
    ici_group = _groups(pods, rank)
    dcn_group = _groups([[o * ici + i for o in range(dcn)] for i in range(ici)], rank)
    host = _host_group()
    _warm(device, None, ici_group, dcn_group)
    return DataAxis(rank, world, device, host, None, ici, ici_group, dcn_group)
