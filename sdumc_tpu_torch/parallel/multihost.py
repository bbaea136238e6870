"""Multi-process data parallelism for the fusion train step
(``cli.train --multihost``; the JAX package's ``parallel/multihost.py``).

N processes, one device each, every one reading its own shard of each
batch (``BatchIterator(shard_index=rank, shard_count=world)``), together
take exactly the single-process step on the global batch. JAX gets that by
jitting one program over a batch-sharded global array; here each rank:

* agrees with the others on the global batch's ``t_max`` (one max over four
  host integers, ``global_t_max``) and pads its frames to that bucket, so
  that each row sees the frames it sees in the global batch;
* gathers the per-row outputs that the loss reads (``gather_rows``): every
  rank then computes the same global loss, whose RMSE and RnC terms are no
  means over samples, and the backward keeps the rank's own rows;
* sums the gradients over the ranks (``reduce_gradients``, one all_reduce
  after the backward, what JAX's "XLA inserts the grad all-reduce" is).

Metric sums are reduced once an epoch (``process_metrics``) and the eval
predictions gathered once a pass (``gather_eval``). The collectives run on
the rank's device through the data axis's group (``DataAxis.group``: the
default group, or a column of a ``make_mesh`` grid), and every one is an
``all_reduce`` (the gradient sum of a hierarchical axis a reduce-scatter,
an all-reduce and an all-gather: ``DataAxis.all_reduce``), which gloo
takes on CUDA tensors (two ranks sharing a card) as NCCL does: one path
for both. (gloo's ``all_gather`` took CUDA tensors
too on the card's torch 2.11, ``chip_smoke.py`` phase 28; the gather's
``all_reduce`` into zeros moves world times its few kilobytes a step.)
``torch.distributed`` is imported inside the functions: importing this
module needs no distributed build.

Environment of each process: ``SDUMC_COORDINATOR=host:port`` (rank 0
listens there), ``SDUMC_NUM_PROCESSES``, ``SDUMC_PROCESS_ID`` and,
optionally, ``SDUMC_SHUTDOWN_TIMEOUT`` (seconds, default 300) for the
rendezvous and every collective.

``LocalProcesses`` starts ranks on this host with that environment and
stops them together; ``run_local_ranks`` starts the ranks of a
tensor-parallel extraction (``cli.extract text|feat4 --tp N``) with it, and
each such rank begins with ``join_model_axis`` and ends with
``finish_rank``.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sdumc_tpu_torch.data.collate import bucket_for
from sdumc_tpu_torch.data.pipeline import MODALITIES
from sdumc_tpu_torch.parallel.mesh import DataAxis, ModelAxis

# the train step's metrics that are this rank's sums (the others are the
# global batch's, equal on every rank)
LOCAL_SUMS = ("sq_err_full", "sq_err_missing", "count")


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_from_env(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        shutdown_timeout_seconds: Optional[int] = None,
                        device: str = "cuda") -> tuple:
    """Join the process group from the arguments or the SDUMC_* variables;
    returns (rank, world).

    The rendezvous is a TCP store at ``tcp://SDUMC_COORDINATOR``. Before
    ``init_process_group`` the ranks publish their host names and card
    counts there, and each picks the backend from that topology: NCCL when
    every rank of every host has a card of its own, gloo on the CPU or when
    ranks share a card (NCCL takes one rank a device). The choice is
    printed; nothing falls back. A rank runs on the card of its index among
    its host's ranks, modulo the host's cards (``cuda:{rank % cards}`` on
    one host), made the current device. ``device="cuda"`` without a card
    raises."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("SDUMC_COORDINATOR")
    num_processes = num_processes or _int_env("SDUMC_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("SDUMC_PROCESS_ID")
    seconds = shutdown_timeout_seconds or _int_env("SDUMC_SHUTDOWN_TIMEOUT") or 300
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("--multihost needs SDUMC_COORDINATOR=host:port, SDUMC_NUM_PROCESSES "
                         "and SDUMC_PROCESS_ID in each process's environment")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"SDUMC_PROCESS_ID {process_id} of {num_processes} processes")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to train "
                               "on the CPU over gloo")
        cards = torch.cuda.device_count()
    elif device == "cpu":
        cards = 0
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")

    timeout = datetime.timedelta(seconds=seconds)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    store.set(f"sdumc/rank{process_id}", f"{cards} {socket.gethostname()}")
    peers = [store.get(f"sdumc/rank{r}").decode().split(" ", 1)
             for r in range(num_processes)]
    me = peers[process_id][1]
    local = [r for r, (_, h) in enumerate(peers) if h == me]
    per_host = {}
    for c, h in peers:
        ranks, least = per_host.get(h, (0, int(c)))
        per_host[h] = (ranks + 1, min(least, int(c)))
    if device == "cpu":
        backend, why = "gloo", "--device cpu"
    elif all(ranks <= c for ranks, c in per_host.values()):
        backend, why = "nccl", "every rank has a card of its own"
    else:
        ranks, c = per_host[me]
        backend, why = "gloo", (f"{ranks} ranks share {c} card(s) on {me}; NCCL takes one "
                                f"rank a device")
    if device == "cuda":
        torch.cuda.set_device(local.index(process_id) % cards)
    print(f"multihost: backend {backend} ({why}), rendezvous tcp://{coordinator}", flush=True)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=timeout)
    return process_id, num_processes


def warmup_collectives(axis: DataAxis) -> None:
    """A barrier, then one all_reduce on the rank's device (and one over the
    host group), right after init while the ranks are in step: a
    communicator that forms late, with the ranks far apart, can time out."""
    import torch.distributed as dist

    if axis.world == 1:
        return
    dist.barrier()
    dist.all_reduce(torch.zeros(1, device=axis.device), group=axis.group)
    dist.all_reduce(torch.zeros(1, dtype=torch.int64), group=axis.host_group)


def shutdown() -> None:
    """A barrier, so that rank 0's store outlives every rank's last call,
    then ``destroy_process_group``."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def global_t_max(t_max: Sequence[int], axis: DataAxis) -> tuple:
    """The global batch's four ``t_max`` (each modality's max over every
    rank's rows; a rank without rows gives zeros): one all_reduce of four
    host integers over the host group."""
    import torch.distributed as dist

    t = torch.tensor([int(x) for x in t_max], dtype=torch.int64)
    if axis.world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.host_group)
    return tuple(t.tolist())


def pad_frames(batch: Dict, t_max: Sequence[int], buckets: Sequence[int]) -> Dict:
    """`batch` (a device dict) with ``t_max`` set to the global batch's and
    each feature's frames zero-padded, on its device, up to the bucket of
    that ``t_max`` (the global batch's bucket): each row then sees what it
    sees in the global batch."""
    out = dict(batch, t_max=tuple(t_max))
    for key, t in zip(MODALITIES, t_max):
        x = batch[key]
        frames = bucket_for(t, buckets)
        if x.shape[1] < frames:
            out[key] = torch.nn.functional.pad(x, (0, 0, 0, frames - x.shape[1]))
    return out


class _GatherRows(torch.autograd.Function):
    """[B, K] on each rank -> [world * B, K], row g from rank g % world (the
    global batch's order). The backward keeps this rank's rows of the
    incoming gradient: every rank computes the same loss of the gathered
    rows, so that slice is the gradient of the global loss with respect to
    this rank's rows, and the ranks' parameter gradients sum to the
    global one (``reduce_gradients``)."""

    @staticmethod
    def forward(ctx, x, rank, world, group):
        import torch.distributed as dist

        ctx.rank, ctx.world = rank, world
        buf = x.new_zeros((world,) + tuple(x.shape))
        buf[rank] = x
        dist.all_reduce(buf, group=group)       # x + zeros: exact
        return buf.transpose(0, 1).reshape((world * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        rows = grad.reshape((-1, ctx.world) + tuple(grad.shape[1:]))[:, ctx.rank]
        return rows, None, None, None


def gather_rows(axis: DataAxis, *tensors: torch.Tensor) -> tuple:
    """Each of `tensors` ([B, ...], this rank's rows) as the global batch's
    [world * B, ...], in the global batch's row order, through one
    all_reduce (the tensors travel packed, widened to f32, which is exact);
    gradients flow back to this rank's rows. It takes the place of the JAX
    package's ``host_local_batch_to_global``: torch needs no global array,
    only the global batch's outputs where the loss couples rows."""
    if axis.world == 1:
        return tensors
    rows = tensors[0].shape[0]
    flat = [t.reshape(rows, -1).float() for t in tensors]
    packed = _GatherRows.apply(torch.cat(flat, dim=1), axis.rank, axis.world, axis.group)
    parts = packed.split([f.shape[1] for f in flat], dim=1)
    return tuple(p.reshape((-1,) + tuple(t.shape[1:])).to(t.dtype)
                 for p, t in zip(parts, tensors))


def reduce_gradients(params, axis) -> None:
    """Sum every parameter's gradient over the ranks, in place: one
    ``axis.all_reduce`` (flat, or hierarchical on a hierarchical axis) of
    all of them flattened into one buffer. A parameter without a gradient
    keeps none (the same ones on every rank). `axis` is a ``DataAxis``, or
    a ``ModelAxis`` after ``backward()`` of ``wavlm_forward_sp``, whose
    replicated leaves (the parameters, the wave) each rank differentiates
    for its own frames."""
    grads = [p.grad for p in params if p.grad is not None]
    if axis.world == 1 or not grads:
        return
    flat = axis.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def process_metrics(sums: Dict[str, torch.Tensor], axis: DataAxis) -> Dict[str, float]:
    """An epoch's accumulated train metrics (device scalars) as floats, in
    one read-back: the ``LOCAL_SUMS`` summed over the ranks by one
    all_reduce, the others (the global batch's, equal on every rank) as
    they are."""
    import torch.distributed as dist

    keys = list(sums)
    if not keys:
        return {}
    values = torch.stack([sums[k] for k in keys])
    if axis.world > 1:
        summed = torch.tensor([k in LOCAL_SUMS for k in keys], device=values.device)
        total = torch.where(summed, values, torch.zeros_like(values))
        dist.all_reduce(total, group=axis.group)
        values = torch.where(summed, total, values)
    return dict(zip(keys, values.tolist()))


def gather_eval(arrays: Sequence[np.ndarray], axis: DataAxis, total: int) -> list:
    """Each of `arrays` (1-D, this rank's rows of an unshuffled pass:
    positions ``rank::world`` of `total`) as the whole pass's `total` rows in
    order. Shards can be ragged, so each rank pads to the largest and
    carries its count; one all_reduce (f64, exact for f32 values)."""
    import torch.distributed as dist

    cap = -(-total // axis.world)
    n = len(arrays[0])
    buf = torch.zeros(axis.world, len(arrays) * cap + 1, dtype=torch.float64)
    for i, a in enumerate(arrays):
        buf[axis.rank, i * cap:i * cap + n] = torch.from_numpy(np.asarray(a, np.float64))
    buf[axis.rank, -1] = n
    buf = buf.to(axis.device)
    dist.all_reduce(buf, group=axis.group)
    host = buf.cpu().numpy()
    counts = host[:, -1].astype(int)
    out = []
    for i, a in enumerate(arrays):
        whole = np.empty(total, np.asarray(a).dtype)
        for r in range(axis.world):
            whole[r::axis.world] = host[r, i * cap:i * cap + counts[r]]
        out.append(whole)
    return out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalProcesses:
    """Child processes on this host, started together and stopped together:
    leaving the ``with`` block kills every one still running. One that
    exits non-zero ends the others (``wait``): a rank left waiting in a
    collective would hang until its timeout."""

    def __init__(self):
        self.procs = []                 # (name, Popen, log path or None)

    def __enter__(self) -> "LocalProcesses":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def stop(self) -> None:
        """Kill every process still running and reap them all."""
        for _, p, _ in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def start(self, name: str, argv: Sequence[str], env: Optional[dict] = None,
              log: Optional[str] = None, cwd: Optional[str] = None) -> subprocess.Popen:
        """Start `argv` with this environment updated by `env`; its output
        and errors to the file `log`, else to this process's."""
        out = open(log, "w") if log else None
        try:
            p = subprocess.Popen(list(argv), env=dict(os.environ, **(env or {})), cwd=cwd,
                                 stdout=out, stderr=subprocess.STDOUT if out else None)
        finally:
            if out:
                out.close()                 # the child holds its own descriptor
        self.procs.append((name, p, log))
        return p

    def start_ranks(self, argv: Sequence[str], world: int, env: Optional[dict] = None,
                    log_dir: Optional[str] = None, cwd: Optional[str] = None) -> None:
        """Start `world` ranks of `argv`, each with the SDUMC_* environment
        of a coordinator on a free local port (``initialize_from_env``),
        rank r's output to `log_dir`/rank{r}.log when `log_dir` is given."""
        port = free_port()
        for rank in range(world):
            self.start(f"rank {rank}", argv,
                       dict(env or {}, SDUMC_COORDINATOR=f"127.0.0.1:{port}",
                            SDUMC_NUM_PROCESSES=str(world), SDUMC_PROCESS_ID=str(rank)),
                       log=os.path.join(log_dir, f"rank{rank}.log") if log_dir else None,
                       cwd=cwd)

    def wait(self, until=None, timeout: Optional[float] = None,
             poll_seconds: float = 0.2) -> None:
        """Return once every process has exited 0, or once ``until()`` is
        true. A process that exits non-zero, or `timeout` seconds passing
        first, stops them all and raises RuntimeError (with the end of the
        failed process's log, or of each running one's)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for _, p, _ in self.procs]
            failed = [i for i, c in enumerate(codes) if c]
            if failed:
                self.stop()
                name, _, log = self.procs[failed[0]]
                raise RuntimeError(f"{name} exited with code {codes[failed[0]]}; the others "
                                   f"were stopped{_tail(log)}")
            if all(c == 0 for c in codes) or (until is not None and until()):
                return
            if deadline is not None and time.monotonic() > deadline:
                running = [(n, log) for (n, _, log), c in zip(self.procs, codes) if c is None]
                self.stop()
                raise RuntimeError(f"{', '.join(n for n, _ in running)} still running after "
                                   f"{timeout} s; stopped"
                                   + "".join(f"\n{n}{_tail(log)}" for n, log in running))
            time.sleep(poll_seconds)


def _tail(log: Optional[str], lines: int = 40) -> str:
    """"; its log ends:" and the last `lines` lines of the file `log`, or ""."""
    if not log:
        return ""
    with open(log, errors="replace") as f:
        return "; its log ends:\n" + "\n".join(f.read().splitlines()[-lines:])


def run_local_ranks(stage_argv: Sequence[str], world: int) -> dict:
    """``python -m sdumc_tpu_torch.cli.extract STAGE_ARGV --tp_worker OUT``
    as `world` fresh interpreters (fresh, so no rank inherits an initialised
    CUDA), each with the SDUMC_* environment of a coordinator on a free
    local port; their output goes to this process's. Returns what rank 0
    wrote to OUT (its stage's result). A rank that exits non-zero ends the
    others and raises: nothing falls back to fewer ranks."""
    import sdumc_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(sdumc_tpu_torch.__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        with LocalProcesses() as procs:
            procs.start_ranks([sys.executable, "-m", "sdumc_tpu_torch.cli.extract", *stage_argv,
                               "--tp_worker", out], world, env={"PYTHONPATH": path})
            try:
                procs.wait()
            except RuntimeError as e:
                raise RuntimeError(f"--tp {world}: {e}") from None
        with open(out) as f:
            return json.load(f)


def join_model_axis(tp: int, device: str) -> ModelAxis:
    """In a rank that ``run_local_ranks`` started: join the group from the
    SDUMC_* environment and return the rank's model axis on its device
    (its card, or the CPU)."""
    from sdumc_tpu_torch.parallel.mesh import make_model_axis

    initialize_from_env(device=device)
    return make_model_axis(torch.device("cuda", torch.cuda.current_device())
                           if device == "cuda" else torch.device("cpu"), tp)


def finish_rank(path: str, axis: ModelAxis, result: dict) -> None:
    """The end of such a rank: rank 0 writes its stage's result to `path`
    for ``run_local_ranks``, then every rank leaves the group."""
    if axis.rank == 0:
        with open(path, "w") as f:
            json.dump(result, f)
    shutdown()
