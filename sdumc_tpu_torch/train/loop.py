"""The epoch loop: train, eval and test passes, best-MAE selection,
checkpoints, resume and preemption.

``sdumc_tpu/train/loop.py``. Per epoch: the train pass, accumulating its
metrics on the device and reading them back once; an eval and a test pass
over both views; the best test MAE per view (``<=``) saved as
``best_full.pt`` / ``best_missing.pt``; a resumable ``latest.pt``; one log
line. Checkpoints are torch files in the reference's format,
``{'epoch', 'state_dict', 'optimizer'}``, so ``cli.infer --checkpoint``
reads the best ones; ``latest.pt`` also holds the step, the schedule and
the two bests.

Data-parallel (a ``parallel.DataAxis`` of W ranks, the JAX loop's
``shard`` and ``multihost``): each rank reads its shard of every batch at
``batch_size // W`` rows and takes the same number of steps, and the
global batch's ``t_max`` is agreed each step (JAX pads every multihost
batch to the largest bucket, since its global arrays need one shape; here
each rank holds local tensors, so the ranks pad to the global batch's own
bucket, which gives each row the frames it has in the single-process
batch). Eval passes run the same way and gather the predictions, so every
rank computes the same metrics; rank 0 alone writes checkpoints and the
others wait at a barrier. Each rank polls its own ``PreemptionGuard``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from sdumc_tpu_torch.core.config import ExperimentConfig
from sdumc_tpu_torch.core.metrics import eval_mosei_metric
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
from sdumc_tpu_torch.parallel.mesh import DataAxis
from sdumc_tpu_torch.parallel.multihost import (gather_eval, global_t_max, pad_frames,
                                                process_metrics, warmup_collectives)
from sdumc_tpu_torch.train.state import TrainState, create_train_state
from sdumc_tpu_torch.train.step import batch_to_device_dict, make_eval_step, make_train_step


def _pad_partial(batch, bs):
    """Repeat-pad a partial eval batch to the batch size (rows are
    independent in eval; preds are sliced back on the host). An int8
    store's scales are padded with their rows (the JAX package's
    ``_pad_partial`` leaves them, and its eval over such a store fails
    for a last batch of 2 to bs - 1 clips)."""
    n = batch.size
    if n == bs:
        return batch, n
    reps = [min(n - 1, i) for i in range(n, bs)]

    def pad(arr):
        return np.concatenate([arr, arr[reps]], axis=0)

    padded = dataclasses.replace(
        batch,
        audio=pad(batch.audio), text=pad(batch.text), video=pad(batch.video),
        feat4=pad(batch.feat4), emos=pad(batch.emos), vals=pad(batch.vals),
        lengths=np.concatenate([batch.lengths, batch.lengths[:, reps]], axis=1),
        names=batch.names + [batch.names[-1]] * len(reps),
        scales={k: pad(v) for k, v in batch.scales.items()} if batch.scales else None,
    )
    return padded, n


def run_eval(eval_step, dataset: MoseiDataset, cfg: ExperimentConfig,
             device="cpu", axis: Optional[DataAxis] = None):
    """Full eval pass -> dict with preds, labels and metrics for both views.

    Data-parallel: each rank evaluates its shard, each global batch at its
    agreed ``t_max``; the predictions and labels are gathered across the
    ragged shards into the pass's order (``names`` None), so every rank
    computes the same metrics, the single-process pass's."""
    device = torch.device(device)
    axis = axis if axis is not None else DataAxis(device=device)
    world = axis.world
    bs = cfg.data.batch_size // world
    it = iter(BatchIterator(dataset, bs, shuffle=False, buckets=cfg.data.length_buckets,
                            pin_memory=device.type == "cuda", shard_index=axis.rank,
                            shard_count=world))
    preds_full, preds_missing, labels, names = [], [], [], []
    # a rank whose shard ends early still joins each global batch's t_max
    for _ in range(math.ceil(len(dataset) / (bs * world))):
        batch = next(it, None)
        if world > 1:
            t_max = global_t_max(batch.t_max if batch is not None else (0,) * 4, axis)
        if batch is None:
            continue
        padded, n = _pad_partial(batch, bs)
        d = batch_to_device_dict(padded, device, cfg.data.feature_dtype)
        if world > 1:
            d = pad_frames(d, t_max, cfg.data.length_buckets)
        v0, v1 = eval_step(d)
        preds_full.append(v0[:n].cpu().numpy())
        preds_missing.append(v1[:n].cpu().numpy())
        labels.append(batch.vals)
        names.extend(batch.names)
    preds_full = np.concatenate(preds_full) if preds_full else np.zeros((0,), np.float32)
    preds_missing = (np.concatenate(preds_missing) if preds_missing
                     else np.zeros((0,), np.float32))
    labels = np.concatenate(labels) if labels else np.zeros((0,), np.float32)
    if world > 1:
        preds_full, preds_missing, labels = gather_eval(
            (preds_full, preds_missing, labels), axis, len(dataset))
        names = None
    return {
        "val_preds_full": preds_full,
        "val_preds_missing": preds_missing,
        "val_labels": labels,
        "names": names,
        "val_mse_full": float(np.mean((preds_full - labels) ** 2)),
        "val_mse_missing": float(np.mean((preds_missing - labels) ** 2)),
        "metric_full": eval_mosei_metric(preds_full, labels, names),
        "metric_missing": eval_mosei_metric(preds_missing, labels, names),
    }


class PreemptionGuard:
    """SIGTERM watcher for preemptible machines: the epoch loop polls
    ``fired`` once per step; on a signal it saves the epoch-boundary state
    as a resumable ``latest.pt`` and returns, and ``--resume`` redoes the
    interrupted epoch. The previous handler is chained; installation is
    skipped off the main thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.fired = False
        for sig in signals:
            try:
                prev = signal.getsignal(sig)

                def handler(signum, frame, _prev=prev):
                    self.fired = True
                    if callable(_prev):
                        _prev(signum, frame)

                signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass


def _to_host(obj):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state: TrainState) -> Dict:
    return {"state_dict": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "scheduler": state.scheduler.state_dict(), "step": state.step}


def _restore(state: TrainState, blob: Dict) -> None:
    state.model.load_state_dict(blob["state_dict"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])


def _best(metric: Dict, epoch: int) -> Dict:
    return {**{k: float(v) for k, v in metric.items()}, "epoch": epoch}


def train(cfg: ExperimentConfig, model, train_ds: MoseiDataset, eval_ds: MoseiDataset,
          test_ds: MoseiDataset, device="cpu", log=print, resume_from: Optional[str] = None,
          preemption_guard=None, axis: Optional[DataAxis] = None) -> Dict:
    """Train `model` (already on `device`) for ``cfg.train.epochs``; returns
    {"state", "best_full", "best_missing", "history"} (and "preempted").
    `axis`: this process's rank of a data-parallel run (the model's weights
    equal on every rank), else a single process."""
    device = torch.device(device)
    axis = axis if axis is not None else DataAxis(device=device)
    world = axis.world
    if world > 1:
        warmup_collectives(axis)
    guard = preemption_guard if preemption_guard is not None else PreemptionGuard()
    bs = cfg.data.batch_size
    local_bs = bs // world
    if local_bs < 1:
        raise ValueError(f"batch size {bs} over {world} ranks")
    # every rank takes the same number of steps (a rank that took one more
    # would wait in its collectives for ever); the count needs no exchange
    n_steps = (len(train_ds) // world) // local_bs
    state = create_train_state(model, cfg.train, max(len(train_ds) // bs, 1))
    train_step = make_train_step(state, cfg.loss, cfg.train.seed, axis)
    eval_step = make_eval_step(model)

    best_full = {"mae": float("inf")}
    best_missing = {"mae": float("inf")}
    history = []
    start_epoch = 0
    if resume_from:
        blob = load_checkpoint_full(resume_from, state)
        start_epoch = blob["epoch"] + 1
        best_full, best_missing = blob["best_full"], blob["best_missing"]
        log(f"resumed from {resume_from} at epoch {start_epoch}")

    for epoch in range(start_epoch, cfg.train.epochs):
        # epoch-boundary snapshot on the host: what a preemption mid-epoch
        # saves, so that the resumed run replays this epoch exactly
        boundary = _snapshot(state)
        t0 = time.time()
        it = BatchIterator(train_ds, local_bs, shuffle=True, seed=cfg.data.shuffle_seed,
                           epoch=epoch, buckets=cfg.data.length_buckets,
                           pin_memory=device.type == "cuda", drop_remainder=True,
                           shard_index=axis.rank, shard_count=world)
        acc, n_clips, steps = None, 0, 0
        for batch in itertools.islice(it, n_steps):
            d = batch_to_device_dict(batch, device, cfg.data.feature_dtype)
            if world > 1:
                d = pad_frames(d, global_t_max(batch.t_max, axis), cfg.data.length_buckets)
            metrics = train_step(d)
            acc = metrics if acc is None else {k: acc[k] + v for k, v in metrics.items()}
            n_clips += batch.size
            steps += 1
            if guard.fired:
                break
        if guard.fired:
            _restore(state, boundary)
            if axis.rank == 0:
                save_checkpoint(cfg, state, "latest", epoch - 1, best_full, best_missing)
            _barrier(axis)
            log(f"preemption signal: saved resumable checkpoint, "
                f"epoch {epoch} will be redone on --resume")
            return {"state": state, "best_full": best_full, "best_missing": best_missing,
                    "history": history, "preempted": True}
        # the one read-back of the epoch's train metrics (summed over the ranks)
        sums = process_metrics(acc or {}, axis)
        train_time = time.time() - t0
        cnt = max(sums.get("count", 0.0), 1.0)
        train_mse_full = sums.get("sq_err_full", 0.0) / cnt
        train_mse_missing = sums.get("sq_err_missing", 0.0) / cnt

        eval_results = run_eval(eval_step, eval_ds, cfg, device, axis)
        test_results = run_eval(eval_step, test_ds, cfg, device, axis)
        tr_full, tr_missing = test_results["metric_full"], test_results["metric_missing"]
        saves = []
        if tr_full["mae"] <= best_full["mae"]:
            best_full = _best(tr_full, epoch)
            saves.append(("best_full", None, None))
        if tr_missing["mae"] <= best_missing["mae"]:
            best_missing = _best(tr_missing, epoch)
            saves.append(("best_missing", None, None))
        saves.append(("latest", best_full, best_missing))
        if axis.rank == 0:
            for tag, full, missing in saves:
                save_checkpoint(cfg, state, tag, epoch, full, missing)
        _barrier(axis)

        clips_per_sec = n_clips / max(train_time, 1e-9)
        log(f"epoch:{epoch + 1}; train_val_mse_full:{train_mse_full:.4f}; "
            f"train_val_mse_missing:{train_mse_missing:.4f}; "
            f"test_mae_full:{tr_full['mae']:.4f}; test_mae_missing:{tr_missing['mae']:.4f}; "
            f"{clips_per_sec:.1f} clips/s")
        history.append({
            "epoch": epoch,
            "train_loss": sums.get("loss", 0.0) / max(steps, 1),
            "train_mse_full": train_mse_full,
            "train_mse_missing": train_mse_missing,
            "eval_mse_full": eval_results["val_mse_full"],
            "test": {"full": tr_full, "missing": tr_missing},
            "clips_per_sec": clips_per_sec,
        })
    return {"state": state, "best_full": best_full, "best_missing": best_missing,
            "history": history}


def _barrier(axis: DataAxis) -> None:
    """The ranks wait for rank 0's checkpoints."""
    if axis.world > 1:
        import torch.distributed as dist

        dist.barrier()


def save_checkpoint(cfg: ExperimentConfig, state: TrainState, tag: str, epoch: int,
                    best_full: Optional[Dict] = None, best_missing: Optional[Dict] = None) -> str:
    """``{checkpoint_dir}/{tag}.pt`` in the reference's format ({'epoch',
    'state_dict', 'optimizer'}, tensors on the CPU); ``latest`` also holds
    the step, the schedule and the bests, for ``--resume``."""
    blob = {"epoch": int(epoch), **_snapshot(state)}
    if tag != "latest":
        del blob["scheduler"], blob["step"]
    else:
        blob["best_full"], blob["best_missing"] = best_full, best_missing
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    path = os.path.join(cfg.train.checkpoint_dir, f"{tag}.pt")
    torch.save(blob, path)
    return path


def load_checkpoint_full(path: str, state: TrainState) -> Dict:
    """Restore a ``latest.pt`` into `state` (weights, Adam moments, schedule
    and step); returns {"epoch", "best_full", "best_missing"}."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    _restore(state, blob)
    return {"epoch": int(blob["epoch"]), "best_full": blob["best_full"],
            "best_missing": blob["best_missing"]}
