"""Eval pass over one split: both views, predictions and metrics.

The single-process eval half of ``sdumc_tpu/train/loop.py``; the epoch
loop, checkpoints and the multi-process gather are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdumc_tpu_torch.core.config import ExperimentConfig
from sdumc_tpu_torch.core.metrics import eval_mosei_metric
from sdumc_tpu_torch.data.pipeline import BatchIterator, MoseiDataset
from sdumc_tpu_torch.train.step import batch_to_device_dict


def _pad_partial(batch, bs):
    """Repeat-pad a partial eval batch to the batch size (rows are
    independent in eval; preds are sliced back on the host)."""
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
    )
    return padded, n


def run_eval(eval_step, dataset: MoseiDataset, cfg: ExperimentConfig,
             device="cpu"):
    """Full eval pass -> dict with preds, labels and metrics for both views."""
    device = torch.device(device)
    it = BatchIterator(dataset, cfg.data.batch_size, shuffle=False,
                       buckets=cfg.data.length_buckets,
                       pin_memory=device.type == "cuda")
    preds_full, preds_missing, labels, names = [], [], [], []
    for batch in it:
        padded, n = _pad_partial(batch, cfg.data.batch_size)
        d = batch_to_device_dict(padded, device)
        v0, v1 = eval_step(d)
        # reading back waits for this batch, so its host buffers are free
        preds_full.append(v0[:n].cpu().numpy())
        preds_missing.append(v1[:n].cpu().numpy())
        labels.append(batch.vals)
        names.extend(batch.names)
    preds_full = np.concatenate(preds_full) if preds_full else np.zeros((0,))
    preds_missing = np.concatenate(preds_missing) if preds_missing else np.zeros((0,))
    labels = np.concatenate(labels) if labels else np.zeros((0,))
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
