"""Dual-view eval step: the teacher (gt text) and student (feat4) views.

Reference eval branch: both views under no_grad with dropout off. The two
views run as ONE [2B]-row forward that shares the audio/video input
projections (models/fusion.py ``dual=True``); per-row results equal two
single-view forwards. The training step, with the distillation losses and
Adam, is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _apply_views(model, batch: Dict):
    """Run the teacher and student views as one fused [2B]-row forward;
    returns (vals0, vals1)."""
    ta, tt, tv, tf4 = batch["t_max"]
    vals01, _ = model(batch["audio"], (batch["text"], batch["feat4"]),
                      batch["video"], t_max=(ta, (tt, tf4), tv), dual=True)
    B = batch["audio"].shape[0]
    return vals01[:B], vals01[B:]


def make_eval_step(model):
    """Returns batch -> (preds_full [B], preds_missing [B]) on the batch's
    device, with the model in eval mode under torch.inference_mode."""
    model.eval()

    def eval_step(batch):
        with torch.inference_mode():
            vals0, vals1 = _apply_views(model, batch)
        return vals0.reshape(-1), vals1.reshape(-1)

    return eval_step


def batch_to_device_dict(batch, device) -> Dict:
    """A data.collate.Batch as f32 tensors on `device`; t_max stays host
    ints.

    On a card, arrays already in page-locked memory (BatchIterator
    ``pin_memory``) copy asynchronously; others are staged through a
    page-locked copy first. The caller must keep `batch` alive until the
    step that reads these tensors has finished (run_eval reads its results
    back before the next batch)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if cuda and not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    return {
        "audio": put(batch.audio),
        "text": put(batch.text),
        "video": put(batch.video),
        "feat4": put(batch.feat4),
        "vals": put(batch.vals),
        "t_max": tuple(int(t) for t in batch.t_max),
    }
