"""Dual-view self-distillation train and eval steps.

Per batch, a full-modality *teacher* view (audio, gt text, video) and a
text-missing *student* view (audio, feat4, video); the mixed loss distils
the teacher into the student:

  loss = w_full * MSE(v0) + w_miss * MSE(v1)
       + w_tf   * RMSE(text_feat_1,       sg(text_feat_0))
       + w_tqf  * RMSE(text_query_feat_1, sg(text_query_feat_0))
       + w_f    * RMSE(features_1, features_0)      # the teacher is NOT detached
       + w_rnc  * RnC(stack(rnc_0, rnc_1), vals)

The two views run as ONE [2B]-row forward that shares the audio/video input
projections (models/fusion.py ``dual=True``) whenever ``use_imagination`` is
off; per-row results equal two single-view forwards. The train step returns
metric sums as device tensors, so the loop reads them back once per epoch.

Every random draw of a train step (frame dropout and dropout) comes from
one ``torch.Generator`` on the step's device, seeded from (train seed,
step): a resumed run draws the same masks as an uninterrupted one. The
masks differ from the JAX package's, whose bit generator is another.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sdumc_tpu_torch.core.config import LossConfig
from sdumc_tpu_torch.losses import mse_loss, rmse_loss, rnc_loss
from sdumc_tpu_torch.models.layers import use_generator
from sdumc_tpu_torch.train.state import TrainState

AUX_KEYS = ("features", "rnc", "text_feat", "text_query_feat")


def _apply_views(model, batch: Dict):
    """Run the teacher and student views; returns (vals0, aux0, vals1, aux1).
    One fused [2B]-row forward unless the imagination substitution makes the
    views differ in their compute."""
    ta, tt, tv, tf4 = batch["t_max"]
    if not model.cfg.use_imagination:
        vals01, aux01 = model(batch["audio"], (batch["text"], batch["feat4"]),
                              batch["video"], t_max=(ta, (tt, tf4), tv), dual=True)
        B = batch["audio"].shape[0]
        return (vals01[:B], {k: aux01[k][:B] for k in AUX_KEYS},
                vals01[B:], {k: aux01[k][B:] for k in AUX_KEYS})
    vals0, aux0 = model(batch["audio"], batch["text"], batch["video"],
                        t_max=(ta, tt, tv), missing=False)
    vals1, aux1 = model(batch["audio"], batch["feat4"], batch["video"],
                        t_max=(ta, tf4, tv), missing=True)
    return vals0, aux0, vals1, aux1


def dual_view_loss(model, batch: Dict, loss_cfg: LossConfig):
    """(loss, metrics) of one batch dict (audio/text/video/feat4 [B, T, D],
    vals [B], t_max the 4 host ints). Dropout follows the model's mode, and
    in training mode draws from the generator that ``use_generator`` gave
    the model."""
    vals = batch["vals"]
    vals0, aux0, vals1, aux1 = _apply_views(model, batch)

    mse0 = mse_loss(vals0, vals)
    mse1 = mse_loss(vals1, vals)
    rnc = rnc_loss(torch.stack([aux0["rnc"], aux1["rnc"]], dim=1), vals[:, None],
                   temperature=loss_cfg.rnc_temperature)
    loss = (
        loss_cfg.full_mse_w * mse0
        + loss_cfg.missing_mse_w * mse1
        + loss_cfg.text_feat_w * rmse_loss(aux1["text_feat"], aux0["text_feat"].detach())
        + loss_cfg.text_query_feat_w
        * rmse_loss(aux1["text_query_feat"], aux0["text_query_feat"].detach())
        + loss_cfg.features_w * rmse_loss(aux1["features"], aux0["features"])
        + loss_cfg.rnc_w * rnc
    )
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "mse_full": mse0.detach(),
            "mse_missing": mse1.detach(),
            "rnc": rnc.detach(),
            # epoch MSE feed: sums of squared error and the count
            "sq_err_full": torch.sum((vals0.reshape(-1) - vals) ** 2),
            "sq_err_missing": torch.sum((vals1.reshape(-1) - vals) ** 2),
            "count": torch.full((), float(vals.shape[0]), device=vals.device),
        }
    return loss, metrics


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of one step's generator, a hash of (seed, step)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return (int(hi) << 32) | int(lo)


def make_train_step(state: TrainState, loss_cfg: LossConfig, seed: int):
    """Returns batch -> metrics (device tensors): one dual-view step, its
    backward, the Adam update and the schedule step, with the model in
    training mode and the random stream of (seed, state.step)."""
    model = state.model
    generator = torch.Generator(device=next(model.parameters()).device)
    use_generator(model, generator)

    def train_step(batch):
        model.train()
        generator.manual_seed(step_seed(seed, state.step))
        loss, metrics = dual_view_loss(model, batch, loss_cfg)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step


def make_eval_step(model):
    """Returns batch -> (preds_full [B], preds_missing [B]) on the batch's
    device. Every call puts the model in eval mode (dropout off) and runs
    under torch.inference_mode, so its outputs never enter a graph."""

    def eval_step(batch):
        model.eval()
        with torch.inference_mode():
            vals0, _, vals1, _ = _apply_views(model, batch)
        return vals0.reshape(-1), vals1.reshape(-1)

    return eval_step


def batch_to_device_dict(batch, device) -> Dict:
    """A data.collate.Batch as f32 tensors on `device`; t_max stays host
    ints.

    On a card the copies are asynchronous and read only page-locked memory
    that torch's host allocator owns: the batch's own page-locked tensors
    (BatchIterator ``pin_memory``) where they still hold its arrays, else a
    page-locked copy. The allocator keeps each such buffer from reuse until
    its copy has completed, so `batch` may be dropped at once."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    pinned = dict(zip(("audio", "text", "video", "feat4"), batch.pinned))

    def put(name: str) -> torch.Tensor:
        a = getattr(batch, name)
        t = pinned.get(name)
        if t is None or t.data_ptr() != a.ctypes.data:   # no buffer, or an array replaced
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            if cuda:
                t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    return {
        **{name: put(name) for name in ("audio", "text", "video", "feat4", "vals")},
        "t_max": tuple(int(t) for t in batch.t_max),
    }
