"""Dual-view self-distillation train and eval steps.

Per batch, a full-modality *teacher* view (audio, gt text, video) and a
text-missing *student* view (audio, feat4, video); the mixed loss distils
the teacher into the student:

  loss = w_full * MSE(v0) + w_miss * MSE(v1)
       + w_tf   * RMSE(text_feat_1,       sg(text_feat_0))
       + w_tqf  * RMSE(text_query_feat_1, sg(text_query_feat_0))
       + w_f    * RMSE(features_1, features_0)      # the teacher is NOT detached
       + w_rnc  * RnC(stack(rnc_0, rnc_1), vals)
       + model_loss_0 + model_loss_1                # a baseline family's own terms

The fusion net runs the two views as ONE [2B]-row forward that shares the
audio/video input projections (models/fusion.py ``dual=True``) whenever
``use_imagination`` is off; per-row results equal two single-view
forwards. Every other model runs two forwards (``_fusable``). The train
step returns metric sums as device tensors, so the loop reads them back
once per epoch.

Data-parallel (a ``DataAxis`` of more than one rank, each holding its rows
of the global batch): the per-row outputs that the loss reads are gathered
into the global batch's (``parallel.multihost.gather_rows``), every rank
computes the global loss (RMSE and RnC are no means over samples, so the
mean of local losses would be another loss), and the gradients are summed
over the ranks after the backward: the step equals the single-process
step on the global batch. A baseline family whose ``aux["model_loss"]``
couples the batch's rows (misa, mmim, mfm, mctn: ``has_model_loss``) runs
its two forwards without it; the per-row tensors it reads
(``aux["loss_rows"]``) are gathered with the outputs, and every rank
computes each view's ``model_loss`` of the global batch from them
(``batch_loss``), the teacher view's first.

Every random draw of a train step (frame dropout, dropout, MFM's prior
samples, MCTN's teacher-forcing mask) comes from one ``torch.Generator``
on the step's device, seeded from (train seed, step): a resumed run draws
the same masks as an uninterrupted one. In a data-parallel run each
rank's masks come from (seed, step, rank), and the batch-wide draws (the
prior samples, the teacher-forcing mask; ``layers.Draws batch_wide``)
from a second generator seeded from (seed, step) on every rank, so all
ranks draw the global batch's values: with dropout off, those of the
single-process step. The masks differ from the JAX package's, whose bit
generator is another.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sdumc_tpu_torch.core.config import LossConfig
from sdumc_tpu_torch.losses import mse_loss, rmse_loss, rnc_loss
from sdumc_tpu_torch.models.layers import use_generator
from sdumc_tpu_torch.parallel.mesh import DataAxis
from sdumc_tpu_torch.parallel.multihost import gather_rows, reduce_gradients
from sdumc_tpu_torch.train.state import TrainState

AUX_KEYS = ("features", "rnc", "text_feat", "text_query_feat")
FEATURES = ("audio", "text", "video", "feat4")


def dequant_features(batch: Dict) -> Dict:
    """An int8 store's batch on the device: codes ``batch[k]`` (int8) times
    the per-clip per-channel scales ``batch[k + "_scale"]`` ([B, D] f32),
    as a bf16 product (both factors rounded to bf16, as the JAX package
    computes it), so the streams are bf16. A batch without scales is
    returned as it is."""
    if not any(k + "_scale" in batch for k in FEATURES):
        return batch
    out = dict(batch)
    for k in FEATURES:
        s = batch.get(k + "_scale")
        if s is not None:
            out[k] = batch[k].to(torch.bfloat16) * s[:, None, :].to(torch.bfloat16)
    return out


def _fusable(model) -> bool:
    """True when the two views can run as one [2B]-row forward: the model
    opts in (``dual_view_fusable``) and nothing conditions its compute on
    the missing flag (``use_imagination`` substitutes only then). The
    baseline families run two forwards: their ``aux["model_loss"]`` reduces
    over the batch, which a row-stacked forward would halve, and their text
    and feat4 views have different ``t_max``."""
    return (getattr(model, "dual_view_fusable", False)
            and not getattr(model.cfg, "use_imagination", False))


def _apply_views(model, batch: Dict, model_loss: bool = True):
    """Run the teacher and student views; returns (vals0, aux0, vals1, aux1).
    ``model_loss=False``: a family with a batch-coupled ``model_loss``
    leaves it out (and its draws) for the caller to compute from
    ``aux["loss_rows"]``."""
    ta, tt, tv, tf4 = batch["t_max"]
    if _fusable(model):
        vals01, aux01 = model(batch["audio"], (batch["text"], batch["feat4"]),
                              batch["video"], t_max=(ta, (tt, tf4), tv), dual=True)
        B = batch["audio"].shape[0]
        return (vals01[:B], {k: aux01[k][:B] for k in AUX_KEYS},
                vals01[B:], {k: aux01[k][B:] for k in AUX_KEYS})
    kw = {} if model_loss else {"model_loss": False}
    vals0, aux0 = model(batch["audio"], batch["text"], batch["video"],
                        t_max=(ta, tt, tv), missing=False, **kw)
    vals1, aux1 = model(batch["audio"], batch["feat4"], batch["video"],
                        t_max=(ta, tf4, tv), missing=True, **kw)
    return vals0, aux0, vals1, aux1


def dual_view_loss(model, batch: Dict, loss_cfg: LossConfig, axis: Optional[DataAxis] = None):
    """(loss, metrics) of one batch dict (audio/text/video/feat4 [B, T, D],
    vals [B], t_max the 4 host ints). Dropout follows the model's mode, and
    in training mode draws from the generator that ``use_generator`` gave
    the model. An int8 store's batch is dequantised first.

    With an `axis` of more than one rank, `batch` holds this rank's rows of
    the global batch (at its ``t_max``) and the loss and its metrics are the
    global batch's; ``sq_err_*`` and ``count`` stay this rank's sums. A
    family with a batch-coupled ``model_loss`` then takes it of the gathered
    rows (``batch_loss``): every parameter was applied to this rank's rows,
    so the summed gradients count each row once."""
    batch = dequant_features(batch)
    vals = batch["vals"]
    split = axis is not None and axis.world > 1
    coupled = split and getattr(model, "has_model_loss", False)
    vals0, aux0, vals1, aux1 = _apply_views(model, batch, model_loss=not coupled)
    local0, local1, local_vals = vals0, vals1, vals
    if split:
        n = len(AUX_KEYS)
        parts = [[aux[k] for k in AUX_KEYS] + list(aux["loss_rows"] if coupled else ())
                 for aux in (aux0, aux1)]
        rows = gather_rows(axis, vals0, vals1, vals, *parts[0], *parts[1])
        vals0, vals1, vals = rows[:3]
        view0, view1 = rows[3:3 + len(parts[0])], rows[3 + len(parts[0]):]
        aux0, aux1 = dict(zip(AUX_KEYS, view0)), dict(zip(AUX_KEYS, view1))
        if coupled:     # the teacher view's draws first, as one process takes them
            aux0["model_loss"] = model.batch_loss(view0[n:])
            aux1["model_loss"] = model.batch_loss(view1[n:])

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
        + aux0.get("model_loss", 0.0)
        + aux1.get("model_loss", 0.0)
    )
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "mse_full": mse0.detach(),
            "mse_missing": mse1.detach(),
            "rnc": rnc.detach(),
            # epoch MSE feed: sums of squared error and the count
            "sq_err_full": torch.sum((local0.reshape(-1) - local_vals) ** 2),
            "sq_err_missing": torch.sum((local1.reshape(-1) - local_vals) ** 2),
            "count": torch.full((), float(local_vals.shape[0]), device=vals.device),
        }
    return loss, metrics


def step_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The 64-bit seed of one step's generator, a hash of (seed, step), or
    of (seed, step, rank) for a rank of a data-parallel run, whose rows
    differ from the other ranks' and so need masks of their own."""
    # rank + 1: SeedSequence hashes a trailing 0 as nothing, (seed, step, 0)
    # as (seed, step)
    hi, lo = np.random.SeedSequence(
        [seed, step] if rank is None else [seed, step, rank + 1]).generate_state(2)
    return (int(hi) << 32) | int(lo)


def make_train_step(state: TrainState, loss_cfg: LossConfig, seed: int,
                    axis: Optional[DataAxis] = None):
    """Returns batch -> metrics (device tensors): one dual-view step, its
    backward, the Adam update and the schedule step, with the model in
    training mode and the random stream of (seed, state.step). With an
    `axis` of more than one rank, the batch is this rank's rows and the step
    is the global batch's: the global loss, the gradients summed over the
    ranks before the update, the stream of (seed, state.step, rank), and
    the batch-wide draws from a second generator of (seed, state.step),
    alike on every rank (one process has no second generator: two streams
    of one seed would repeat each other's values)."""
    model = state.model
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    rank = axis.rank if axis is not None and axis.world > 1 else None
    shared = torch.Generator(device=device) if rank is not None else None
    use_generator(model, generator, shared)

    def train_step(batch):
        model.train()
        generator.manual_seed(step_seed(seed, state.step, rank))
        if shared is not None:
            shared.manual_seed(step_seed(seed, state.step))
        loss, metrics = dual_view_loss(model, batch, loss_cfg, axis)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if rank is not None:
            reduce_gradients(model.parameters(), axis)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step


def dual_view_eval(model, audio, text, video, feat4, t_max):
    """(preds_full [B], preds_missing [B]) of the four streams [B, T_m, D_m]
    and their four ``t_max`` (host ints, or integer tensors: a traced
    program takes tensors, so the lengths stay inputs). It sets no mode
    and no grad mode: ``make_eval_step`` runs it under
    ``torch.inference_mode``, ``serve.export`` traces it under
    ``torch.no_grad`` in eval mode."""
    vals0, _, vals1, _ = _apply_views(model, {"audio": audio, "text": text, "video": video,
                                              "feat4": feat4, "t_max": tuple(t_max)})
    return vals0.reshape(-1), vals1.reshape(-1)


def make_eval_step(model):
    """Returns batch -> (preds_full [B], preds_missing [B]) on the batch's
    device. Every call puts the model in eval mode (dropout off) and runs
    under torch.inference_mode, so its outputs never enter a graph."""

    def eval_step(batch):
        model.eval()
        with torch.inference_mode():
            batch = dequant_features(batch)
            return dual_view_eval(model, *(batch[k] for k in FEATURES), batch["t_max"])

    return eval_step


def batch_to_device_dict(batch, device, feature_dtype: str = "float32") -> Dict:
    """A data.collate.Batch as tensors on `device`; t_max stays host ints.

    The features keep the batch's dtype: f32, bf16 (a bf16 store's uint16
    bit patterns, seen as bf16) or int8 codes, which ship as they are with
    their ``<key>_scale`` [B, D] f32 scales (``dequant_features`` widens
    them on the device). ``feature_dtype="bfloat16"`` casts an f32 batch to
    bf16 on `device` after the copy, rounding to nearest even.

    On a card the copies are asynchronous and read only page-locked memory
    that torch's host allocator owns: the batch's own page-locked tensors
    (BatchIterator ``pin_memory``) where they still hold its arrays, else a
    page-locked copy. The allocator keeps each such buffer from reuse until
    its copy has completed, so `batch` may be dropped at once."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    pinned = dict(zip(FEATURES, batch.pinned))
    scales = batch.scales or {}

    def put(a: np.ndarray, owner=None) -> torch.Tensor:
        t = owner
        if t is None or t.data_ptr() != a.ctypes.data:   # no buffer, or an array replaced
            if a.dtype == np.uint16:
                t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
            else:
                keep = a.dtype == np.int8
                t = torch.from_numpy(np.ascontiguousarray(a, dtype=None if keep else np.float32))
            if cuda:
                t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    d = {}
    for name in FEATURES:
        t = put(getattr(batch, name), pinned.get(name))
        if feature_dtype == "bfloat16" and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        d[name] = t
    for name, s in scales.items():
        d[name + "_scale"] = put(s)
    d["vals"] = put(batch.vals)
    d["t_max"] = tuple(int(t) for t in batch.t_max)
    return d
