"""CMU-MOSEI evaluation metrics, plain numpy on the host.

The standard CMU-MOSEI definition (MAE / Pearson corr / Acc-7 / Acc-2 /
weighted F1 on non-zero labels); the dict carries the ``mae`` and ``f1``
keys that model selection reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _f1_weighted(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Weighted binary F1 without a sklearn dependency."""
    f1s, weights = [], []
    for cls in (False, True):
        tp = float(np.sum((y_pred == cls) & (y_true == cls)))
        fp = float(np.sum((y_pred == cls) & (y_true != cls)))
        fn = float(np.sum((y_pred != cls) & (y_true == cls)))
        support = float(np.sum(y_true == cls))
        precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
        f1s.append(f1)
        weights.append(support)
    total = sum(weights)
    if total == 0:
        return 0.0
    return float(sum(f * w for f, w in zip(f1s, weights)) / total)


def multiclass_acc(preds: np.ndarray, truths: np.ndarray) -> float:
    return float(np.sum(np.round(preds) == np.round(truths)) / max(len(truths), 1))


def eval_mosei_metric(preds, labels, names=None) -> Dict[str, float]:
    """Standard CMU-MOSEI valence regression metric suite.

    Args:
      preds: ``[N]`` or ``[N, 1]`` predicted valence.
      labels: ``[N]`` or ``[N, 1]`` ground-truth valence in ``[-3, 3]``.
      names: optional clip names (accepted for the reference call
        signature; unused).

    Returns a dict with ``mse, mae, corr, acc7, acc5, acc2, f1`` plus the
    has-zero variants ``acc2_has0, f1_has0``.
    """
    preds = np.asarray(preds, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    if preds.shape != labels.shape:
        raise ValueError(f"preds {preds.shape} and labels {labels.shape} differ")

    mse = float(np.mean((preds - labels) ** 2))
    mae = float(np.mean(np.abs(preds - labels)))

    if len(preds) > 1 and np.std(preds) > 0 and np.std(labels) > 0:
        corr = float(np.corrcoef(preds, labels)[0, 1])
    else:
        corr = 0.0

    acc7 = multiclass_acc(np.clip(preds, -3.0, 3.0), np.clip(labels, -3.0, 3.0))
    acc5 = multiclass_acc(np.clip(preds, -2.0, 2.0), np.clip(labels, -2.0, 2.0))

    # Acc-2 / F1 over non-zero labels (negative vs positive)
    non_zeros = labels != 0
    if np.any(non_zeros):
        bin_true = labels[non_zeros] > 0
        bin_pred = preds[non_zeros] > 0
        acc2 = float(np.mean(bin_true == bin_pred))
        f1 = _f1_weighted(bin_true, bin_pred)
    else:
        acc2, f1 = 0.0, 0.0

    # has-zero variant: negative vs non-negative over all samples
    bin_true0 = labels >= 0
    bin_pred0 = preds >= 0
    acc2_has0 = float(np.mean(bin_true0 == bin_pred0))
    f1_has0 = _f1_weighted(bin_true0, bin_pred0)

    return {
        "mse": mse,
        "mae": mae,
        "corr": corr,
        "acc7": acc7,
        "acc5": acc5,
        "acc2": acc2,
        "f1": f1,
        "acc2_has0": acc2_has0,
        "f1_has0": f1_has0,
    }
