"""CMU-MOSEI evaluation metrics, plain numpy on the host.

The standard CMU-MOSEI definition (MAE / Pearson corr / Acc-7 / Acc-2 /
weighted F1 on non-zero labels); the dict carries the ``mae`` and ``f1``
keys that model selection reads. The cross-validation helpers below
combine the folds' eval results into one selection score and average the
folds' test predictions.
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


def overall_metric(emo_fscore: float, val_mse: float) -> float:
    """The combined selection score: emotion F1 less a quarter of the
    valence MSE."""
    return emo_fscore - val_mse * 0.25


def calculate_binary_results(val_preds, val_labels):
    """Binary accuracy and weighted F1 over the non-zero labels (negative
    vs positive), with the flattened predictions and labels."""
    val_preds = np.asarray(val_preds).reshape(-1)
    val_labels = np.asarray(val_labels).reshape(-1)
    non_zeros = val_labels != 0
    bin_true = val_labels[non_zeros] > 0
    bin_pred = val_preds[non_zeros] > 0
    acc = float(np.mean(bin_true == bin_pred)) if np.any(non_zeros) else 0.0
    f1 = _f1_weighted(bin_true, bin_pred) if np.any(non_zeros) else 0.0
    return {
        "valpreds": val_preds,
        "vallabels": val_labels,
        "emoacc": acc,
        "emofscore": f1,
    }


def gain_metric_from_results(eval_results: dict, metric_name: str = "emoval") -> float:
    """The scalar model-selection metric: 'emoval' = fscore - 0.25 mse,
    'emo' = fscore, 'val' = -mse, 'loss' = -loss."""
    if metric_name == "emoval":
        return overall_metric(eval_results["emofscore"], eval_results["valmse"])
    if metric_name == "emo":
        return eval_results["emofscore"]
    if metric_name == "val":
        return -eval_results["valmse"]
    if metric_name == "loss":
        return -eval_results["loss"]
    raise KeyError(metric_name)


def gain_cv_results(folder_save) -> str:
    """The mean of each fold's eval metrics as ``f1:X_acc:Y_val:Z`` (only
    the keys the fold dicts hold)."""
    outputs = []
    for key, tag in (("eval_emofscore", "f1"), ("eval_emoacc", "acc"),
                     ("eval_valmse", "val")):
        if key in folder_save[0]:
            outputs.append(
                f"{tag}:{float(np.mean([f[key] for f in folder_save])):.4f}")
    return "_".join(outputs)


def average_folds_for_vals(folder_save, testname: str):
    """(labels, valence predictions averaged over the folds); every test
    loader iterates unshuffled, so the rows align. ([], []) when the folds
    hold none for `testname`."""
    key_l, key_p = f"{testname}_vallabels", f"{testname}_valpreds"
    if key_l not in folder_save[0]:
        return [], []
    labels = folder_save[0][key_l]
    preds = np.mean([np.asarray(f[key_p]) for f in folder_save], axis=0)
    return labels, preds


def average_folds_for_emos(folder_save, testname: str):
    """(labels, emotion probabilities averaged over the folds, as a list);
    ([], []) when the folds hold none for `testname`."""
    key_l, key_p = f"{testname}_emolabels", f"{testname}_emoprobs"
    if key_l not in folder_save[0]:
        return [], []
    labels = folder_save[0][key_l]
    probs = np.mean([np.asarray(f[key_p]) for f in folder_save], axis=0)
    return labels, list(probs)
