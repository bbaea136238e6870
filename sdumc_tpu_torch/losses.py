"""Training losses of the dual-view step: MSE, RMSE and Rank-N-Contrast.

The port's copy of the main-path subset of ``sdumc_tpu/losses.py``, with
the same numerics: the RnC loss is the vectorised masked log-sum over an
``[n, n, n]`` negative mask (not the reference's per-rank loop), with a
zero-distance pair given gradient 0, the row max held out of the gradient,
and the reference's ``-1e-4`` slack on the negative mask.
"""

from __future__ import annotations

import torch


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 1:
        return x.reshape(-1, 1)
    if x.ndim == 3:
        return x.reshape(x.shape[0], -1)
    return x


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the batch size (the reference MSELoss)."""
    pred, target = _as_2d(pred), _as_2d(target)
    return torch.sum((pred - target) ** 2) / pred.shape[0]


def rmse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sqrt(mean((p - t)^2)) over all elements (the reference RMSELoss)."""
    pred, target = _as_2d(pred), _as_2d(target)
    return torch.sqrt(torch.mean((pred - target) ** 2))


def rnc_loss(features: torch.Tensor, labels: torch.Tensor,
             temperature: float = 2.0) -> torch.Tensor:
    """Rank-N-Contrast regression-contrastive loss.

    Args:
      features: [bs, 2, feat_dim], two views per sample.
      labels: [bs, label_dim] (label_dim usually 1).
    """
    feats = torch.cat([features[:, 0], features[:, 1]], dim=0)        # [2bs, D]
    labels = labels.repeat(2, 1)                                       # [2bs, L]

    label_diffs = torch.sum(torch.abs(labels[:, None, :] - labels[None, :, :]), dim=-1)
    # safe pairwise L2: the plain norm's gradient is NaN at zero distance
    # (the diagonal, and duplicate features); such pairs get gradient 0
    sq = torch.sum((feats[:, None, :] - feats[None, :, :]) ** 2, dim=-1)
    positive = sq > 0.0
    sim = torch.where(positive, -torch.sqrt(torch.where(positive, sq, 1.0)), 0.0)
    logits = sim / temperature
    logits = logits - torch.max(logits, dim=1, keepdim=True).values.detach()

    n = logits.shape[0]
    offdiag = 1.0 - torch.eye(n, dtype=logits.dtype, device=logits.device)
    exp_logits = torch.exp(logits) * offdiag                           # e[i, i] = 0
    # neg_mask[i, k, j] = label_diffs[i, j] >= label_diffs[i, k] - 1e-4
    neg_mask = (label_diffs[:, None, :] >= label_diffs[:, :, None] - 0.0001).to(logits.dtype)
    # denom[i, k] = sum_{j != i} neg_mask[i, k, j] * exp_logits[i, j]
    denom = torch.einsum("ikj,ij->ik", neg_mask, exp_logits)
    pos_log_probs = (logits - torch.log(denom)) * offdiag
    return -torch.sum(pos_log_probs) / (n * (n - 1))
