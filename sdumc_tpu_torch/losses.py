"""Training losses: the dual-view step's MSE, RMSE and Rank-N-Contrast, and
the rest of the reference's loss zoo (CE, symmetric KL, cosine, MI, the
MOSEI emotion loss, SupCon).

The port's copy of ``sdumc_tpu/losses.py``, with the same numerics and
reductions: the RnC loss is the vectorised masked log-sum over an
``[n, n, n]`` negative mask (not the reference's per-rank loop), with a
zero-distance pair given gradient 0, the row max held out of the gradient,
and the reference's ``-1e-4`` slack on the negative mask; SupCon holds its
row max out of the gradient too.
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


def ce_loss(pred_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """log_softmax and NLL summed over the batch size (the reference CELoss)."""
    logp = torch.log_softmax(pred_logits, dim=1)
    picked = torch.gather(logp, 1, target.long()[:, None])
    return -torch.sum(picked) / pred_logits.shape[0]


def kl_loss(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Symmetric batchmean KL of two logit batches (the reference KLLoss)."""

    def _kl(a_logits, b_logits):
        log_a = torch.log_softmax(a_logits, dim=-1)
        log_b = torch.log_softmax(b_logits, dim=-1)
        return torch.sum(torch.exp(log_b) * (log_b - log_a)) / a_logits.shape[0]

    return (_kl(p, q) + _kl(q, p)) / 2.0


def cosine_similarity_loss(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """mean(1 - cos(u, v)) over the batch."""
    norms = torch.linalg.vector_norm(u, dim=1) * torch.linalg.vector_norm(v, dim=1)
    cos = torch.sum(u * v, dim=1) / torch.clamp(norms, min=eps)
    return torch.mean(1.0 - cos)


def cosine_similarity_loss_seq(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The cosine loss of each slot of [B, S, D], summed over the slots."""
    if u.ndim == 2:
        return cosine_similarity_loss(u, v)
    norms = torch.linalg.vector_norm(u, dim=2) * torch.linalg.vector_norm(v, dim=2)
    cos = torch.sum(u * v, dim=2) / torch.clamp(norms, min=1e-8)
    return torch.sum(torch.mean(1.0 - cos, dim=0))


def mi_loss(feats) -> torch.Tensor:
    """The mean symmetric KL over every ordered pair of a feature list."""
    pairs = [(a, b) for i, a in enumerate(feats) for j, b in enumerate(feats) if i != j]
    return sum(kl_loss(a, b) for a, b in pairs) / len(pairs)


def mosei_emo_loss(pred: torch.Tensor, target: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Entropy-weighted per-sample MSE with a synthetic neutral channel
    ``3 - |vals|`` (the reference MoseiEmoLoss)."""
    vals = vals.reshape(-1, 1)
    target = torch.cat([target, 3.0 - torch.abs(vals)], dim=1)
    mse_per = torch.mean((pred - target) ** 2, dim=1)
    probs = torch.softmax(target, dim=1)
    entropy = -torch.sum(probs * torch.log(probs + 1e-12), dim=1)
    weights = 1.0 / (entropy + 1.0)
    return torch.sum(weights * mse_per) / torch.sum(weights)


def supcon_loss(features: torch.Tensor, labels: torch.Tensor | None = None,
                mask: torch.Tensor | None = None, temperature: float = 0.07,
                base_temperature: float = 0.07, contrast_mode: str = "all") -> torch.Tensor:
    """Supervised contrastive loss (the reference SupConLoss): features
    [bsz, n_views, ...]; positives from ``labels`` or ``mask``, else each
    sample's own views; anchors are the first view (``contrast_mode``
    "one") or every view ("all")."""
    if features.ndim < 3:
        raise ValueError("features must be [bsz, n_views, ...]")
    if features.ndim > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    bsz, n_views = features.shape[0], features.shape[1]
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(bsz, dtype=torch.float32, device=features.device)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = mask.float()

    contrast_feature = torch.cat(torch.unbind(features, dim=1), dim=0)
    if contrast_mode == "one":
        anchor_feature, anchor_count = features[:, 0], 1
    else:
        anchor_feature, anchor_count = contrast_feature, n_views

    logits = anchor_feature @ contrast_feature.T / temperature
    logits = logits - torch.max(logits, dim=1, keepdim=True).values.detach()

    mask = mask.repeat(anchor_count, n_views)
    logits_mask = 1.0 - torch.eye(*mask.shape, dtype=mask.dtype, device=mask.device)
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True))
    mask_pos = torch.sum(mask, dim=1)
    mask_pos = torch.where(mask_pos < 1e-6, 1.0, mask_pos)
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / mask_pos
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return torch.mean(loss.reshape(anchor_count, bsz))


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
