"""Frame->utterance attention pooling (the FRA2UTT op), plain PyTorch.

Semantics (reference ``FRA2UTT_new``):

    scores[b, t] = tanh(x[b, t] @ W^T + bias) . context
    attn = softmax(scale * scores, axis=t)            # over rows t < t_max
    out[b] = sum_t attn[b, t] * x[b, t]

Weights are in torch ``nn.Linear`` layout ([out, in]). This is the plain
formulation; ``ops/kernels/fused_pool.py`` is the fused kernel the model
runs on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sdumc_tpu_torch.ops.masking import mask_time_scores


def attention_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   context: torch.Tensor, *, softmax_scale: float = 0.3,
                   t_max=None):
    """Attention-pool frames into one utterance vector.

    Args:
      x: [B, T, D] frame features (zero-padded beyond sequence length).
      weight, bias: [D, D] / [D] projection (nn.Linear layout).
      context: [D] learned context vector.
      softmax_scale: scale applied to the scores before the softmax.
      t_max: None, an int, or a per-row [B] tensor (see ops/masking.py).

    Returns:
      (pooled [B, D], attn [B, T, 1]).
    """
    proj = torch.tanh(F.linear(x, weight, bias))
    scores = torch.einsum("btd,d->bt", proj, context)
    scores = mask_time_scores(softmax_scale * scores, t_max, axis=1)
    attn = torch.softmax(scores, dim=1)
    pooled = torch.einsum("btd,bt->bd", x, attn)
    return pooled, attn[..., None]
