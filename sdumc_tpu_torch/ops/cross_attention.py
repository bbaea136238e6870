"""Multi-query cross attention over a frame sequence, plain PyTorch.

Semantics (reference ``Cross_Attention``):

    q = query @ Wq^T + bq                    # [B, Q, D]
    k = tanh(x @ Wk^T + bk)                  # [B, T, D]
    attn = softmax(scale * (k @ q^T), t)     # [B, T, Q], softmax over time
    out[b, q] = sum_t attn[b, t, q] * x[b, t]

Weights are in torch ``nn.Linear`` layout ([out, in]).
``ops/kernels/fused_cross.py`` is the fused kernel the model runs on the
card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sdumc_tpu_torch.ops.masking import mask_time_scores


def multi_query_cross_attention(query, x, q_weight, q_bias, k_weight, k_bias,
                                *, softmax_scale: float = 0.3, t_max=None):
    """Returns (out [B, Q, D], attn [B, T, Q])."""
    q = F.linear(query, q_weight, q_bias)
    k = torch.tanh(F.linear(x, k_weight, k_bias))
    scores = torch.einsum("btd,bqd->btq", k, q)
    scores = mask_time_scores(softmax_scale * scores, t_max, axis=1)
    attn = torch.softmax(scores, dim=1)
    out = torch.einsum("btd,btq->bqd", x, attn)
    return out, attn
