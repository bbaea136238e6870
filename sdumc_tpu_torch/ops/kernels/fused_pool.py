"""Fused frame->utterance attention pooling: the Q = 1 case of the kernel.

Replaces ``sdumc_tpu/ops/pallas/fused_pool.py::fused_attention_pool``
(``_pool_forward``), which runs the cross-attention kernel with the learned
context vector as the single query:

    proj   = tanh(x @ W^T + b)           # [B, T, D], never stored
    s      = scale * (proj . context)    # masked to t < t_max
    pooled = sum_t softmax_t(s)[t] * x[t]

On the card this is ``csrc/fused_cross.cu`` instantiated for one query, with
the context vector shared by every row (no broadcast copy). The launch
counts under ``fused_cross.LAUNCHES[1]``. A tensor on the CPU takes the plain
version.
"""

from __future__ import annotations

from sdumc_tpu_torch.ops.attention_pool import attention_pool
from sdumc_tpu_torch.ops.kernels import fused_cross


def fused_attention_pool_plain(x, weight, bias, context, t_max=None,
                               softmax_scale: float = 0.3):
    """The einsum formulation (ops/attention_pool.py): the CPU path and the
    kernel's oracle."""
    return attention_pool(x, weight, bias, context,
                          softmax_scale=softmax_scale, t_max=t_max)[0]


def fused_attention_pool(x, weight, bias, context, t_max=None,
                         softmax_scale: float = 0.3):
    """Pooled [B, D]: online-softmax attention pool of x [B, T, D].

    ``weight``/``bias`` are the projection in nn.Linear layout, ``context``
    is [D], ``t_max`` is None, an int, or a per-row [B] tensor.
    """
    if x.device.type == "cpu":
        return fused_attention_pool_plain(x, weight, bias, context, t_max,
                                          softmax_scale)
    out = fused_cross.launch(context.reshape(1, -1), x, weight, bias, t_max,
                             softmax_scale, q_batched=False)
    return out[:, 0]
