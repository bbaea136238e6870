"""Fused frame->utterance attention pooling: the Q = 1 case of the kernel.

Replaces ``sdumc_tpu/ops/pallas/fused_pool.py::fused_attention_pool``
(``_pool_forward``), which runs the cross-attention kernel with the learned
context vector as the single query:

    proj   = tanh(x @ W^T + b)           # [B, T, D], never stored
    s      = scale * (proj . context)    # masked to t < t_max
    pooled = sum_t softmax_t(s)[t] * x[t]

On the card this is ``csrc/fused_cross.cu`` instantiated for one query, with
the context vector shared by every row (no broadcast copy). The launch
counts under ``fused_cross.LAUNCHES[1]`` (``LAUNCHES_BF16[1]`` for a bf16
``x``, whose pooled output is bf16). A tensor on the CPU takes the plain
version. The gradient recomputes the plain version, as for the Q = 7 case
(``fused_cross.Recomputed``); the shared context's gradient is summed over
the rows.
"""

from __future__ import annotations

import torch

from sdumc_tpu_torch.ops.attention_pool import attention_pool
from sdumc_tpu_torch.ops.kernels import fused_cross


def fused_attention_pool_plain(x, weight, bias, context, t_max=None,
                               softmax_scale: float = 0.3):
    """The einsum formulation (ops/attention_pool.py): the CPU path and the
    kernel's oracle. A bf16 x computes in f32 on the widened inputs and
    rounds the output to bf16."""
    if x.dtype == torch.bfloat16:
        return fused_attention_pool_plain(x.float(), weight.float(), bias.float(),
                                          context.float(), t_max, softmax_scale).to(x.dtype)
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
    return fused_cross.Recomputed.apply(_kernel, _plain, context, x, weight, bias,
                                        t_max, softmax_scale)


def _kernel(context, x, weight, bias, t_max, softmax_scale):
    return fused_cross.launch(context.reshape(1, -1), x, weight, bias, t_max,
                              softmax_scale, q_batched=False)[:, 0]


def _plain(context, x, weight, bias, t_max, softmax_scale):
    return fused_attention_pool_plain(x, weight, bias, context, t_max, softmax_scale)
