"""Fused frame->utterance attention pooling: the Q = 1 case of the kernel.

Replaces ``sdumc_tpu/ops/pallas/fused_pool.py::fused_attention_pool``
(``_pool_forward``), which runs the cross-attention kernel with the learned
context vector as the single query:

    proj   = tanh(x @ W^T + b)           # [B, T, D], never stored
    s      = scale * (proj . context)    # masked to t < t_max
    pooled = sum_t softmax_t(s)[t] * x[t]

It calls the custom op ``sdumc::fused_cross`` (``fused_cross.op``) with
the context as a shared [1, D] query, on either device. On the card that
is ``csrc/fused_cross.cu`` instantiated for one query, with the context
vector shared by every row (no broadcast copy). The launch counts under
``fused_cross.LAUNCHES[1]`` (``LAUNCHES_BF16[1]`` for a bf16 ``x``, whose
pooled output is bf16). On the CPU the op runs the plain version,
``fused_attention_pool_plain``, which lives beside the Q = 7 one in
``fused_cross`` (so that the op owns both) and is re-exported here. The
gradient recomputes the plain version, as for the Q = 7 case
(``fused_cross.Recomputed``); the shared context's gradient is summed over
the rows.
"""

from __future__ import annotations

import functools

from sdumc_tpu_torch.ops.kernels import fused_cross
from sdumc_tpu_torch.ops.kernels.fused_cross import fused_attention_pool_plain  # noqa: F401


def fused_attention_pool(x, weight, bias, context, t_max=None,
                         softmax_scale: float = 0.3):
    """Pooled [B, D]: online-softmax attention pool of x [B, T, D].

    ``weight``/``bias`` are the projection in nn.Linear layout, ``context``
    is [D], ``t_max`` is None, an int, a 0-d or a per-row [B] tensor.
    """
    return fused_cross.call_op(functools.partial(fused_cross.op, q_batched=False), _plain,
                               context, x, weight, bias, t_max, softmax_scale)


def _plain(context, x, weight, bias, t_max, softmax_scale):
    return fused_attention_pool_plain(x, weight, bias, context, t_max, softmax_scale)
