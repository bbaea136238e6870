"""Static-shape emulation of the reference's dynamic batch-max padding.

The reference pads every batch to its per-batch max length per modality and
runs the time softmax over *all* rows, pad rows included: pad rows carry
zero features, which after the input projection contribute the projection
bias. Those pad rows therefore influence the pooled output, and reproducing
the published numbers requires keeping them.

Batches here are zero-padded to a length bucket and carry ``t_max``, the
dynamic batch max. Rows ``t < t_max`` take part in the softmax exactly as in
the reference (real rows plus bias-only pad rows); rows ``t >= t_max`` are
masked out entirely, so any bucket gives the same result.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mask_time_scores(scores: torch.Tensor, t_max, axis: int = 1) -> torch.Tensor:
    """Set scores at time positions >= t_max to NEG_INF along `axis`.

    `t_max` may be None (no masking), a python int, a 0-d tensor, or a
    per-row [B] tensor (batch axis 0): the fused dual-view forward stacks
    the teacher and student views along batch, and their text streams have
    different dynamic lengths.
    """
    if t_max is None:
        return scores
    length = scores.shape[axis]
    positions = torch.arange(length, device=scores.device)
    shape = [1] * scores.ndim
    shape[axis] = length
    # a host int is compared as it is: a tensor made of it on a card would
    # be a copy that waits for the stream
    t = t_max if isinstance(t_max, torch.Tensor) else int(t_max)
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        mask = (positions < t).reshape(shape)
    else:
        if t.ndim != 1 or axis == 0:
            raise ValueError(f"per-row t_max needs shape [B] and a time axis "
                             f"other than 0, got {tuple(t.shape)}, axis={axis}")
        shape[0] = t.shape[0]
        mask = (positions[None, :] < t[:, None]).reshape(shape)
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))
