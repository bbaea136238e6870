"""Sequence-parallel WavLM: one clip's frames split over the ranks of an axis
(the JAX package's ``parallel/wavlm_sp.py``).

Every rank runs the prologue whole: the conv feature encoder and the
kernel-128 positional conv both need the full time axis. The frames are then
padded up to a multiple of the axis size with masked frames, each rank runs
the transformer stack (``WavLMModel.encoder_stack``) on its slice with
``attention_impl="ring"`` (per-frame layers are local; attention passes K
and V round the ring, ``parallel/ring_attention.py``), and the slices are
gathered on every rank and cut back to T. JAX gets the same from
``shard_map`` over a mesh axis; here each rank is a process
(``parallel.initialize_from_env``, ``make_model_axis(device, n)``).

Under autograd the ring and the gather carry the gradient
(``ring_attention.RingGatedAttention``, ``GatherTime``): each rank's
gradient of a replicated leaf (every parameter, the wave) is the share of
its own frames, and ``parallel.reduce_gradients`` sums them over the axis
into the single-process gradient, which JAX's ``shard_map`` gives its
``P()`` params.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from sdumc_tpu_torch.parallel.ring_attention import gather_time


@contextlib.contextmanager
def ring_over(model, axis):
    """Within it, every attention of `model` runs ``attention_impl="ring"``
    over `axis` (what JAX's ``dataclasses.replace(cfg, attention_impl="ring",
    ring_axis=axis)`` gives); the model is as it was afterwards."""
    attns = [layer.attention for layer in model.encoder.layers]
    saved = [(a.cfg, a.ring_axis) for a in attns]
    for a in attns:
        a.cfg, a.ring_axis = dataclasses.replace(a.cfg, attention_impl="ring"), axis
    try:
        yield model
    finally:
        for a, (cfg, ring_axis) in zip(attns, saved):
            a.cfg, a.ring_axis = cfg, ring_axis


def wavlm_forward_sp(model, wav: torch.Tensor, axis, pad_mask: Optional[torch.Tensor] = None,
                     output_hidden_states: bool = False) -> dict:
    """[B, S] waveform -> ``WavLMModel``'s output dict, the transformer
    stack's frames split over `axis` (every rank of it calls this with the
    same inputs and gets the whole result). ``pad_mask`` is the frame-level
    [B, T] mask (True = real), as in ``WavLMModel``.

    Differentiable: every rank takes the same loss of the same result, calls
    ``backward()`` (the ring's backward rotates, so all must), then
    ``parallel.reduce_gradients([*model.parameters(), wav], axis)`` on the
    same replicated leaves (the wave when it requires grad). Each rank's
    gradient of such a leaf is the share of its own frames (the encoder's
    parameters see only the rank's slice; the prologue runs whole but feeds
    only it), so the sum is the single-process gradient, on every rank. The
    padded frames are masked keys and are cut off as queries, so their
    gradient is exactly zero."""
    x = model.prologue(wav, pad_mask)
    B, T, _ = x.shape
    n = axis.world
    padded = -(-T // n) * n
    mask = (torch.ones(B, T, dtype=torch.bool, device=x.device) if pad_mask is None
            else pad_mask.to(torch.bool))
    if padded != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, padded - T))
        mask = torch.nn.functional.pad(mask, (0, padded - T), value=False)
    t_local = padded // n
    part = slice(axis.rank * t_local, (axis.rank + 1) * t_local)
    with ring_over(model, axis):
        last, hidden = model.encoder_stack(x[:, part].contiguous(), mask[:, part].contiguous(),
                                           output_hidden_states)
    if not output_hidden_states:
        return {"last_hidden_state": gather_time(last, axis, dim=1)[:, :T],
                "hidden_states": None}
    # the last tap is the last hidden state (post-final-LN for pre-LN models)
    taps = gather_time(torch.stack(hidden), axis, dim=2)[:, :, :T]
    return {"last_hidden_state": taps[-1], "hidden_states": tuple(taps.unbind(0))}

