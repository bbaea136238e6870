"""Ring attention: WavLM's gated-bias attention with the time axis split over
the ranks of an axis (the JAX package's ``parallel/ring_attention.py``).

Each of P ranks holds T_local = T / P consecutive frames of q, k and v. In P
block steps it attends its queries to one block of keys at a time, the
block's k, v and key mask then passed one rank round the ring
(``ModelAxis.ring_shift``): P - 1 rotations (JAX's scan also rotates after
the last step and drops the result). Block (queries of rank i, keys of rank
j) sees relative positions offset by (j - i) * T_local, so each step's bias is
the diagonal of JAX's ``bucket_from_rel`` on the global offset
(``flash_wavlm.bias_diag_for(..., offset=...)``): distances between blocks
go past ``max_distance`` and land in the far buckets as they do over the
whole clip. The P diagonals depend only on the shared [num_buckets, H]
embedding, so the encoder builds them once per forward and carries them
across its layers (``ring_bias_diags``), where JAX carries the embedding and
rebuilds each step's bias.

A step is the WavLM kernel's f32 block instance (``flash_wavlm.flash_block``:
the kernel on the card, its plain version on the CPU), which also returns
each row's log-sum-exp; the blocks merge in f32 by those statistics. As in
JAX (ring_attention.py:60-61, 69-70), everything is computed in f32
whatever the model's dtype and the output is rounded to q's dtype once, so
at bf16 the ring runs the f32 instance on widened q, k, v and not the bf16
kernel's semantics.

Masked keys: a block whose keys a row masks entirely has lse = -1e30 and
weighs zero beside a block with a valid key. A row with no valid key in any
block gets the mean of v over every key, as JAX's NEG arithmetic gives it
(each block's mean, the blocks weighed alike).

Forward only: JAX takes the ring's gradient by autodiff; here the received
blocks carry no graph, so a call under autograd with an input that requires
grad raises (the gradient is on the ROADMAP).
"""

from __future__ import annotations

import torch

from sdumc_tpu_torch.ops.kernels.flash_wavlm import bias_diag_for, flash_block


def ring_bias_diags(rel_embed: torch.Tensor, t_local: int, axis, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """[P, H, 2 T_local - 1] f32 on rel_embed's device: entry ``src`` is the
    diagonal bias of this rank's queries against rank ``src``'s keys, offset
    (src - rank) * T_local."""
    rel = rel_embed.float()
    return torch.stack([bias_diag_for(rel, t_local, num_buckets, max_distance,
                                      offset=(src - axis.rank) * t_local)
                        for src in range(axis.world)])


def ring_gated_attention(q, k, v, gate, kvalid, rel_embed, *, axis, num_buckets: int,
                         max_distance: int, bias_diags=None):
    """This rank's shard of the attention (every rank of ``axis`` calls it).

    q, k, v: [B, T_local, H, hd] (any float dtype); gate [B, H, T_local];
    kvalid [B, T_local] (1 or True attends) for the local keys; rel_embed
    [num_buckets, H], replicated (may be None when ``bias_diags``, from
    ``ring_bias_diags``, is given). Returns [B, T_local, H, hd] in q's
    dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, gate)):
        raise NotImplementedError("ring attention has no gradient in the port (ROADMAP)")
    f32 = torch.float32
    B, t_local, H, hd = q.shape
    if bias_diags is None:
        bias_diags = ring_bias_diags(rel_embed, t_local, axis, num_buckets, max_distance)
    qf, kf, vf = (t.to(f32).contiguous() for t in (q, k, v))
    gf = gate.to(f32).contiguous()
    valid = kvalid.to(f32).contiguous()
    for step in range(axis.world):
        src = (axis.rank - step) % axis.world               # the block's owner
        out, lse = flash_block(qf, kf, vf, gf, bias_diags[src], valid)
        lse = lse.transpose(1, 2)[..., None]                # [B, T_local, H, 1]
        if step == 0:
            m, acc, denom = lse, out, torch.ones_like(lse)
        else:
            m_new = torch.maximum(m, lse)
            old, new = torch.exp(m - m_new), torch.exp(lse - m_new)
            acc = acc * old + out * new
            denom = denom * old + new
            m = m_new
        if step + 1 < axis.world:
            kf, vf, valid = axis.ring_shift([kf, vf, valid])
    return (acc / denom).to(q.dtype)


def ring_attention_sharded(q, k, v, gate, kvalid, rel_embed, *, axis, num_buckets: int,
                           max_distance: int):
    """JAX's ``ring_attention_sharded`` for whole tensors: every rank of
    ``axis`` passes the same [B, T, H, hd] q, k, v, gate [B, H, T] and kvalid
    [B, T]; each takes its slice of T (which must divide by the axis size),
    runs the ring, and every rank returns the whole [B, T, H, hd]."""
    T = q.shape[1]
    if T % axis.world:
        raise ValueError(f"T = {T} does not divide over {axis.world} ranks")
    n = T // axis.world
    part = slice(axis.rank * n, (axis.rank + 1) * n)
    out = ring_gated_attention(q[:, part], k[:, part], v[:, part], gate[:, :, part],
                               kvalid[:, part], rel_embed, axis=axis, num_buckets=num_buckets,
                               max_distance=max_distance)
    return gather_time(out, axis, dim=1)


def gather_time(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Each rank's slice along ``dim`` (rank r's at [r n, (r + 1) n)),
    concatenated on every rank: ``gather_last`` on ``dim`` moved last."""
    if axis.world == 1:
        return x
    return axis.gather_last(x.movedim(dim, -1).contiguous()).movedim(-1, dim)
