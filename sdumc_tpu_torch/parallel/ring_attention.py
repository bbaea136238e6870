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

The gradient (``RingGatedAttention``): JAX takes it by autodiff, ``ppermute``
transposing. Here the backward is a second ring: at each of the P steps the
local queries' backward against the visiting block (``flash_wavlm.
flash_backward`` given the merged out and log-sum-exp, so each block's p is
recomputed as exp(s - lse) of the whole ring's softmax); dq, dgate and the
block's diagonal gradient accumulate locally, dk and dv in buffers that
travel round the ring with k, v and the key mask, and take one rotation more
than k and v to reach their owner (P in all). The diagonals' gradient goes
back through ``ring_bias_diags``'s gather to the shared embedding; each
rank's gradient of a replicated input (the embedding, and under
``ring_attention_sharded`` every input) is its own queries' share, which
``parallel.reduce_gradients`` sums over the ranks. No Pallas kernel sits
on JAX's backward, and none on this one: it is f32 torch ops over query
chunks, as ``FlashGatedAttention``'s. Gradients come back in their inputs'
dtypes.
"""

from __future__ import annotations

import torch

from sdumc_tpu_torch.ops.kernels.flash_wavlm import bias_diag_for, flash_backward, flash_block


def ring_bias_diags(rel_embed: torch.Tensor, t_local: int, axis, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """[P, H, 2 T_local - 1] f32 on rel_embed's device: entry ``src`` is the
    diagonal bias of this rank's queries against rank ``src``'s keys, offset
    (src - rank) * T_local."""
    rel = rel_embed.float()
    return torch.stack([bias_diag_for(rel, t_local, num_buckets, max_distance,
                                      offset=(src - axis.rank) * t_local)
                        for src in range(axis.world)])


def _ring_forward(qf, kf, vf, gf, valid, bias_diags, axis):
    """(out, lse [B, H, T_local]) in f32 of the local queries over every
    block: P steps of ``flash_block``, merged by their log-sum-exps; k, v and
    the key mask rotated P - 1 times."""
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
    return acc / denom, (m + torch.log(denom))[..., 0].transpose(1, 2).contiguous()


class RingGatedAttention(torch.autograd.Function):
    """The ring's forward (``_ring_forward``) with the ring backward of the
    module docstring. Inputs: q, k, v [B, T_local, H, hd], gate [B, H,
    T_local], the f32 key mask [B, T_local], the [P, H, 2 T_local - 1]
    diagonals, the axis; output [B, T_local, H, hd] in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, gate, valid, bias_diags, axis):
        f32 = torch.float32
        qf, kf, vf = (t.to(f32).contiguous() for t in (q, k, v))
        gf = gate.to(f32).contiguous()
        diags = bias_diags.to(f32)
        out, lse = _ring_forward(qf, kf, vf, gf, valid, diags, axis)
        ctx.save_for_backward(qf, kf, vf, gf, valid, diags, out, lse)
        ctx.axis = axis
        ctx.dtypes = tuple(t.dtype for t in (q, k, v, gate, bias_diags))
        return out.to(q.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        qf, kf, vf, gf, valid, diags, out, lse = ctx.saved_tensors
        axis = ctx.axis
        P, t_local = axis.world, qf.shape[1]
        dout = dout.to(torch.float32)
        dq, dgate = torch.zeros_like(qf), torch.zeros_like(gf)
        ddiags = torch.zeros_like(diags)
        for step in range(P):
            src = (axis.rank - step) % P
            gq, gk, gv, gg, gd = flash_backward(qf, kf, vf, gf, diags[src], valid, out, dout,
                                                lse=lse, keys_total=P * t_local)
            dq += gq
            dgate += gg
            ddiags[src] += gd
            dk, dv = (gk, gv) if step == 0 else (dk + gk, dv + gv)
            if step + 1 < P:
                kf, vf, valid, dk, dv = axis.ring_shift([kf, vf, valid, dk, dv])
        dk, dv = axis.ring_shift([dk, dv])                  # to the block's owner
        grads = [g.to(dt) for g, dt in zip((dq, dk, dv, dgate, ddiags), ctx.dtypes)]
        return (*(g if need else None for g, need in
                  zip(grads[:4], ctx.needs_input_grad[:4])),
                None, grads[4] if ctx.needs_input_grad[5] else None, None)


def ring_gated_attention(q, k, v, gate, kvalid, rel_embed, *, axis, num_buckets: int,
                         max_distance: int, bias_diags=None):
    """This rank's shard of the attention (every rank of ``axis`` calls it).

    q, k, v: [B, T_local, H, hd] (any float dtype); gate [B, H, T_local];
    kvalid [B, T_local] (1 or True attends) for the local keys; rel_embed
    [num_buckets, H], replicated (may be None when ``bias_diags``, from
    ``ring_bias_diags``, is given). Returns [B, T_local, H, hd] in q's
    dtype. Differentiable (``RingGatedAttention``): every rank must then
    call backward, since the backward rotates too."""
    if bias_diags is None:
        bias_diags = ring_bias_diags(rel_embed, q.shape[1], axis, num_buckets, max_distance)
    return RingGatedAttention.apply(q, k, v, gate, kvalid.to(torch.float32).contiguous(),
                                    bias_diags, axis)


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
    concatenated on every rank: ``gather_last`` on ``dim`` moved last. Its
    gradient (``GatherTime``) is each rank's own slice of the output's:
    every rank computes the same loss of the same whole output."""
    if axis.world == 1:
        return x
    return GatherTime.apply(x, axis, dim)


class GatherTime(torch.autograd.Function):
    """``gather_time`` with JAX's contract for one global output and one
    loss that every rank computes alike: the backward hands each rank its own
    slice of the gradient (a reduce-scatter would give P times it).
    ``gather_last`` sums into a zeroed buffer in place, which autograd does
    not see, hence the explicit backward."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.part = (dim, axis.rank * x.shape[dim], x.shape[dim])
        return axis.gather_last(x.movedim(dim, -1).contiguous()).movedim(-1, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return grad.narrow(*ctx.part), None, None
