"""WavLM gated-rel-pos attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``sdumc_tpu/ops/pallas/flash_wavlm.py::_flash_kernel``
(``pallas_call`` at flash_wavlm.py:371, public as ``flash_gated_attention``).
For q, k, v [B, T, H, hd], the gru_rel_pos gate [B, H, T] and the shared
bucket embedding rel_embed [num_buckets, H]:

    s[b,h,t,u] = q[b,t,h] . k[b,u,h] / sqrt(hd)
                 + gate[b,h,t] * rel_embed[bucket(u - t), h]   (-1e30 where
                                                                kvalid[b,u] = 0)
    out[b,t,h] = sum_u softmax_u(s[b,h,t,:]) * v[b,u,h]

The bias depends on (t, u) only through r = u - t, so the kernel takes it as
a per-head diagonal vector ``bias_diag[h, r + T - 1] = rel_embed[bucket(r),
h]`` of shape [H, 2T - 1]; the encoder builds it once per forward and
carries it across its layers. Its buckets are always computed on the CPU,
so the kernel and the plain version see the same ones whatever the device's
``log`` rounds to. The kernel (``csrc/flash_wavlm.cu``) streams key tiles
through an online softmax and never stores the [T, T] scores; its header
says what bounds it on an H100. Python reaches the kernel through one
``torch.library`` custom op, ``sdumc::flash_wavlm``: its CUDA
implementation is ``launch`` (the only caller of the ``ctypes`` entry
points), its CPU implementation the plain version below, and its fake
implementation gives ``torch.export`` the output's shape. So a tensor on
the CPU takes the plain version, and a tensor on the card takes the kernel
or raises.

q, k, v are f32, or bf16 (``cli.extract audio --dtype bfloat16``): the bf16
instance computes what the Pallas kernel computes at bf16 inputs. The gate
and the bias are rounded to bf16, masked keys add NEG rounded to bf16, the
scores and the softmax statistics are f32, p = exp(s - m) is rounded to bf16
before P.V, the row sum is the f32 sum of the rounded p, and the output is
rounded to bf16 once. m is the running max over the bf16 instance's
128-key tiles (``KEY_TILE_BF16``, the Pallas kernel's default block), and
its plain version rounds p against the same running max. The two then
differ only by f32 rounding (summation order, exp against the kernel's
exp2): that moves a p by one bf16 ulp only where it lies within a few f32
ulps of a rounding midpoint. ``bf16_tolerance`` bounds the output if every
p moved so, and ``BF16_MISMATCH_LIMIT`` bounds the share of output elements
that differ at all, which catches a p rounded against another max, an
unrounded p or a row sum of the unrounded p (see its comment).

The block form (``flash_block``): the f32 kernel on one (query block, key
block) pair of ring attention (``parallel/ring_attention.py``), whose keys
sit ``offset`` frames after its queries. The offset goes into the diagonal
(``bias_diag_for(..., offset=...)``: entry r + T - 1 is rel_embed[bucket(r +
offset)], JAX's ``bucket_from_rel`` on the global distance), and the
kernel's block instance also returns each row's log-sum-exp [B, H, T] in
f32, the statistic that merges the blocks. It is the op
``sdumc::flash_wavlm_lse`` (CUDA implementation ``launch_block``), whose CPU
implementation, the plain version, is the einsum step with
``torch.logsumexp``.

The gradient (``FlashGatedAttention``) is the port of JAX's
``flash_gated_attention_trainable``: the forward is the op (the kernel, or
the plain version on the CPU), the backward is ``_flash_bwd_scan`` (flash_wavlm.py:
435-486) as torch ops over query chunks, in O(T * chunk) memory. JAX's
backward is XLA, not Pallas, so there is no backward kernel here either.
The same ``flash_backward`` takes one block of the ring's merged softmax
(its merged out and log-sum-exp given): ring attention's backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from sdumc_tpu_torch.ops.kernels import build, check_operand

NEG = -1e30
KERNEL_HEAD_DIMS = (16, 64)       # hd instances: wavlm-large's 64, the card tests' 16
KEY_TILE = 64                     # keys per tile of the f32 instance's online softmax
KEY_TILE_BF16 = 128               # ... of the bf16 instance's: the Pallas kernel's default block

NEG_BF16 = float(torch.tensor(NEG).bfloat16())   # NEG rounded to bf16: -1.00026e30
# The largest share of bf16 output elements in which the kernel may differ
# from its plain version. The kernel reads 3.3e-4 and 1.4e-3 at wavlm-large's
# heads, T = 249 and 2999, with mixed masks (chip_smoke.py phase 19, H100
# 80GB HBM3 at 700 W), and the plain version 0 - 2.9e-4 against JAX's Pallas
# kernel in interpret mode at the same key tile (tests/test_torch_wavlm_bf16.py,
# tests/test_torch_bf16_kernels.py at the 128-key tile).
# At the same shapes variants read 2.6-3.7% (the row sum of the unrounded p),
# 11-15% (p rounded against the final max) and 24-26% (p not rounded), and
# JAX's kernel at another key tile 5-10%.
BF16_MISMATCH_LIMIT = 0.01
BWD_CHUNK = 128                   # query rows per step of the backward

# Kernel launches of the f32, the bf16 and the block instance; the plain
# versions count nothing.
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_BLOCK = 0


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_BLOCK
    LAUNCHES = LAUNCHES_BF16 = LAUNCHES_BLOCK = 0


def bucket_from_rel(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5-style bidirectional bucketing of signed relative positions (HF
    WavLMAttention.compute_bias), in f32 with truncation to int32, as the
    JAX package's bucket_from_rel does."""
    nb = num_buckets // 2
    buckets = (rel > 0).to(torch.int32) * nb
    rel = rel.abs()
    max_exact = nb // 2
    is_small = rel < max_exact
    rel_large = (
        max_exact
        + torch.log(rel.clamp(min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).to(torch.int32)
    rel_large = rel_large.clamp(max=nb - 1)
    return buckets + torch.where(is_small, rel.to(torch.int32), rel_large)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """[q_len, k_len] int32 buckets of (key - query), on the CPU."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    return bucket_from_rel(rel, num_buckets, max_distance)


def bias_diag_for(rel_embed: torch.Tensor, T: int, num_buckets: int,
                  max_distance: int, offset: int = 0) -> torch.Tensor:
    """[H, 2T - 1] in rel_embed's dtype (f32 or bf16): entry r + T - 1 of
    head h is rel_embed[bucket(r + offset), h] for r = key - query in [-(T -
    1), T - 1]; ``offset`` is how far the keys' block starts after the
    queries' (a ring step's, 0 for one block). Buckets come from the CPU. A
    gather, so autograd takes a gradient of the diagonal back to rel_embed."""
    buckets = bucket_from_rel(torch.arange(-(T - 1), T) + offset, num_buckets, max_distance)
    diag = rel_embed[buckets.to(device=rel_embed.device, dtype=torch.long)]
    return diag.t().contiguous()


def dense_bias(bias_diag: torch.Tensor, T: int) -> torch.Tensor:
    """[H, T, T] bias[h, t, u] = bias_diag[h, u - t + T - 1]."""
    idx = torch.arange(T, device=bias_diag.device)
    return bias_diag[:, idx[None, :] - idx[:, None] + (T - 1)]


def flash_gated_attention_plain(q, k, v, gate, rel_embed, kvalid=None, bias_diag=None,
                                *, num_buckets: int, max_distance: int,
                                key_tile: int = KEY_TILE_BF16):
    """The einsum formulation: the CPU path and the kernel's oracle.
    ``bias_diag`` ([H, 2T - 1], from ``bias_diag_for``) stands in for
    ``rel_embed`` when given. A bf16 q takes the bf16 instance's semantics
    (``_plain_bf16``), p rounded against the running max of ``key_tile``
    keys (the bf16 instance's 128; JAX's Pallas kernel's is its ``block``,
    128 by default)."""
    B, T, H, hd = q.shape
    if bias_diag is None:
        bias_diag = bias_diag_for(rel_embed, T, num_buckets, max_distance)
    if q.dtype == torch.bfloat16:
        return _plain_bf16(q, k, v, gate, bias_diag, kvalid, key_tile)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    scores = scores + gate[..., None] * dense_bias(bias_diag, T)[None]
    if kvalid is not None:
        scores = scores.masked_fill(~(kvalid[:, None, None, :] > 0), NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _plain_bf16(q, k, v, gate, bias_diag, kvalid, key_tile: int = KEY_TILE_BF16):
    """The bf16 instance's function on the widened inputs: q scaled in bf16
    (the Pallas wrapper's fold; exact for hd 16 and 64), the gate and the
    bias rounded to bf16, masked keys at NEG rounded to bf16, f32 scores and
    softmax statistics, p rounded to bf16, the row sum of the rounded p, the
    output rounded to bf16 once. As in the kernel, p = exp(s - m_j) is
    rounded against the running max m_j of the key tiles 0..j (``key_tile``
    keys each, the kernel's 128), and tile j's sums are carried to the final
    max by exp(m_j - m_last)."""
    B, T, H, hd = q.shape
    bf = torch.bfloat16
    qs = (q.to(bf) * torch.tensor(1.0 / math.sqrt(hd), dtype=bf)).float()
    scores = torch.einsum("bthd,bshd->bhts", qs, k.to(bf).float())
    bias = dense_bias(bias_diag.to(bf).float(), T)
    scores = scores + gate.to(bf).float()[..., None] * bias[None]
    if kvalid is not None:
        scores = scores.masked_fill(~(kvalid[:, None, None, :] > 0), NEG_BF16)
    n = -(-T // key_tile)
    tiles = torch.nn.functional.pad(scores, (0, n * key_tile - T), value=-math.inf)
    tiles = tiles.view(B, H, T, n, key_tile)
    m = tiles.amax(-1).cummax(-1).values                                # [B, H, T, n]
    p = torch.exp(tiles - m[..., None]).to(bf).float()
    carry = torch.exp(m - m[..., -1:])
    w = (p * carry[..., None]).view(B, H, T, n * key_tile)[..., :T]
    out = torch.einsum("bhts,bshd->bthd", w, v.to(bf).float())
    return (out / (p.sum(-1) * carry).sum(-1).transpose(1, 2)[..., None]).to(bf)


def flash_block_plain(q, k, v, gate, bias_diag, kvalid=None):
    """The block instance's plain version: (out [B, T, H, hd], lse [B, H,
    T]) of the f32 scores of ``flash_gated_attention_plain``, lse their
    ``torch.logsumexp`` over the block's keys. A row whose keys are all
    masked has lse = NEG (+ log T, lost to rounding) and out the mean of v."""
    B, T, H, hd = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    scores = scores + gate[..., None] * dense_bias(bias_diag, T)[None]
    if kvalid is not None:
        scores = scores.masked_fill(~(kvalid[:, None, None, :] > 0), NEG)
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)
    return out, torch.logsumexp(scores, dim=-1)


def flash_block(q, k, v, gate, bias_diag, kvalid=None):
    """(out, lse) of one f32 block (see the module docstring), through the
    op ``sdumc::flash_wavlm_lse``: the block instance for CUDA tensors, the
    plain version for CPU ones. No gradient of its own: ring attention's
    ``RingGatedAttention`` takes each block's by ``flash_backward`` with the
    merged lse."""
    return torch.ops.sdumc.flash_wavlm_lse(q, k, v, gate, bias_diag, kvalid)


@torch.library.custom_op("sdumc::flash_wavlm_lse", mutates_args=(), device_types="cpu")
def _flash_wavlm_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                        bias_diag: torch.Tensor, kvalid: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, H, hd], lse [B, H, T]) in f32: the block instance for a
    CUDA q, the plain version (this body) for a CPU one."""
    out, lse = flash_block_plain(q, k, v, gate, bias_diag, kvalid)
    return out.contiguous(), lse.contiguous()


@_flash_wavlm_lse_op.register_kernel("cuda")
def _flash_wavlm_lse_cuda(q, k, v, gate, bias_diag, kvalid):
    return launch_block(q, k, v, gate, bias_diag, kvalid)


@_flash_wavlm_lse_op.register_fake
def _flash_wavlm_lse_fake(q, k, v, gate, bias_diag, kvalid):
    B, T, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(B, H, T, dtype=torch.float32))


def _attention_flops(q_shape, k_shape, v_shape) -> int:
    """q . k^T and p . v over every query and key of the padded T, as the
    plain version computes them: 2 B H Tq Tk (hd_qk + hd_v)."""
    B, Tq, H, hd = q_shape
    Tk, hd_v = k_shape[1], v_shape[-1]
    return 2 * B * H * Tq * Tk * (hd + hd_v)


@register_flop_formula(torch.ops.sdumc.flash_wavlm_lse)
def flash_wavlm_lse_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """The block op's flops for ``torch.utils.flop_counter``: 4 B H Tq Tk hd."""
    return _attention_flops(q_shape, k_shape, v_shape)


def bf16_tolerance(out: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A bound on |kernel - plain| at bf16, element by element of ``out``
    [B, T, H, hd] (either output): 2^-7 max_u |v[u] - out| + one bf16 ulp of
    |out| + 1e-5 max_u |v[u]|.

    Both round p to bf16 against the same running max, from f32 values that
    differ in their last bits, so a p may come out one bf16 ulp apart (a
    factor within 1 +- 2^-7). out = sum_u p_u v_u / sum_u p_u moves by
    sum_u w_u d_u (v_u - out) for p_u (1 + d_u), at most 2^-7 max_u |v_u -
    out| even if every p moved (here over every key u, attended or not,
    which bounds the attended ones). Both round the f32 quotient to bf16
    once: one more ulp. The last term covers the f32 sums, taken in other
    orders. Few p move in fact; ``BF16_MISMATCH_LIMIT`` holds that."""
    vf, of = v.float(), out.float()
    spread = torch.maximum((vf.amax(1, keepdim=True) - of).abs(),
                           (vf.amin(1, keepdim=True) - of).abs())
    ulp = torch.ldexp(torch.ones_like(of), torch.frexp(of.abs()).exponent - 8)
    return 2.0 ** -7 * spread + ulp + 1e-5 * vf.abs().amax(1, keepdim=True)


def bf16_mismatch_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of elements in which two bf16 outputs differ."""
    return (got != ref).float().mean().item()


def flash_gated_attention(q, k, v, gate, rel_embed, kvalid=None, bias_diag=None,
                          *, num_buckets: int, max_distance: int):
    """out [B, T, H, hd] (see the module docstring).

    q/k/v are [B, T, H, hd], f32 or bf16, gate [B, H, T], rel_embed
    [num_buckets, H] (may be None when ``bias_diag`` is given), kvalid an
    optional [B, T] 0/1 (or bool) key mask, any pattern, and bias_diag the
    optional precomputed [H, 2T - 1] diagonal bias. Under autograd (an input
    that requires grad) the call goes through ``FlashGatedAttention``, whose
    gradient reaches rel_embed through ``bias_diag_for``'s gather.
    """
    if bias_diag is None:
        if rel_embed is None:
            raise ValueError("pass rel_embed or bias_diag")
        bias_diag = bias_diag_for(rel_embed, q.shape[1], num_buckets, max_distance)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, gate, bias_diag)):
        return FlashGatedAttention.apply(q, k, v, gate, bias_diag, kvalid)
    return torch.ops.sdumc.flash_wavlm(q, k, v, gate, bias_diag, kvalid)


@torch.library.custom_op("sdumc::flash_wavlm", mutates_args=(), device_types="cpu")
def _flash_wavlm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                    bias_diag: torch.Tensor, kvalid: Optional[torch.Tensor]) -> torch.Tensor:
    """out [B, T, H, hd] in q's dtype: the kernel for a CUDA q, the plain
    version (this body) for a CPU one. No gradient formula of its own:
    ``flash_gated_attention`` puts ``FlashGatedAttention`` around it."""
    return flash_gated_attention_plain(q, k, v, gate, None, kvalid, bias_diag,
                                       num_buckets=0, max_distance=0).contiguous()


@_flash_wavlm_op.register_kernel("cuda")
def _flash_wavlm_cuda(q, k, v, gate, bias_diag, kvalid):
    return launch(q, k, v, gate, bias_diag, kvalid)


@_flash_wavlm_op.register_fake
def _flash_wavlm_fake(q, k, v, gate, bias_diag, kvalid):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.sdumc.flash_wavlm)
def flash_wavlm_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """The op's flops for ``torch.utils.flop_counter``: 4 B H T^2 hd."""
    return _attention_flops(q_shape, k_shape, v_shape)


class FlashGatedAttention(torch.autograd.Function):
    """The forward of ``flash_gated_attention`` with JAX's chunked exact
    backward (``_flash_bwd_scan``): per chunk of BWD_CHUNK query rows, the
    softmax is recomputed in f32 over the full key axis, then

        dS = p (dP - sum_d dout out),   dP = dout . v
        dq = dS k / sqrt(hd),  dk += dS^T q / sqrt(hd),  dv += p^T dout,
        dgate = sum_u dS bias,  d_bias_diag[h, u - t + T - 1] += sum_b dS gate

    in O(T * chunk) memory. JAX scatter-adds d_rel_embed per bucket; here the
    bias is the [H, 2T - 1] diagonal, so its gradient is the sum along each
    diagonal of dS * gate, and autograd carries it back through
    ``bias_diag_for``'s gather to the rel_embed that every layer shares.
    Gradients take their inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, gate, bias_diag, kvalid):
        out = torch.ops.sdumc.flash_wavlm(q, k, v, gate, bias_diag, kvalid)
        ctx.save_for_backward(q, k, v, gate, bias_diag, kvalid, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, gate, bias_diag, kvalid, out = ctx.saved_tensors
        grads = flash_backward(q, k, v, gate, bias_diag, kvalid, out, dout)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad[:5])),
                None)


def flash_backward(q, k, v, gate, bias_diag, kvalid, out, dout, chunk: int = BWD_CHUNK,
                   lse=None, keys_total: Optional[int] = None):
    """(dq, dk, dv, dgate, d_bias_diag) of the attention, as JAX's
    ``_flash_bwd_scan`` takes them (f32 throughout, NEG on masked keys).

    With ``lse`` ([B, H, T] f32) the same for one block of a merged softmax
    (ring attention's backward): q are the local queries, k / v / kvalid a
    visiting key block of the same length, bias_diag its diagonal with the
    block's offset folded in (as ``flash_block`` takes it), and out / lse
    the merged output and log-sum-exp over all ``keys_total`` keys. Then p =
    exp(s - lse) and D = rowsum(dout . out) of the merged out; the block's
    share of dq, dgate and d_bias_diag is returned, and all of its dk, dv
    from these queries. A row with no valid key in any block (lse at NEG,
    where log T is lost) has p = 1 / keys_total on every key, so dv gets
    dout / keys_total and dq, dgate and the bias nothing, as JAX's ``where``
    gives them; a block that is fully masked for a row with valid keys
    elsewhere has p = exp(NEG - lse) = 0."""
    B, T, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    f = torch.float32
    kf, vf = k.to(f), v.to(f)
    diag = bias_diag.to(f)
    keymask = (None if kvalid is None else
               torch.where(kvalid > 0, 0.0, NEG).to(f)[:, None, None, :])
    dq = torch.empty(B, T, H, hd, dtype=f, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    dgate = torch.empty(B, H, T, dtype=f, device=q.device)
    ddiag = torch.zeros_like(diag)
    keys = torch.arange(T, device=q.device)
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        q_c, out_c, dout_c = (t[:, c0:c1].to(f) for t in (q, out, dout))
        gate_c = gate[:, :, c0:c1].to(f)                                 # [B, H, c]
        idx = keys[None, :] - torch.arange(c0, c1, device=q.device)[:, None] + (T - 1)
        bias_c = diag[:, idx]                                            # [H, c, T]
        s = torch.einsum("bthd,bshd->bhts", q_c, kf) * scale + gate_c[..., None] * bias_c[None]
        if keymask is not None:
            s = s + keymask
        dP = torch.einsum("bthd,bshd->bhts", dout_c, vf)
        dsum = (dout_c * out_c).sum(-1).transpose(1, 2)                  # [B, H, c]
        if lse is None:
            p = torch.softmax(s, dim=-1)                                 # [B, H, c, T]
            dS = p * (dP - dsum[..., None])
        else:
            lse_c = lse[:, :, c0:c1, None]
            empty = lse_c < NEG / 2                                      # no valid key anywhere
            p = torch.where(empty, 1.0 / keys_total, torch.exp(s - lse_c))
            dS = torch.where(empty, 0.0, p * (dP - dsum[..., None]))
        dq[:, c0:c1] = torch.einsum("bhts,bshd->bthd", dS, kf) * scale
        dk += torch.einsum("bhts,bthd->bshd", dS, q_c) * scale
        dv += torch.einsum("bhts,bthd->bshd", p, dout_c)
        dgate[:, :, c0:c1] = (dS * bias_c[None]).sum(-1)
        ddiag.index_add_(1, idx.reshape(-1),
                         torch.einsum("bhts,bht->hts", dS, gate_c).reshape(H, -1))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dgate.to(gate.dtype),
            ddiag.to(bias_diag.dtype))


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_wavlm")
    if lib.sdumc_flash_wavlm_error_string.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.sdumc_flash_wavlm, lib.sdumc_flash_wavlm_bf16):
            fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
        lib.sdumc_flash_wavlm_lse.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                              ctypes.c_float, p]
        lib.sdumc_flash_wavlm_lse.restype = ctypes.c_int
        lib.sdumc_flash_wavlm_error_string.argtypes = [i]
        lib.sdumc_flash_wavlm_error_string.restype = ctypes.c_char_p
    return lib


def _checked(q, k, v, gate, bias_diag, kvalid, dtype):
    """Raise unless the operands are what the kernel takes (q, k, v, the gate
    and the diagonal of ``dtype``); returns kvalid as f32, or None."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on a CUDA device, q is on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, hd], got {tuple(q.shape)}")
    B, T, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {KERNEL_HEAD_DIMS}, got hd={hd}")
    dev = q.device
    for name, t, shape in (("q", q, (B, T, H, hd)), ("k", k, (B, T, H, hd)),
                           ("v", v, (B, T, H, hd)), ("gate", gate, (B, H, T)),
                           ("bias_diag", bias_diag, (H, 2 * T - 1))):
        check_operand(name, t, shape, dev, (dtype,))
    if kvalid is None:
        return None
    if kvalid.device != dev:
        raise ValueError(f"kvalid is on {kvalid.device}, q on {dev}")
    if tuple(kvalid.shape) != (B, T):
        raise ValueError(f"kvalid must be [B={B}, T={T}], got {tuple(kvalid.shape)}")
    return kvalid.to(torch.float32).contiguous()


def _raise_on(err: int, lib) -> None:
    if err:
        raise RuntimeError("flash_wavlm kernel launch failed: "
                           + lib.sdumc_flash_wavlm_error_string(err).decode())


def launch(q, k, v, gate, bias_diag, kvalid=None):
    """Run the kernel on the card, the f32 instance for an f32 q and the bf16
    instance for a bf16 one (k and v of q's dtype; the gate and the bias
    diagonal are rounded to it, as the Pallas wrapper's gate column and bias
    tiles are); raises on what it does not take."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        gate, bias_diag = gate.to(torch.bfloat16), bias_diag.to(torch.bfloat16)
    kvalid = _checked(q, k, v, gate, bias_diag, kvalid,
                      torch.bfloat16 if bf16 else torch.float32)
    B, T, H, hd = q.shape
    dev = q.device
    kvalid_ptr = None if kvalid is None else kvalid.data_ptr()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.sdumc_flash_wavlm_bf16 if bf16 else lib.sdumc_flash_wavlm
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias_diag.data_ptr(), kvalid_ptr, out.data_ptr(),
            B, T, H, hd, 1.0 / math.sqrt(hd), stream)
    _raise_on(err, lib)
    global LAUNCHES, LAUNCHES_BF16
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out


def launch_block(q, k, v, gate, bias_diag, kvalid=None):
    """Run the block instance on the card: f32 q, k, v [B, T, H, hd], gate
    [B, H, T], bias_diag [H, 2T - 1] (with the block's offset folded in);
    returns (out, lse [B, H, T] f32). Raises on what it does not take."""
    kvalid = _checked(q, k, v, gate, bias_diag, kvalid, torch.float32)
    B, T, H, hd = q.shape
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdumc_flash_wavlm_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(), bias_diag.data_ptr(),
            None if kvalid is None else kvalid.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, T, H, hd, 1.0 / math.sqrt(hd), stream)
    _raise_on(err, lib)
    global LAUNCHES_BLOCK
    LAUNCHES_BLOCK += 1
    return out, lse
