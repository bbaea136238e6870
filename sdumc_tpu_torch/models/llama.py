"""LLaMA-family decoder (Vicuna-7B-v1.5), the engine of the feat4 pseudo-text
stage.

The port of ``sdumc_tpu/models/llama.py`` (the unrolled layout). Submodules
carry HF's state_dict names (``model.layers.{i}.self_attn.q_proj.weight``,
``model.norm.weight``, ``lm_head.weight``), so an HF checkpoint loads as a
state dict (``convert/hf_llama.py``).

The dtype placement is JAX's: weights and activations in ``cfg.dtype``
(bf16 by default); RMSNorm in f32 with its f32 scale applied before the
cast; rope in f32; full-sequence and prefill scores and softmax in f32 with
the probabilities cast to the model dtype before P.V; decode attention
(one query row) entirely in f32; logits from a model-dtype matmul, then f32.

Caches are updated in place (JAX returns new ones): each layer's cache is a
dict whose ``index`` is the number of slots written. Eagerly it is a host
int, and only the written slots are read and moved. In a traced decode
step (``serve/export.py``) the generated part's index is a 0-d int64
tensor, an input of the program: the step then writes with ``index_copy_``
and reads the whole generated part with the slots at and past the index
masked to -1e30, as JAX does (they add exact zeros).

* Monolithic cache (``init_cache``): ``k``/``v`` [B, S, KV, hd]; attention
  runs over the written slots plus the current chunk (``_cached_attention``).
* Split cache (``split_cache_from_prefill``, the beam-decode cache): a
  per-clip prompt part ``pk``/``pv`` [C, P, KV, hd] that every beam reads
  shared, and a per-beam generated part ``gk``/``gv`` [R = C*B, G, KV, hd]
  (``_split_attention``). The generated parts of all layers are views of one
  preallocated stack per k and v (``SplitCache.stacks``), written in place
  each step, so the beam-ancestry reorder is one gather per stack.

Where ``kv_heads < num_heads`` the query heads are grouped by a reshape
([.., KV, H/KV, hd]) instead of repeating the keys and values per head; head
h reads kv head h // (H/KV), as ``jnp.repeat`` gives in JAX.

``scan_layers`` stays in the config so that configs carry over; it is not
read (a compile-size device of XLA; PyTorch runs the layers eagerly).

Tensor parallelism (``--tp N``, ``parallel/sharding.py``): a rank's model
is this one with ``TPLlamaAttention`` / ``TPLlamaMLP`` in each layer and
the embedding and ``lm_head`` gathered (``parallel/layers.py``), built by
``tp_model_from_state_dict`` from the rank's slices. The attention helpers
read the head counts from their tensors, so a rank's ``H / N`` heads run
the same code; a single process builds none of these modules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.ops.quant import QuantLinear
from sdumc_tpu_torch.parallel.layers import GatheredEmbedding, GatheredLinear, RowParallelLinear

NEG_MASK = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None   # None -> MHA (Vicuna-7B)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_position_embeddings: int = 4096
    dtype: Any = torch.bfloat16
    scan_layers: bool = False            # kept for configs; not read
    quant: Optional[str] = None          # None | "int8" | "w8a8" (ops/quant.py)
    kv_quant: Optional[str] = None       # None | "int8": int8 KV cache, per-(slot, head) scales

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_layers=3, num_heads=4, max_position_embeddings=256,
                    dtype=torch.float32)
        base.update(kw)
        return LlamaConfig(**base)


class RMSNorm(nn.Module):
    """f32 throughout, the f32 scale applied before the cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [B, T, 1, hd/2] f32 for absolute positions [B, T] (computed
    once per forward, shared by every layer)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotary embedding (half-split), in f32, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, hd] at positions [B, T]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(token, head) int8 over head_dim: x [..., hd] ->
    (int8 [..., hd], f32 scale [...])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _grouped(x: torch.Tensor, kv: int) -> torch.Tensor:
    """[..., H, hd] -> [..., KV, H/KV, hd] (head h = kv * rep + r)."""
    return x.reshape(*x.shape[:-2], kv, x.shape[-2] // kv, x.shape[-1])


def _cached_attention(c: LlamaConfig, q, k_new, v_new, k_old, v_old, idx: int, mask,
                      k_scale=None, v_scale=None):
    """Attention over the cache's written slots [0, idx) plus the current
    chunk, one joint softmax. q [B,T,H,hd]; k_new/v_new [B,T,KV,hd];
    k_old/v_old [B,S,KV,hd]; mask [B,1,T,S] additive over cache slots as if
    the chunk were already written at [idx, idx+T). Slots >= idx are not
    read: JAX masks them to -1e30, which adds exact zeros. k_scale/v_scale
    [B,S,KV]: int8-KV scales, folded outside the head_dim reductions.
    Returns [B,T,H,hd]."""
    B, T, H = q.shape[:3]
    KV, hd = k_new.shape[2], c.head_dim
    scale = math.sqrt(hd)
    mask = mask.expand(B, 1, T, mask.shape[-1])
    old_mask = mask[..., :idx][:, :, None]                 # [B,1,1,T,idx]
    chunk_mask = mask[..., idx:idx + T][:, :, None]         # [B,1,1,T,T]
    k_old, v_old = k_old[:, :idx], v_old[:, :idx]
    if k_scale is not None:
        k_scale, v_scale = k_scale[:, :idx], v_scale[:, :idx]
    qg = _grouped(q, KV)                                    # [B,T,KV,rep,hd]

    if T == 1:
        # decode step: everything in f32
        qf = qg.float()
        s_old = torch.einsum("btgrd,bsgd->bgrts", qf, k_old.float())
        if k_scale is not None:
            s_old = s_old * k_scale.permute(0, 2, 1)[:, :, None, None, :]
        s_self = torch.einsum("btgrd,bsgd->bgrts", qf, k_new.float())
        probs = torch.softmax(torch.cat([s_old / scale + old_mask,
                                         s_self / scale + chunk_mask], dim=-1), dim=-1)
        p_old = probs[..., :idx]
        if v_scale is not None:
            p_old = p_old * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bgrts,bsgd->btgrd", p_old, v_old.float())
        out = out + torch.einsum("bgrts,bsgd->btgrd", probs[..., idx:], v_new.float())
        return out.reshape(B, T, H, hd).to(c.dtype)

    # prefill: scores from model-dtype products, softmax in f32, probs cast back
    k_old_d = k_old if k_scale is None else k_old.to(c.dtype)
    s_old = torch.einsum("btgrd,bsgd->bgrts", qg, k_old_d).float()
    if k_scale is not None:
        s_old = s_old * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s_new = torch.einsum("btgrd,bsgd->bgrts", qg, k_new).float()
    probs = torch.softmax(torch.cat([s_old / scale + old_mask,
                                     s_new / scale + chunk_mask], dim=-1), dim=-1).to(c.dtype)
    out = torch.einsum("bgrts,bsgd->btgrd", probs[..., idx:], v_new)
    if idx:
        p_old = probs[..., :idx]
        if v_scale is not None:
            p_old = (p_old.float() * v_scale.permute(0, 2, 1)[:, :, None, None, :]).to(c.dtype)
        v_old_d = v_old if v_scale is None else v_old.to(c.dtype)
        out = torch.einsum("bgrts,bsgd->btgrd", p_old, v_old_d) + out
    return out.reshape(B, T, H, hd)


def _split_attention(c: LlamaConfig, q, k_new, v_new, pk, pv, gk, gv, gidx, pmask,
                     pk_scale=None, pv_scale=None, gk_scale=None, gv_scale=None):
    """Decode attention (one query row per beam) over a prompt-shared +
    per-beam generated split cache, in f32.

    q/k_new/v_new: [R, 1, (KV-)H, hd], rows clip-major (R = C*B). pk/pv:
    [C, P, KV, hd] prompt cache, read once per clip for all its beams; gk/gv:
    [R, G, KV, hd] generated cache of which slots [0, gidx) are written. A
    host-int ``gidx`` reads only those; a 0-d tensor (a traced step) reads
    all G with the rest masked to -1e30 as JAX does (exact zeros). pmask:
    [C, P] additive prompt mask (left-pad slots -1e30). *_scale: int8-KV
    scales ([C, P, KV] / [R, G, KV]) folded outside the head_dim reductions.
    Returns [R, 1, H, hd] in the model dtype."""
    R, _, H = q.shape[:3]
    C, P = pk.shape[:2]
    B, KV, hd = R // C, k_new.shape[2], c.head_dim
    scale = math.sqrt(hd)
    qf = _grouped(q[:, 0].float(), KV)                      # [R, KV, rep, hd]
    rep = qf.shape[2]
    stale = None
    if isinstance(gidx, torch.Tensor):
        stale = torch.arange(gk.shape[1], device=gk.device) >= gidx
    else:
        gk, gv = gk[:, :gidx], gv[:, :gidx]
        if gk_scale is not None:
            gk_scale, gv_scale = gk_scale[:, :gidx], gv_scale[:, :gidx]
    G = gk.shape[1]

    # prompt scores: beams grouped by clip, so each clip's prompt cache is read once
    s_p = torch.einsum("cbgrd,cpgd->cbgrp", qf.reshape(C, B, KV, rep, hd), pk.float())
    if pk_scale is not None:
        s_p = s_p * pk_scale.permute(0, 2, 1)[:, None, :, None, :]
    s_p = (s_p / scale + pmask[:, None, None, None, :]).reshape(R, KV, rep, P)
    s_g = torch.einsum("rgkd,rngd->rgkn", qf, gk.float())   # [R, KV, rep, G]
    if gk_scale is not None:
        s_g = s_g * gk_scale.permute(0, 2, 1)[:, :, None, :]
    s_g = s_g / scale
    if stale is not None:
        s_g = torch.where(stale, NEG_MASK, s_g)
    s_self = (qf * k_new[:, 0].float()[:, :, None, :]).sum(dim=-1, keepdim=True)
    probs = torch.softmax(torch.cat([s_p, s_g, s_self / scale], dim=-1), dim=-1)

    pp = probs[..., :P].reshape(C, B, KV, rep, P)
    if pv_scale is not None:
        pp = pp * pv_scale.permute(0, 2, 1)[:, None, :, None, :]
    out = torch.einsum("cbgrp,cpgd->cbgrd", pp, pv.float()).reshape(R, KV, rep, hd)
    pg = probs[..., P:P + G]
    if gv_scale is not None:
        pg = pg * gv_scale.permute(0, 2, 1)[:, :, None, :]
    out = out + torch.einsum("rgkn,rngd->rgkd", pg, gv.float())
    out = out + probs[..., P + G:] * v_new[:, 0].float()[:, :, None, :]
    return out.reshape(R, 1, H, hd).to(c.dtype)


def _linear(c: LlamaConfig, d_in: int, d_out: int, device=None) -> nn.Module:
    if c.quant is not None:
        return QuantLinear(d_in, d_out, c.quant, dtype=c.dtype, device=device)
    return nn.Linear(d_in, d_out, bias=False, dtype=c.dtype, device=device)


def _write(cache: Dict, key: str, idx, value: torch.Tensor) -> None:
    buf = cache[key]
    if isinstance(idx, torch.Tensor):
        slots = idx.reshape(1) + torch.arange(value.shape[1], device=buf.device)
        buf.index_copy_(1, slots, value.to(buf.dtype))
    else:
        buf[:, idx:idx + value.shape[1]] = value.to(buf.dtype)


def _append(cache: Dict, prefix: str, idx, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write the chunk k/v [B, T, KV, hd] at slots [idx, idx+T) of the
    ``{prefix}k``/``{prefix}v`` buffers (as int8 codes + scales when the
    cache holds scales) and advance the index (a host int, or a 0-d int64
    tensor in a traced step)."""
    if f"{prefix}k_scale" in cache:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        _write(cache, f"{prefix}k_scale", idx, ks)
        _write(cache, f"{prefix}v_scale", idx, vs)
    _write(cache, f"{prefix}k", idx, k)
    _write(cache, f"{prefix}v", idx, v)
    cache["index"] = idx + k.shape[1]


class LlamaAttention(nn.Module):
    """``heads`` query and ``kv_heads`` key/value heads of ``cfg.head_dim``:
    the config's counts here, a rank's in ``TPLlamaAttention``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.heads, self.kv_heads = c.num_heads, c.kv_heads
        self.q_proj = _linear(c, c.hidden_size, c.num_heads * c.head_dim, device)
        self.k_proj = _linear(c, c.hidden_size, c.kv_heads * c.head_dim, device)
        self.v_proj = _linear(c, c.hidden_size, c.kv_heads * c.head_dim, device)
        self.o_proj = _linear(c, c.num_heads * c.head_dim, c.hidden_size, device)

    def _kv(self, x):
        """(k, v) [B, T, kv_heads, hd], k before rope."""
        shape = x.shape[:2] + (self.kv_heads, self.cfg.head_dim)
        return self.k_proj(x).view(shape), self.v_proj(x).view(shape)

    def forward(self, x, rope_cs, mask, cache: Optional[Dict] = None):
        """x [B, T, D]; rope_cs the (cos, sin) of the positions; mask: [B|1,
        1, T, S] additive (full sequence or monolithic cache) or the [C, P]
        prompt mask (split cache). The cache, if any, is updated in place."""
        c = self.cfg
        B, T, _ = x.shape
        q = apply_rope(self.q_proj(x).view(B, T, self.heads, c.head_dim), *rope_cs)
        k, v = self._kv(x)
        k = apply_rope(k, *rope_cs)

        if cache is not None and "pk" in cache:
            gidx = cache["index"]
            out = _split_attention(c, q, k, v, cache["pk"], cache["pv"], cache["gk"],
                                   cache["gv"], gidx, mask, cache.get("pk_scale"),
                                   cache.get("pv_scale"), cache.get("gk_scale"),
                                   cache.get("gv_scale"))
            _append(cache, "g", gidx, k, v)
        elif cache is not None:
            idx = cache["index"]
            out = _cached_attention(c, q, k, v, cache["k"], cache["v"], idx, mask,
                                    cache.get("k_scale"), cache.get("v_scale"))
            _append(cache, "", idx, k, v)
        else:
            qg = _grouped(q, self.kv_heads)
            scores = torch.einsum("btgrd,bsgd->bgrts", qg, k).float() / math.sqrt(c.head_dim)
            scores = scores + mask[:, :, None]
            probs = torch.softmax(scores, dim=-1).to(c.dtype)
            out = torch.einsum("bgrts,bsgd->btgrd", probs, v)
        return self.o_proj(out.reshape(B, T, self.heads * c.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        c = cfg
        self.gate_proj = _linear(c, c.hidden_size, c.intermediate_size, device)
        self.up_proj = _linear(c, c.hidden_size, c.intermediate_size, device)
        self.down_proj = _linear(c, c.intermediate_size, c.hidden_size, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class TPLlamaAttention(LlamaAttention):
    """A rank's ``H / world`` query heads (rows ``[rank * H/world, ...)`` of
    q_proj) and o_proj's matching input columns, a ``RowParallelLinear``
    whose partial products are summed over the ranks. ``kv_split``: K and V
    split the same way (KV divides by world: the rank's query heads group
    into its own KV heads). Otherwise K and V are whole on every rank, and
    each query head takes the KV head it groups into (head h reads KV head
    h // (H / KV)), repeated per head, so the rank attends as MHA over its
    heads."""

    def __init__(self, cfg: LlamaConfig, axis, kv_split: bool, device=None):
        nn.Module.__init__(self)
        c = self.cfg = cfg
        self.heads = c.num_heads // axis.world
        kv = c.kv_heads // axis.world if kv_split else c.kv_heads
        self.kv_heads = kv if kv_split else self.heads
        first, group = axis.rank * self.heads, c.num_heads // c.kv_heads
        # the KV head of each of the rank's query heads (moved to x's device at first use)
        self.kv_pick = None if kv_split else (first + torch.arange(self.heads, device="cpu")) // group
        self.q_proj = _linear(c, c.hidden_size, self.heads * c.head_dim, device)
        self.k_proj = _linear(c, c.hidden_size, kv * c.head_dim, device)
        self.v_proj = _linear(c, c.hidden_size, kv * c.head_dim, device)
        self.o_proj = RowParallelLinear(self.heads * c.head_dim, c.hidden_size, axis,
                                        dtype=c.dtype, device=device)

    def _kv(self, x):
        if self.kv_pick is None:
            return super()._kv(x)
        if self.kv_pick.device != x.device:
            self.kv_pick = self.kv_pick.to(x.device)
        shape = x.shape[:2] + (self.cfg.kv_heads, self.cfg.head_dim)
        return (self.k_proj(x).view(shape).index_select(2, self.kv_pick),
                self.v_proj(x).view(shape).index_select(2, self.kv_pick))


class TPLlamaMLP(LlamaMLP):
    """A rank's ``intermediate_size / world`` columns of gate and up (rows of
    their weights) and down's matching input columns, a
    ``RowParallelLinear``."""

    def __init__(self, cfg: LlamaConfig, axis, device=None):
        nn.Module.__init__(self)
        c, inner = cfg, cfg.intermediate_size // axis.world
        self.gate_proj = _linear(c, c.hidden_size, inner, device)
        self.up_proj = _linear(c, c.hidden_size, inner, device)
        self.down_proj = RowParallelLinear(inner, c.hidden_size, axis, dtype=c.dtype,
                                           device=device)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device)
        self.mlp = LlamaMLP(cfg, device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)

    def forward(self, x, rope_cs, mask, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), rope_cs, mask, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


def tap_indices(n_hidden_states: int, layer_ids: Sequence[int]) -> list:
    """The hidden-state indices a tap sum takes, sorted; indices out of
    range are dropped (the clamp for shallow models)."""
    return sorted({i % n_hidden_states for i in layer_ids
                   if -n_hidden_states <= i < n_hidden_states})


def tap_coefficients(num_layers: int, tap_sum_layers: Sequence[int]):
    """Which hidden states (HF convention: [embed, layer outputs..., the last
    entry post-final-norm]) a tap sum takes, as (embed, per-layer, final)
    0/1 weights; the raw last-layer output never appears in the list."""
    n_hs = num_layers + 1
    idxs = set(tap_indices(n_hs, tap_sum_layers))
    layer = tuple(j + 1 in idxs and j + 1 != n_hs - 1 for j in range(num_layers))
    return 0 in idxs, layer, (n_hs - 1) in idxs


class LlamaModel(nn.Module):
    """Decoder trunk; returns the final hidden state, optional per-layer
    hidden states and the optional tap sum."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                         device=device)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)

    def forward(self, input_ids=None, inputs_embeds=None, positions=None, attn_mask=None,
                caches=None, output_hidden_states: bool = False,
                tap_sum_layers: Optional[Sequence[int]] = None):
        """``tap_sum_layers``: hidden-state indices (HF convention, so
        (-4, -3, -2, -1) is the reference's feat4 tap) whose sum is returned
        as ``tap_sum`` [B, T, D] f32 without keeping the per-layer states.
        ``caches``: per-layer cache dicts, updated in place."""
        c = self.cfg
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds.to(c.dtype)
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device)[None].expand(B, T)
        if attn_mask is None:
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            attn_mask = torch.where(causal, 0.0, NEG_MASK)[None, None]
        rope_cs = rope_tables(positions, c.head_dim, c.rope_theta)

        tap, coeff, tap_final = None, None, False
        if tap_sum_layers is not None:
            tap_embed, coeff, tap_final = tap_coefficients(c.num_layers, tap_sum_layers)
            tap = x.float() if tap_embed else torch.zeros(x.shape, device=x.device)
        hidden_states = [x] if output_hidden_states else None
        for i, layer in enumerate(self.layers):
            x = layer(x, rope_cs, attn_mask, caches[i] if caches is not None else None)
            if output_hidden_states:
                hidden_states.append(x)
            if tap is not None and coeff[i]:
                tap = tap + x.float()
        x = self.norm(x)
        if output_hidden_states:
            hidden_states[-1] = x          # HF: the last entry is post-final-norm
        if tap is not None and tap_final:
            tap = tap + x.float()
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None,
                "tap_sum": tap, "caches": caches}


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, device)
        self.lm_head = _linear(cfg, cfg.hidden_size, cfg.vocab_size, device)

    def forward(self, last_logit_only: bool = False, **kw):
        """``last_logit_only``: logits of the final position only (decode
        prefill needs just the next-token distribution). Logits come from a
        model-dtype matmul, then f32."""
        out = self.model(**kw)
        h = out["last_hidden_state"]
        if last_logit_only:
            h = h[:, -1:]
        out["logits"] = self.lm_head(h).float()
        return out


def model_from_state_dict(cfg: LlamaConfig, state_dict) -> LlamaForCausalLM:
    """The model built on the meta device and given the state dict's
    tensors as they are (``assign=True``: no copy, their devices and
    dtypes), in eval mode. Raises if a key is missing or unknown."""
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval()


def tp_model_from_state_dict(cfg: LlamaConfig, state_dict, specs, axis, trunk: bool = False):
    """A rank's tensor-parallel model: ``LlamaForCausalLM`` (or, ``trunk``,
    its ``LlamaModel``) built on the meta device, each module whose weights
    ``specs`` split (``parallel.sharding.llama_specs``: key -> split dim or
    None) replaced by its tensor-parallel form, and given the rank's tensors
    (``parallel.sharding.shard_state_dict``'s) as they are, in eval mode.
    Its ``cfg`` is the rank's: ``num_kv_heads`` counts the KV heads the rank
    caches, so ``init_cache`` and the beam engine size the rank's buffers.
    Specs that split nothing (a world of 1) give the single-process model."""

    def split(suffix: str) -> bool:
        return any(d is not None for k, d in specs.items() if k.endswith(suffix))

    with torch.device("meta"):
        model = LlamaModel(cfg) if trunk else LlamaForCausalLM(cfg)
        body = model if trunk else model.model
        for layer in body.layers:
            if split("self_attn.q_proj.weight"):
                layer.self_attn = TPLlamaAttention(cfg, axis, split("self_attn.k_proj.weight"))
            if split("mlp.gate_proj.weight"):
                layer.mlp = TPLlamaMLP(cfg, axis)
        if split("embed_tokens.weight"):
            body.embed_tokens = GatheredEmbedding(cfg.vocab_size, cfg.hidden_size // axis.world,
                                                  axis, dtype=cfg.dtype)
        if split("lm_head.weight"):
            model.lm_head = GatheredLinear(cfg.hidden_size, cfg.vocab_size // axis.world, axis,
                                           dtype=cfg.dtype)
    model.load_state_dict(state_dict, strict=True, assign=True)
    kv_heads = body.layers[0].self_attn.kv_heads if body.layers else cfg.kv_heads
    if kv_heads != cfg.kv_heads:
        model.cfg = body.cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    return model.eval()


def init_weights(model: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Seeded weights as HF's init draws them: every Linear and Embedding
    weight normal(0, std), norm scales 1 (int8 codes/scales are made by
    ``quantize_params``, not drawn). Each tensor is drawn on its own device
    from one generator per device, seeded with ``seed``."""
    gens = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = torch.Generator(p.device).manual_seed(seed)
            p.normal_(0.0, std, generator=gen)
    return model


def _kv_buffers(cfg: LlamaConfig, shape: Tuple[int, ...], device) -> Dict[str, torch.Tensor]:
    quant = cfg.kv_quant == "int8"
    dtype = torch.int8 if quant else cfg.dtype
    out = {"k": torch.zeros(shape + (cfg.kv_heads, cfg.head_dim), dtype=dtype, device=device),
           "v": torch.zeros(shape + (cfg.kv_heads, cfg.head_dim), dtype=dtype, device=device)}
    if quant:
        out["k_scale"] = torch.zeros(shape + (cfg.kv_heads,), device=device)
        out["v_scale"] = torch.zeros(shape + (cfg.kv_heads,), device=device)
    return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None) -> Tuple[Dict, ...]:
    """Per-layer monolithic caches [batch, max_len, KV, hd] (int8 codes and
    f32 scales under ``kv_quant="int8"``), index 0."""
    return tuple({**_kv_buffers(cfg, (batch, max_len), device), "index": 0}
                 for _ in range(cfg.num_layers))


class SplitCache(tuple):
    """The per-layer dicts of a split cache (a tuple, as JAX's), with
    ``stacks``: the generated parts of all layers, one [L, R, G, ...] tensor
    per key, of which each layer's ``g*`` entries are views."""

    stacks: Dict[str, torch.Tensor]

    def tensors(self) -> Dict[str, Any]:
        """The cache as plain tensors, none a view of another: each prompt
        key's per-layer list (``pk``, ``pv``, and ``pk_scale``, ``pv_scale``
        under int8-KV) and the generated stacks (``gk``, ``gv``, ...)."""
        out: Dict[str, Any] = {k: [layer[k] for layer in self]
                               for k in self[0] if k.startswith("p")}
        out.update(self.stacks)
        return out

    @staticmethod
    def from_tensors(flat: Dict[str, Any], index) -> "SplitCache":
        """The cache of ``tensors()``, each layer's generated part a view of
        its stack and its index ``index`` (a host int or a 0-d tensor)."""
        stacks = {k: t for k, t in flat.items() if k.startswith("g")}
        layers = []
        for i in range(len(flat["pk"])):
            layer = {k: t[i] for k, t in flat.items() if k.startswith("p")}
            layer.update({k: t[i] for k, t in stacks.items()})
            layer["index"] = index
            layers.append(layer)
        out = SplitCache(layers)
        out.stacks = stacks
        return out


def split_cache_from_prefill(cfg: LlamaConfig, prefill_caches, beams: int,
                             gen_max: int) -> SplitCache:
    """The beam-decode split cache from a finished per-clip prefill: the
    prefill's [C, P] buffers become the shared read-only prompt part as they
    are (no per-beam copy), and a [C*beams, gen_max] generated part is
    allocated once for all layers, with its own write index at 0."""
    L = len(prefill_caches)
    first = prefill_caches[0]["k"]
    R = first.shape[0] * beams
    flat: Dict[str, Any] = {f"p{k}": [pc[k] for pc in prefill_caches]
                            for k in prefill_caches[0] if k != "index"}
    flat.update({f"g{k}": t for k, t in _kv_buffers(cfg, (L, R, gen_max), first.device).items()})
    return SplitCache.from_tensors(flat, 0)


def cache_mask(query_positions: torch.Tensor, max_len: int) -> torch.Tensor:
    """Additive mask [B, 1, T, max_len]: attend to cache slots <= position."""
    slots = torch.arange(max_len, device=query_positions.device)[None, None, None, :]
    ok = slots <= query_positions[:, None, :, None]
    return torch.where(ok, 0.0, NEG_MASK)

