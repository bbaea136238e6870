"""GLM / ChatGLM decoder (the chatglm2-6b and glm-4 lineages): a text
family of the text stage.

The port of ``sdumc_tpu/models/glm.py``, under the names of HF's native
``GlmModel`` (``embed_tokens``, ``layers.{i}.self_attn.q_proj``,
``layers.{i}.mlp.gate_up_proj``, ``norm``); ``convert/hf_glm.py`` renames
and splits a THUDM chatglm2 state dict into them. The architecture:

  RMSNorm pre-norm layers; partial interleaved rotary (GPT-J pairs) on the
  first ``head_dim * partial_rotary_factor`` dims of each head, the rest
  passed through; grouped-query attention with QKV bias; a fused
  ``gate_up_proj`` split as (gate, up), SwiGLU; a final RMSNorm, which
  replaces the last hidden state.

JAX repeats K and V per query head; the port groups the query heads by a
reshape instead (head h reads kv head h // (H / KV), as ``jnp.repeat``
gives). Scores and softmax are f32, the mask additive at -1e30 (finite).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.llama import NEG_MASK, RMSNorm, _grouped


@dataclasses.dataclass(frozen=True)
class GlmConfig:
    vocab_size: int = 65024            # chatglm2-6b
    hidden_size: int = 4096
    intermediate_size: int = 13696
    num_layers: int = 28
    num_heads: int = 32
    num_kv_heads: int = 2              # chatglm2's multi-query groups
    head_dim: int = 128
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    attention_bias: bool = True

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @staticmethod
    def tiny(**kw) -> "GlmConfig":
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=3,
                    num_heads=4, num_kv_heads=2, head_dim=16)
        base.update(kw)
        return GlmConfig(**base)


def partial_interleaved_rope(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
                             theta: float) -> torch.Tensor:
    """GLM's rotary: adjacent pairs (GPT-J style) of the first ``rotary_dim``
    dims rotated in f32, the rest passed through. x [B, T, H, hd];
    positions [B, T]."""
    half = rotary_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * inv_freq                 # [B, T, half]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    rot = x[..., :rotary_dim].float()
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rot.shape)
    return torch.cat([out.to(x.dtype), x[..., rotary_dim:]], dim=-1)


class GlmAttention(nn.Module):
    def __init__(self, c: GlmConfig):
        super().__init__()
        self.cfg = c
        self.q_proj = nn.Linear(c.hidden_size, c.num_heads * c.head_dim, bias=c.attention_bias)
        self.k_proj = nn.Linear(c.hidden_size, c.num_kv_heads * c.head_dim, bias=c.attention_bias)
        self.v_proj = nn.Linear(c.hidden_size, c.num_kv_heads * c.head_dim, bias=c.attention_bias)
        self.o_proj = nn.Linear(c.num_heads * c.head_dim, c.hidden_size, bias=False)

    def forward(self, x, positions, mask):
        c = self.cfg
        B, T, _ = x.shape
        q = self.q_proj(x).view(B, T, c.num_heads, c.head_dim)
        k = self.k_proj(x).view(B, T, c.num_kv_heads, c.head_dim)
        v = self.v_proj(x).view(B, T, c.num_kv_heads, c.head_dim)
        q = partial_interleaved_rope(q, positions, c.rotary_dim, c.rope_theta)
        k = partial_interleaved_rope(k, positions, c.rotary_dim, c.rope_theta)
        qg = _grouped(q, c.num_kv_heads)                               # [B, T, KV, rep, hd]
        scores = torch.einsum("btgrd,bsgd->bgrts", qg, k).float() / math.sqrt(c.head_dim)
        probs = torch.softmax(scores + mask[:, :, None], dim=-1).to(x.dtype)
        out = torch.einsum("bgrts,bsgd->btgrd", probs, v)
        return self.o_proj(out.reshape(B, T, c.num_heads * c.head_dim))


class GlmMLP(nn.Module):
    def __init__(self, c: GlmConfig):
        super().__init__()
        self.gate_up_proj = nn.Linear(c.hidden_size, 2 * c.intermediate_size, bias=False)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size, bias=False)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(up * F.silu(gate))


class GlmLayer(nn.Module):
    def __init__(self, c: GlmConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_eps)
        self.self_attn = GlmAttention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_eps)
        self.mlp = GlmMLP(c)

    def forward(self, x, positions, mask):
        x = x + self.self_attn(self.input_layernorm(x), positions, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class GlmModel(nn.Module):
    """Decoder trunk; returns ``last_hidden_state`` (after ``norm``) and,
    with ``output_hidden_states``, the embedding output and each layer's
    output, the last one replaced by its normed value (HF's convention).
    Without ``attn_mask``, the mask is causal plus ``pad_mask``'s keys."""

    def __init__(self, cfg: GlmConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GlmLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> dict:
        x = self.embed_tokens(input_ids)
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device)[None].expand(B, T)
        if attn_mask is None:
            keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None]
            if pad_mask is not None:
                keep = keep & pad_mask[:, None, :]
            attn_mask = torch.where(keep, 0.0, NEG_MASK)[:, None]          # [B|1, 1, T, T]
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, positions, attn_mask)
            hidden_states.append(x)
        x = self.norm(x)
        hidden_states[-1] = x
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None}
