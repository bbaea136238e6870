"""BLOOM decoder (bloom-7b1): the ALiBi-attention LLM of the text stage.

The port of ``sdumc_tpu/models/bloom.py``, under HF's ``BloomModel``
state-dict names (``word_embeddings``, ``h.{i}.self_attention.
query_key_value``, ``ln_f``, ...):

  word embeddings -> embedding LayerNorm -> N pre-LN layers of fused-QKV
  attention with ALiBi's additive slopes (no position embeddings) and a
  tanh-gelu MLP -> final LayerNorm, which replaces the last hidden state.

The fused QKV [3D, D] orders its outputs per head (h: q, k, v), as HF
stores it. ALiBi's position of a key is the cumulative sum of the pad mask
minus 1 (0 at pad keys); the scores take it in f32, then the causal plus
key-padding mask, additive at -1e30 (finite: a row of length 0 is uniform).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_MASK = -1e30


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 4096
    num_layers: int = 30
    num_heads: int = 32
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw) -> "BloomConfig":
        base = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4)
        base.update(kw)
        return BloomConfig(**base)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """HF ``build_alibi_tensor``'s slopes [H] f32: a geometric series over
    the largest power of two of heads, then every other slope of the next
    power's series for the rest."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, num_heads - closest)
        slopes += [extra_base ** (2 * i + 1) for i in range(n_extra)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def build_alibi(pad_mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T] attend-mask -> [B, H, 1, T] additive bias: slope times the
    key's position, the cumulative sum of the mask minus 1 (0 at masked
    keys, which the attention mask excludes anyway)."""
    m = pad_mask.float()
    positions = (torch.cumsum(m, dim=-1) - 1.0) * m
    return alibi_slopes(num_heads, pad_mask.device)[None, :, None, None] * positions[:, None, None, :]


class _SelfAttention(nn.Module):
    def __init__(self, c: BloomConfig):
        super().__init__()
        self.cfg = c
        self.query_key_value = nn.Linear(c.hidden_size, 3 * c.hidden_size)
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x, alibi, attn_mask):
        c = self.cfg
        B, T, D = x.shape
        q, k, v = self.query_key_value(x).view(B, T, c.num_heads, 3, c.head_dim).unbind(3)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(c.head_dim)
        scores = scores.float() + alibi + attn_mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return self.dense(torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D))


class _MLP(nn.Module):
    def __init__(self, c: BloomConfig):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(c.hidden_size, 4 * c.hidden_size)
        self.dense_4h_to_h = nn.Linear(4 * c.hidden_size, c.hidden_size)

    def forward(self, x):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x), approximate="tanh"))


class BloomBlock(nn.Module):
    def __init__(self, c: BloomConfig):
        super().__init__()
        self.input_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attention = _SelfAttention(c)
        self.post_attention_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = _MLP(c)

    def forward(self, x, alibi, attn_mask):
        x = x + self.self_attention(self.input_layernorm(x), alibi, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class BloomModel(nn.Module):
    """Returns ``last_hidden_state`` (after ``ln_f``) and, with
    ``output_hidden_states``, the embedding output and each layer's output,
    the last one replaced by its ``ln_f`` value (HF's convention)."""

    def __init__(self, cfg: BloomConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.word_embeddings_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.h = nn.ModuleList(BloomBlock(cfg) for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> dict:
        B, T = input_ids.shape
        dev = input_ids.device
        if pad_mask is None:
            pad_mask = torch.ones(B, T, dtype=torch.bool, device=dev)
        x = self.word_embeddings_layernorm(self.word_embeddings(input_ids))
        alibi = build_alibi(pad_mask, self.cfg.num_heads)
        causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        attn_mask = torch.where(causal[None] & pad_mask[:, None, :], 0.0, NEG_MASK)[:, None]
        hidden_states = [x]
        for block in self.h:
            x = block(x, alibi, attn_mask)
            hidden_states.append(x)
        x = self.ln_f(x)
        hidden_states[-1] = x
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None}
