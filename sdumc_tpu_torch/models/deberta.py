"""DeBERTa (v1) encoder with disentangled attention: a text family of the
text stage (deberta-base/large and the Chinese deberta-large).

The port of ``sdumc_tpu/models/deberta.py``, under HF's ``DebertaModel``
state-dict names (``encoder.layer.{i}.attention.self.in_proj``,
``encoder.rel_embeddings``, ...):

  word embeddings (+ absolute positions if ``position_biased_input``, +
  token types if ``type_vocab_size > 0``) -> LN -> pad rows zeroed
  -> N post-LN layers of disentangled attention and an exact-gelu MLP,
     with one relative-position table [2 * max_rel, D] shared by all:
       score[t, s] = q[t]/c . k[s]                       content->content
                   + q[t]/c . pos_k[d(t, s)]             c2p
                   + k[s] . pos_q[d(t, s)]/c             p2c
     d(t, s) = clamp(t - s + span, 0, 2 span - 1), span = min(T, max_rel),
     c = sqrt(hd * (1 + len(pos_att_type))).

The fused ``in_proj`` [3D, D] has no bias and orders its outputs per head
(h: q, k, v), as HF's ``transpose_for_scores`` reads it; ``q_bias`` and
``v_bias`` are added after the split. A score is kept where its query AND
its key are valid, else replaced by float32's min (JAX's mask; finite, so
a row of length 0 is uniform, not NaN).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.bert import _DenseLN, _Intermediate


@dataclasses.dataclass(frozen=True)
class DebertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    max_relative_positions: int = 512   # = max_position_embeddings when -1
    type_vocab_size: int = 0
    position_biased_input: bool = False
    pos_att_type: Tuple[str, ...] = ("c2p", "p2c")   # the released checkpoints' setting
    layer_norm_eps: float = 1e-7

    @staticmethod
    def tiny(**kw) -> "DebertaConfig":
        base = dict(vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position_embeddings=64,
                    max_relative_positions=16)
        base.update(kw)
        return DebertaConfig(**base)


class _Embeddings(nn.Module):
    def __init__(self, c: DebertaConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        if c.position_biased_input:
            self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        if c.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class DisentangledSelfAttention(nn.Module):
    def __init__(self, c: DebertaConfig):
        super().__init__()
        d = c.hidden_size
        self.cfg = c
        self.in_proj = nn.Linear(d, 3 * d, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(d))
        self.v_bias = nn.Parameter(torch.zeros(d))
        if "c2p" in c.pos_att_type:
            self.pos_proj = nn.Linear(d, d, bias=False)
        if "p2c" in c.pos_att_type:
            self.pos_q_proj = nn.Linear(d, d)

    def forward(self, x, rel_embed, valid):
        """x [B, T, D]; rel_embed [2 max_rel, D]; valid [B, T] bool."""
        c = self.cfg
        B, T, D = x.shape
        H = c.num_heads
        hd = D // H
        scale = math.sqrt(hd * (1 + len(c.pos_att_type)))
        q, k, v = self.in_proj(x).view(B, T, H, 3, hd).unbind(3)
        q = (q + self.q_bias.view(H, hd)) / scale
        v = v + self.v_bias.view(H, hd)
        scores = torch.einsum("bthd,bshd->bhts", q, k).float()

        if c.pos_att_type:
            span = min(T, c.max_relative_positions)
            rel_slice = rel_embed[c.max_relative_positions - span: c.max_relative_positions + span]
            pos = torch.arange(T, device=x.device)
            idx = (pos[:, None] - pos[None, :] + span).clamp(0, 2 * span - 1)   # [T, T]
            if "c2p" in c.pos_att_type:
                pos_k = self.pos_proj(rel_slice).view(2 * span, H, hd)
                c2p = torch.einsum("bthd,mhd->bhtm", q, pos_k)
                scores = scores + torch.gather(c2p, -1, idx.expand(B, H, T, T)).float()
            if "p2c" in c.pos_att_type:
                pos_q = (self.pos_q_proj(rel_slice) / scale).view(2 * span, H, hd)
                p2c = torch.einsum("bshd,mhd->bhsm", k, pos_q)
                p2c = torch.gather(p2c, -1, idx.T.expand(B, H, T, T))
                scores = scores + p2c.transpose(-1, -2).float()

        ok = valid[:, None, :, None] & valid[:, None, None, :]        # query AND key
        scores = torch.where(ok, scores, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)


class _Attention(nn.Module):
    def __init__(self, c: DebertaConfig):
        super().__init__()
        self.self = DisentangledSelfAttention(c)
        self.output = _DenseLN(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class DebertaLayer(nn.Module):
    def __init__(self, c: DebertaConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, x, rel_embed, valid):
        x = self.attention.output(self.attention.self(x, rel_embed, valid), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _Encoder(nn.Module):
    def __init__(self, c: DebertaConfig):
        super().__init__()
        self.rel_embeddings = nn.Embedding(2 * c.max_relative_positions, c.hidden_size)
        self.layer = nn.ModuleList(DebertaLayer(c) for _ in range(c.num_layers))


class DebertaModel(nn.Module):
    """Returns ``last_hidden_state`` and, with ``output_hidden_states``, the
    embedding output (pad rows zeroed) followed by each layer's output."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> dict:
        c, e = self.cfg, self.embeddings
        B, T = input_ids.shape
        if pad_mask is None:
            pad_mask = torch.ones(B, T, dtype=torch.bool, device=input_ids.device)
        x = e.word_embeddings(input_ids)
        if c.position_biased_input:
            x = x + e.position_embeddings(torch.arange(T, device=x.device))[None]
        if c.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + e.token_type_embeddings(token_type_ids)
        x = e.LayerNorm(x) * pad_mask[:, :, None].to(x.dtype)       # HF zeroes pad rows
        rel_embed = self.encoder.rel_embeddings.weight
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, rel_embed, pad_mask)
            hidden_states.append(x)
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None}
