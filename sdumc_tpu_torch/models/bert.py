"""BERT-family bidirectional encoder (BERT, RoBERTa, MacBERT, SimBERT): a
text family of the text stage.

The port of ``sdumc_tpu/models/bert.py``. Submodules carry HF's
``BertModel`` state-dict names (``embeddings.word_embeddings``,
``encoder.layer.{i}.attention.self.query``, ...), so an HF checkpoint loads
as a state dict (``convert/hf_bert.py``):

  word + position + token-type embeddings -> LN
  -> N post-LN layers of (MHA -> add & LN -> exact gelu MLP -> add & LN)

RoBERTa differs only in its position offset (pad_token_id + 1). Token types
are zeros; the pooler is not built (the stage reads hidden states only).
The key-padding mask replaces masked scores with -1e30, as JAX does: it is
finite, so a row of length 0 (the padded tail of a batch) gets a uniform
softmax, not NaN. Scores and softmax are f32, as the whole family is.
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
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    position_offset: int = 0          # roberta: pad_token_id + 1 = 2

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        base = dict(vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position_embeddings=64)
        base.update(kw)
        return BertConfig(**base)


def key_masked_attention(q, k, v, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax attention with masked keys' scores replaced by -1e30.
    q, k, v [B, T, H, hd]; keep [B, T] bool (True = attend) or None.
    Returns [B, T, H * hd]."""
    B, T, H, hd = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    if keep is not None:
        scores = torch.where(keep[:, None, None, :], scores, NEG_MASK)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * hd)


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)


class _DenseLN(nn.Module):
    """``dense`` then ``LayerNorm`` of the residual sum (HF's
    ``*Output`` modules)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseLN(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.heads = c.num_heads
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, x, pad_mask=None):
        B, T, D = x.shape
        a = self.attention.self
        shape = (B, T, self.heads, D // self.heads)
        h = key_masked_attention(a.query(x).view(shape), a.key(x).view(shape),
                                 a.value(x).view(shape), pad_mask)
        x = self.attention.output(h, x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_layers))


class BertModel(nn.Module):
    """Returns ``last_hidden_state`` and, with ``output_hidden_states``, the
    per-layer hidden states (HF convention: entry 0 is the embedding
    output; post-LN means no final norm)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> dict:
        c, e = self.cfg, self.embeddings
        B, T = input_ids.shape
        positions = torch.arange(T, device=input_ids.device)[None] + c.position_offset
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = e.LayerNorm(e.word_embeddings(input_ids) + e.position_embeddings(positions)
                        + e.token_type_embeddings(token_type_ids))
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
            hidden_states.append(x)
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None}
