"""ALBERT encoder (albert-base/large/xxlarge and the Chinese tiny/small
variants): a text family of the text stage.

The port of ``sdumc_tpu/models/albert.py``: BERT with a factorized
embedding (``embedding_size`` -> ``hidden_size``, ``encoder.
embedding_hidden_mapping_in``) and ONE transformer layer applied
``num_layers`` times. The layer is one module under HF's name
(``encoder.albert_layer_groups.0.albert_layers.0``), so the state dict holds
its tensors once. The key-padding mask is JAX's (-1e30, finite).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.bert import key_masked_attention


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu_new"

    @staticmethod
    def tiny(**kw) -> "AlbertConfig":
        base = dict(vocab_size=99, embedding_size=16, hidden_size=32, num_layers=3,
                    num_heads=4, intermediate_size=64, max_position_embeddings=64)
        base.update(kw)
        return AlbertConfig(**base)


def activation(name: str):
    """HF's activation names as ALBERT's configs use them: ``gelu_new`` and
    ``gelu_python`` are the tanh form, ``gelu`` the exact one."""
    if name in ("gelu_new", "gelu_python"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"hidden_act {name!r}; only gelu_new, gelu_python, gelu and relu")


class _Embeddings(nn.Module):
    def __init__(self, c: AlbertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.embedding_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.embedding_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.embedding_size)
        self.LayerNorm = nn.LayerNorm(c.embedding_size, eps=c.layer_norm_eps)


class _Attention(nn.Module):
    def __init__(self, c: AlbertConfig):
        super().__init__()
        d = c.hidden_size
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=c.layer_norm_eps)


class AlbertLayer(nn.Module):
    def __init__(self, c: AlbertConfig):
        super().__init__()
        self.heads = c.num_heads
        self.act = activation(c.hidden_act)
        self.attention = _Attention(c)
        self.ffn = nn.Linear(c.hidden_size, c.intermediate_size)
        self.ffn_output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.full_layer_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x, pad_mask=None):
        B, T, D = x.shape
        a = self.attention
        shape = (B, T, self.heads, D // self.heads)
        h = key_masked_attention(a.query(x).view(shape), a.key(x).view(shape),
                                 a.value(x).view(shape), pad_mask)
        x = a.LayerNorm(x + a.dense(h))
        h = self.ffn_output(self.act(self.ffn(x)))
        return self.full_layer_layer_norm(x + h)


class _Group(nn.Module):
    def __init__(self, c: AlbertConfig):
        super().__init__()
        self.albert_layers = nn.ModuleList([AlbertLayer(c)])


class _Encoder(nn.Module):
    def __init__(self, c: AlbertConfig):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(c.embedding_size, c.hidden_size)
        self.albert_layer_groups = nn.ModuleList([_Group(c)])


class AlbertModel(nn.Module):
    """Returns ``last_hidden_state`` and, with ``output_hidden_states``, the
    projected embedding output followed by each application of the shared
    layer."""

    def __init__(self, cfg: AlbertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> dict:
        e = self.embeddings
        B, T = input_ids.shape
        positions = torch.arange(T, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = e.LayerNorm(e.word_embeddings(input_ids) + e.position_embeddings(positions)
                        + e.token_type_embeddings(token_type_ids))
        x = self.encoder.embedding_hidden_mapping_in(x)
        shared = self.encoder.albert_layer_groups[0].albert_layers[0]
        hidden_states = [x]
        for _ in range(self.cfg.num_layers):
            x = shared(x, pad_mask)
            hidden_states.append(x)
        return {"last_hidden_state": x,
                "hidden_states": tuple(hidden_states) if output_hidden_states else None}
