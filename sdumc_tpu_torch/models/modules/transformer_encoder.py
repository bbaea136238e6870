"""Cross-modal transformer encoder and the small encoders of the baselines.

The port of ``sdumc_tpu/models/modules/transformer_encoder.py`` (the
fairseq-lineage MulT encoder, rebuilt with pre-LN blocks, one attention
product and optional K/V from a second modality), with flax's parameters
and initialisers (``linen.py``). The attention is two plain products and a
softmax: no kernel of the port lies on it.

A torch module is built before it is called, so the encoder is told at
construction whether it takes a second (K/V) stream (``cross``): only then
has it the ``ln_kv_{i}`` norms, as the flax module creates them only when
called with ``x_kv``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sdumc_tpu_torch.models.layers import Dropout
from sdumc_tpu_torch.models.modules.linen import Dense, LayerNorm, LSTMCell


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """[length, dim] f32 table, fairseq's sin | cos halves, a zero column for
    an odd dim."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1) if half > 1 else 1.0
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device) * -emb)
    args = torch.arange(length, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    table = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, table.new_zeros(length, 1)], dim=1)
    return table


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dropout: float = 0.0, generator=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim, generator=generator))
        self.drop = Dropout(dropout)

    def forward(self, q, kv, mask=None):
        B, Tq, _ = q.shape
        Tk = kv.shape[1]
        h, hd = self.heads, self.dim // self.heads
        qp = self.q_proj(q).reshape(B, Tq, h, hd).transpose(1, 2)
        kp = self.k_proj(kv).reshape(B, Tk, h, hd).transpose(1, 2)
        vp = self.v_proj(kv).reshape(B, Tk, h, hd).transpose(1, 2)
        scores = qp @ kp.transpose(-1, -2) / math.sqrt(hd)            # [B, h, Tq, Tk]
        if mask is not None:
            scores = torch.where(mask, scores, -1e30)
        probs = self.drop(torch.softmax(scores, dim=-1))
        out = (probs @ vp).transpose(1, 2).reshape(B, Tq, self.dim)
        return self.out_proj(out)


class CrossModalTransformerEncoder(nn.Module):
    """Pre-LN blocks; queries from ``x``, keys and values from ``x_kv``
    (``cross``) or from ``x``; optionally causal (a mask at -1e30)."""

    def __init__(self, dim: int, layers: int, heads: int = 8, ffn_mult: int = 4,
                 dropout: float = 0.0, causal: bool = False, scale_embeds: bool = True,
                 cross: bool = False, generator=None):
        super().__init__()
        self.dim, self.layers, self.causal, self.cross = dim, layers, causal, cross
        self.scale = math.sqrt(dim) if scale_embeds else 1.0
        for i in range(layers):
            self.add_module(f"ln1_{i}", LayerNorm(dim))
            if cross:
                self.add_module(f"ln_kv_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", _Attention(dim, heads, dropout, generator))
            self.add_module(f"ln2_{i}", LayerNorm(dim))
            self.add_module(f"fc1_{i}", Dense(dim, dim * ffn_mult, generator=generator))
            self.add_module(f"fc2_{i}", Dense(dim * ffn_mult, dim, generator=generator))
        self.ln_final = LayerNorm(dim)
        self.drop = Dropout(dropout)

    def forward(self, x, x_kv: Optional[torch.Tensor] = None):
        if (x_kv is not None) != self.cross:
            raise ValueError(f"this encoder was built with cross={self.cross}")
        m = self._modules
        x = x * self.scale + sinusoidal_positions(x.shape[1], self.dim, x.device)[None]
        if x_kv is not None:
            x_kv = x_kv * self.scale + sinusoidal_positions(x_kv.shape[1], self.dim,
                                                            x.device)[None]
        x = self.drop(x)
        mask = None
        if self.causal and x_kv is None:
            T = x.shape[1]
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None, None]
        for i in range(self.layers):
            h = m[f"ln1_{i}"](x)
            kv = m[f"ln_kv_{i}"](x_kv) if x_kv is not None else h
            x = x + self.drop(m[f"attn_{i}"](h, kv, mask))
            h = torch.relu(m[f"fc1_{i}"](m[f"ln2_{i}"](x)))
            x = x + self.drop(m[f"fc2_{i}"](self.drop(h)))
        return self.ln_final(x)


class MLPEncoder(nn.Module):
    """Utterance-level MLP encoder: fc1, ReLU, dropout, fc2, ReLU."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, dropout: float = 0.3,
                 generator=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden, generator=generator)
        self.fc2 = Dense(hidden, out_dim, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return torch.relu(self.fc2(self.drop(torch.relu(self.fc1(x)))))


class LSTMEncoder(nn.Module):
    """Frame-level bidirectional LSTM -> [forward's last output, backward's
    first output] -> dropout -> Dense -> ReLU. The backward direction runs
    over the whole padded sequence from its last frame, and its outputs stay
    in the order it computed them (flax's ``nn.RNN(reverse=True)`` without
    ``seq_lengths`` or ``keep_order``), so ``bwd[:, 0]`` is its output
    after the last frame alone."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, dropout: float = 0.3,
                 generator=None):
        super().__init__()
        self.fwd = LSTMCell(in_dim, hidden, generator)
        self.bwd = LSTMCell(in_dim, hidden, generator)
        self.out = Dense(2 * hidden, out_dim, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x):
        fwd = self.fwd.scan(x)
        bwd = self.bwd.scan(x, reverse=True)
        last = torch.cat([fwd[:, -1], bwd[:, 0]], dim=-1)
        return torch.relu(self.out(self.drop(last)))
