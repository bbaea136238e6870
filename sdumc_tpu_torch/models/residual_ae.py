"""Residual fully-connected autoencoder (the "imagination" module).

The live model constructs two of these, so their parameters exist in the
released checkpoint, but the reference's missing-modality substitution that
calls them is commented out; the substitution is gated by
``ModelConfig.use_imagination``.

Layer stripping as in the reference: the encoder drops its final
activation and dropout; the decoder puts ReLU and dropout between all but
the last linear. Submodule names follow the reference state_dict
(``transition.0/.2``, ``encoder_N.0/.3/..``, ``decoder_N.0/.3/..``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sdumc_tpu_torch.models.layers import Dropout, Linear


class ResidualAE(nn.Module):
    def __init__(self, layers: Sequence[int], n_blocks: int, input_dim: int,
                 stream_dim: int, dropout: float = 0.3,
                 generator: Optional[torch.Generator] = None):
        """`stream_dim` is the width of each of the three inputs; the output
        (decoder + x_t) has width `input_dim`, which must equal it."""
        super().__init__()
        self.n_blocks = n_blocks
        self.transition = nn.Sequential(
            Linear(3 * stream_dim, input_dim, generator), nn.ReLU(),
            Linear(input_dim, input_dim, generator))
        for blk in range(n_blocks):
            enc, d_in = [], input_dim
            for i, dim in enumerate(layers):
                enc.append(Linear(d_in, dim, generator))
                if i < len(layers) - 1:
                    enc += [nn.LeakyReLU(0.01), Dropout(dropout)]
                d_in = dim
            dec = []
            for i, dim in enumerate(list(reversed(list(layers)))[1:] + [input_dim]):
                if i > 0:
                    dec += [nn.ReLU(), Dropout(dropout)]
                dec.append(Linear(d_in, dim, generator))
                d_in = dim
            setattr(self, f"encoder_{blk}", nn.Sequential(*enc))
            setattr(self, f"decoder_{blk}", nn.Sequential(*dec))

    def forward(self, x_a, x_t, x_v):
        x_out = self.transition(torch.cat([x_a, x_t, x_v], dim=-1))
        for blk in range(self.n_blocks):
            latent = getattr(self, f"encoder_{blk}")(x_out)
            x_out = getattr(self, f"decoder_{blk}")(latent) + x_t
        return x_out
