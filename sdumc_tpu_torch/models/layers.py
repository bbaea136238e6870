"""Shared building blocks with torch-default initialisation.

Both weight and bias draw from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which is
what torch's ``kaiming_uniform_(a=sqrt(5))`` reduces to; the draws come
from an explicit ``torch.Generator`` so a seed fixes the weights.
Modules are built on the CPU and moved to their device afterwards, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Linear(nn.Linear):
    """nn.Linear whose init draws from `generator`."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class FrameDropout(nn.Module):
    """Dropout on the [B, T, d] frame streams: the identity in eval.

    The training form (rate quantised to k/256, kept values scaled by
    1/(1 - k/256)) is not ported yet, so a training forward raises rather
    than silently using another dropout."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.training and self.rate > 0:
            raise NotImplementedError(
                "FrameDropout's training form is not ported yet; call "
                "model.eval() for inference")
        return x


def MLP(in_dim: int, layer_dims: Sequence[int], dropout: float = 0.3,
        generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[Linear -> ReLU -> Dropout]* (reference ``MLP``): Linears sit at
    indices 0, 3, 6, ... as in the reference state_dict."""
    mods = []
    for dim in layer_dims:
        mods += [Linear(in_dim, dim, generator), nn.ReLU(), nn.Dropout(dropout)]
        in_dim = dim
    return nn.Sequential(*mods)
