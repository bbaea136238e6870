"""Layers with flax.linen's parameters and default initialisers.

The baseline families have no reference torch code: the JAX package is
their spec, so their layers here hold exactly flax's trainable tensors and
draw them from flax's distributions (not its draws), from an explicit
``torch.Generator``:

- ``Dense``: a kernel from ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan_in) and a zero bias;
- ``Conv1dSame``: flax's ``Conv(padding="SAME")`` over [B, T, C], the same
  initialisers with fan_in = K * C, the padding (K - 1) // 2 before and
  the rest after (asymmetric for an even K);
- ``LayerNorm``: flax's epsilon 1e-6 (torch's default is 1e-5);
- ``LSTMCell``: flax's ``LSTMCell`` / ``OptimizedLSTMCell``: the input
  Denses ``ii/if/ig/io`` without bias, the hidden ones ``hi/hf/hg/ho`` with
  bias and orthogonal kernels; the carry is ``(c, h)``;
- ``GRUCell``: flax's ``GRUCell``: ``ir/iz/in`` with bias, ``hr/hz``
  without, ``hn`` with, ``n = tanh(in(x) + r * hn(h))``;
- ``xavier_uniform_`` with flax's fans (the last two axes, the rest a
  receptive field).

Every Dense computes in f32: an input of another dtype (bf16 streams) is
widened first, as flax promotes it to its f32 parameters. The cells take
their input products for a whole sequence in one product
(``input_gates``), and one hidden product a step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_uniform_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's ``xavier_uniform`` on a flax-layout array: fan_in = shape[-2],
    fan_out = shape[-1], each times the product of the other axes."""
    receptive = math.prod(w.shape[:-2])
    fan_in, fan_out = w.shape[-2] * receptive, w.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` [out, in] is the kernel transposed."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, orthogonal: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        if orthogonal:
            with torch.no_grad():
                nn.init.orthogonal_(self.weight, generator=generator)
        else:
            lecun_normal_(self.weight, in_features, generator)

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv1dSame(nn.Module):
    """flax ``nn.Conv(features, (K,), padding="SAME")`` on [B, T, C] ->
    [B, T, features]; ``weight`` [out, in, K] is the kernel [K, in, out]
    transposed."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        lecun_normal_(self.weight, in_channels * kernel_size, generator)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)

    def forward(self, x):
        x = F.pad(x.to(self.weight.dtype).transpose(1, 2), self.pad)
        return F.conv1d(x, self.weight, self.bias).transpose(1, 2)


def LayerNorm(dim: int) -> nn.LayerNorm:
    """flax ``nn.LayerNorm``: scale (``weight``) ones, bias zeros, eps 1e-6."""
    return nn.LayerNorm(dim, eps=1e-6)


class LSTMCell(nn.Module):
    """flax ``LSTMCell`` / ``OptimizedLSTMCell`` (the same parameters and
    arithmetic): i, f, o sigmoid gates, g tanh, ``c' = f c + i g``,
    ``h' = o tanh(c')``."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        for g in self.GATES:
            self.add_module("i" + g, Dense(in_dim, hidden, bias=False, generator=generator))
        for g in self.GATES:
            self.add_module("h" + g, Dense(hidden, hidden, generator=generator, orthogonal=True))

    def _cat(self, side: str, leaf: str):
        return torch.cat([getattr(self._modules[side + g], leaf) for g in self.GATES])

    def input_gates(self, x):
        """x [..., in] -> the four input products [..., 4h]."""
        return F.linear(x.to(self.ii.weight.dtype), self._cat("i", "weight"))

    def hidden_params(self):
        return self._cat("h", "weight"), self._cat("h", "bias")

    def step(self, gx, carry, params):
        """One step from the input products ``gx`` [B, 4h] and the carry
        (c, h); returns the new (c, h)."""
        c, h = carry
        i, f, g, o = (gx + F.linear(h, *params)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def zeros(self, batch: int, like: torch.Tensor):
        z = like.new_zeros(batch, self.hidden)
        return z, z

    def scan(self, x, reverse: bool = False):
        """flax ``nn.RNN(cell, reverse=reverse)`` without ``seq_lengths``
        over x [B, T, in] from a zero carry: the outputs h [B, T, h] in the
        order they were computed (for ``reverse``, from the last frame)."""
        gx = self.input_gates(x)
        params = self.hidden_params()
        carry = self.zeros(x.shape[0], gx)
        out = []
        for t in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
            carry = self.step(gx[:, t], carry, params)
            out.append(carry[1])
        return torch.stack(out, dim=1)


class GRUCell(nn.Module):
    """flax ``GRUCell``: ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r * hn(h))``, ``h' = (1 - z) n + z h``."""

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        for g in ("r", "z", "n"):
            self.add_module("i" + g, Dense(in_dim, hidden, generator=generator))
        for g in ("r", "z", "n"):
            self.add_module("h" + g, Dense(hidden, hidden, bias=g == "n", generator=generator,
                                           orthogonal=True))

    def input_gates(self, x):
        """x [..., in] -> the three input products with their biases [..., 3h]."""
        m = self._modules
        return F.linear(x.to(self.ir.weight.dtype),
                        torch.cat([m["ir"].weight, m["iz"].weight, m["in"].weight]),
                        torch.cat([m["ir"].bias, m["iz"].bias, m["in"].bias]))

    def hidden_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self._modules
        return torch.cat([m["hr"].weight, m["hz"].weight, m["hn"].weight]), m["hn"].bias

    def step(self, gx, h, params):
        w, b_n = params
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = F.linear(h, w).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + b_n))
        return (1.0 - z) * n + z * h

    def scan(self, x):
        """flax ``nn.RNN(cell)`` over x [B, T, in] from a zero carry: the
        outputs [B, T, h]."""
        gx = self.input_gates(x)
        params = self.hidden_params()
        h = gx.new_zeros(x.shape[0], self.hidden)
        out = []
        for t in range(x.shape[1]):
            h = self.step(gx[:, t], h, params)
            out.append(h)
        return torch.stack(out, dim=1)
