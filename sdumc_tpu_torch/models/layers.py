"""Shared building blocks with torch-default initialisation.

Both weight and bias draw from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which is
what torch's ``kaiming_uniform_(a=sqrt(5))`` reduces to; the draws come
from an explicit ``torch.Generator`` so a seed fixes the weights.
Modules are built on the CPU and moved to their device afterwards, so one
seed gives the same weights on every device. The dropouts draw from an
explicit generator too (``use_generator``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear whose init draws from `generator`.

    ``forward(x, dtype)`` computes in ``dtype`` when one is given (the bf16
    frame streams): the parameters stay f32 and are cast per call, and the
    product is rounded to ``dtype`` before the bias is added, as flax's
    ``Dense(dtype=...)`` rounds (a fused bias would round once, and part
    from it); ``dtype=None`` is nn.Linear."""

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

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        if dtype is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


class Draws(nn.Module):
    """A parameterless module whose random draws come from an explicit
    ``torch.Generator``, never from torch's global stream: the train step
    seeds one generator per step from (seed, step) and hands it to every
    such module of the model (``use_generator``), so a resumed run draws
    the same values.

    ``batch_wide`` marks draws that belong to the whole batch, not to its
    rows (MFM's prior samples, MCTN's teacher-forcing mask): a
    data-parallel step gives them a generator that every rank seeds alike,
    where each rank's dropout masks come from a stream of its own."""

    def __init__(self, batch_wide: bool = False):
        super().__init__()
        self.batch_wide = batch_wide
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError("a draw in training mode comes from the train step's "
                               "generator; set one with models.layers.use_generator")
        return self.generator

    def normal(self, shape, dtype=torch.float32):
        """Standard normal values of `shape` on the generator's device."""
        g = self._generator()
        return torch.randn(shape, generator=g, device=g.device, dtype=dtype)

    def uniform(self, shape):
        """U[0, 1) f32 values of `shape` on the generator's device."""
        g = self._generator()
        return torch.rand(shape, generator=g, device=g.device)


class _RandomDrop(Draws):
    """Dropout on the explicit generator (``Draws``). The identity in eval
    mode and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate <= 0:
            return x
        if self.rate >= 1:
            return x * 0.0                  # zeros, with a zero (finite) gradient
        self._generator()
        keep, keep_p = self._keep(x)
        scale = 1.0 / keep_p
        if x.dtype != torch.float32:     # scale in x's dtype, as the JAX layers do
            scale = torch.tensor(scale, dtype=x.dtype).item()
        return torch.where(keep, x * scale, 0.0)

    def _keep(self, x):
        """(bool keep mask shaped like x, probability of keeping)."""
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return u >= self.rate, 1.0 - self.rate


class Dropout(_RandomDrop):
    """nn.Dropout's semantics (keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate)) on the explicit generator. Parameterless, so
    it takes nn.Dropout's place without moving state_dict keys."""


class FrameDropout(_RandomDrop):
    """Dropout on the [B, T, d] frame streams, drawn as one byte per value.

    The rate is quantised to k/256 with k = round(rate * 256): a value is
    kept where its random byte is >= k and scaled by 1 / (1 - k/256), the
    exact keep probability, so the expectation is unbiased. The live rate
    0.5 is exact (k = 128). A rate in (0, 1/512), where k would be 0, drops
    at its exact rate through a float draw instead of becoming the
    identity; rate 1 gives zeros with a zero gradient."""

    def _keep(self, x):
        k = int(round(self.rate * 256))
        if k == 0 or k >= 256:
            return super()._keep(x)
        bits = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        bits.random_(generator=self.generator)
        return bits >= k, 1.0 - k / 256.0


def use_generator(model: nn.Module, generator: Optional[torch.Generator],
                  batch_generator: Optional[torch.Generator] = None) -> None:
    """Point every dropout and every other ``Draws`` of `model` at `generator`,
    and the batch-wide ones at `batch_generator` where one is given."""
    for m in model.modules():
        if isinstance(m, Draws):
            m.generator = (batch_generator if m.batch_wide and batch_generator is not None
                           else generator)


def MLP(in_dim: int, layer_dims: Sequence[int], dropout: float = 0.3,
        generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[Linear -> ReLU -> Dropout]* (reference ``MLP``): Linears sit at
    indices 0, 3, 6, ... as in the reference state_dict."""
    mods = []
    for dim in layer_dims:
        mods += [Linear(in_dim, dim, generator), nn.ReLU(), Dropout(dropout)]
        in_dim = dim
    return nn.Sequential(*mods)
