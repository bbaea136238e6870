"""The layers of a tensor-parallel model: each holds a rank's slice of one
weight and places the collective that makes its output whole
(``parallel/sharding.py`` says which weights split).

* ``GatheredEmbedding``: a hidden slice of an embedding; the lookup is
  gathered along the last dimension.
* ``GatheredLinear``: an output slice of a Linear (``lm_head``'s
  vocabulary); the product is gathered along the last dimension.
* ``RowParallelLinear``: an input slice of a Linear (``o_proj``,
  ``down_proj``, WavLM's ``out_proj`` and ``output_dense``); the partial
  products are summed over the ranks, then the bias, whole on every rank,
  is added once (added before the sum, it would count world times).

A row-split product of half-precision operands is accumulated in f32 and
summed over the ranks in f32, then rounded once: one process's GEMM
accumulates its f32 sum over the whole input and rounds once, so the split
differs from it only in the order of f32 additions (rounding each rank's
partial first would add up to a bf16 ulp a rank).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.parallel.mesh import HALF, ModelAxis


def f32_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T, f32 and unrounded: for half-precision operands, one
    cuBLAS GEMM with an f32 output on the card (``torch.mm`` with
    ``out_dtype``); the widened operands' f32 product on the CPU."""
    if x.dtype not in HALF:
        return F.linear(x, weight)
    if x.device.type != "cuda":
        return F.linear(x.float(), weight.float())
    flat = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(), out_dtype=torch.float32)
    return flat.view(*x.shape[:-1], weight.shape[0])


class GatheredEmbedding(nn.Embedding):
    """A rank's columns of an embedding (a hidden slice); the lookup is
    gathered along the last dimension: the whole embedding on every rank."""

    def __init__(self, num: int, dim: int, axis: ModelAxis, dtype=None, device=None):
        super().__init__(num, dim, dtype=dtype, device=device)
        self.axis = axis

    def forward(self, ids):
        return self.axis.gather_last(super().forward(ids))


class GatheredLinear(nn.Linear):
    """A rank's output rows of a bias-free Linear; the product is gathered
    along the last dimension."""

    def __init__(self, d_in: int, d_out: int, axis: ModelAxis, dtype=None, device=None):
        super().__init__(d_in, d_out, bias=False, dtype=dtype, device=device)
        self.axis = axis

    def forward(self, x):
        return self.axis.gather_last(super().forward(x))


class RowParallelLinear(nn.Linear):
    """A rank's input columns of a Linear (its weight's columns): the
    partial products (``f32_product``) summed over the ranks and rounded to
    x's dtype once, then the bias added (in x's dtype: a bf16 product is
    rounded before its bias, as the models' bf16 Linears round)."""

    def __init__(self, d_in: int, d_out: int, axis: ModelAxis, bias: bool = False, dtype=None,
                 device=None):
        super().__init__(d_in, d_out, bias=bias, dtype=dtype, device=device)
        self.axis = axis

    def forward(self, x):
        out = self.axis.all_reduce(f32_product(x, self.weight)).to(x.dtype)
        return out if self.bias is None else out + self.bias
