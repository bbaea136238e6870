"""The arithmetic of the plain references: true f32, or TF32 for the control.

Every product of a reference (a matmul, an einsum, a convolution) goes
through a ``Precision``. ``f32`` computes it in float32 with TF32 off.
``tf32`` rounds both operands to TF32 (10 stored mantissa bits, to nearest
even) and multiplies the rounded values in float32: a product of two
11-bit significands is exact in float32, so this is what a TF32 tensor core
computes, on the CPU as on the card; a gradient passes the rounding
unchanged, so a backward product multiplies the rounded operands of its
forward. It is the control: the nearest precision below the f32 that the
configurations state.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits; the
    gradient passes through unchanged."""
    bits = t.detach().float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach() if t.requires_grad else rounded


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuBLAS and cuDNN inside, restored on exit."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


class Precision:
    """The products of a reference in ``f32`` or ``tf32``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision f32 or tf32, got {name!r}")
        self.name = name

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self.name == "tf32" else t

    def linear(self, x, weight, bias=None):
        out = F.linear(self._r(x), self._r(weight))
        return out if bias is None else out + bias

    def einsum(self, eq: str, *ops):
        return torch.einsum(eq, *(self._r(o) for o in ops))

    def conv1d(self, x, weight, bias=None, stride: int = 1, padding: int = 0, groups: int = 1):
        return F.conv1d(self._r(x), self._r(weight), bias, stride=stride, padding=padding,
                        groups=groups)
