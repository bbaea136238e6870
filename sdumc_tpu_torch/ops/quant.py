"""Int8 weights for the decode-bound feat4 graphs.

The port of ``sdumc_tpu/ops/quant.py``. Symmetric per-output-channel int8:

    q = clip(round(w / s), -127, 127),  s[out] = max |w| over the input axis / 127

The port keeps torch's Linear layout, ``weight [out, in]``, so the scale
reduces over the LAST axis (the JAX kernel is ``[in, out]`` and reduces over
axis -2); the codes and scales are the same numbers, transposed.

``QuantLinear`` runs in one of two modes, as JAX's ``QuantDense`` does:

* ``"int8"`` (weight-only): the codes are converted to the model dtype and
  the matmul runs there; the channel scale multiplies the result.
* ``"w8a8"``: activations are quantized per row (dynamic, symmetric int8),
  the product is int8 x int8 -> int32, then rescaled by act_scale x
  kernel_scale in f32. On CUDA the int32 product is ``torch._int_mm``
  (cuBLASLt), which takes more than 16 rows and K, N multiples of 8: decode
  at ``--gen_batch 4`` has C*B = 16 rows, so the rows are zero-padded, never
  sent elsewhere. On the CPU it is an exact integer product. The two agree
  to the bit before the f32 rescale.

Embeddings and norm scales are not quantized (as in JAX).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("int8", "w8a8")


def quantize_kernel(w: torch.Tensor):
    """Symmetric per-output-channel int8: w [..., out, in] -> (q int8
    [..., out, in], scale f32 [..., out])."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def quantize_params(state_dict: Dict[str, torch.Tensor], mode: str = "int8"
                    ) -> Dict[str, torch.Tensor]:
    """A LLaMA state dict in the layout ``QuantLinear`` loads: each 2-D
    Linear ``*.weight`` (projections, MLP, lm_head; not the embedding)
    becomes ``*.weight_q`` (int8) and ``*.weight_scale`` (f32).

    One tensor at a time, on the tensor's own device, and the entry is
    removed from ``state_dict`` as it is converted: when the caller holds
    no other reference, a 13.5 GB bf16 tree is never held beside its int8
    copy. Both modes share the storage (w8a8 changes the compute only)."""
    if mode not in MODES:
        raise ValueError(f"quant mode {mode!r}, expected one of {MODES}")
    out = {}
    for key in list(state_dict):
        value = state_dict.pop(key)
        if key.endswith(".weight") and value.dim() == 2 and "embed_tokens" not in key:
            stem = key[: -len("weight")]
            out[stem + "weight_q"], out[stem + "weight_scale"] = quantize_kernel(value)
        else:
            out[key] = value
        del value
    return out


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times w [N, K] int8 transposed -> int32 [M, N], exact.

    CUDA: ``torch._int_mm`` with the rows zero-padded to 24 when M <= 16 (its
    rule is M > 16; K and N must be multiples of 8, else this raises). CPU:
    the product in float64, exact since every partial sum is an integer
    below 2^53 (|a w| <= 127^2 K)."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {w.dtype}")
    M, K = a.shape
    N = w.shape[0]
    if a.device.type == "cpu":
        return (a.double() @ w.double().t()).to(torch.int32)
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K={K} N={N}")
    if M <= 16:
        padded = a.new_zeros(24, K)
        padded[:M] = a
        return torch._int_mm(padded, w.t())[:M]
    return torch._int_mm(a.contiguous(), w.t())


class QuantLinear(nn.Module):
    """Bias-free Linear over int8 codes ``weight_q`` [out, in] and per-channel
    f32 scales ``weight_scale`` [out] (made by ``quantize_params``)."""

    def __init__(self, in_features: int, out_features: int, mode: str = "int8",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"quant mode {mode!r}, expected one of {MODES}")
        self.in_features, self.out_features = in_features, out_features
        self.mode, self.dtype = mode, dtype
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32,
                                                        device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "w8a8":
            xf = x.float()
            x_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
            xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
            acc = int8_matmul(xq.reshape(-1, self.in_features), self.weight_q)
            acc = acc.reshape(*x.shape[:-1], self.out_features)
            return (acc.float() * x_scale * self.weight_scale).to(self.dtype)
        y = F.linear(x.to(self.dtype), self.weight_q.to(self.dtype))
        return y * self.weight_scale.to(self.dtype)
