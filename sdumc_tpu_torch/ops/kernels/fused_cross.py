"""Fused multi-query cross attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``sdumc_tpu/ops/pallas/fused_cross.py::_cross_kernel``
(``pallas_call`` at fused_cross.py:139). For query-projected ``q [B, Q, D]``:

    k      = tanh(x @ Wk^T + bk)               # [B, T, D], never stored
    s      = scale * (k @ q^T)                 # masked to t < t_max
    out[q] = sum_t softmax_t(s)[t, q] * x[t]   # [B, Q, D]

The query projection stays outside, in plain torch, as in the JAX package.
The kernel (``csrc/fused_cross.cu``) owns the key projection, the masked
online softmax and the weighted sum; its header says what bounds it on an
H100 and how the design answers. A tensor on the CPU takes the plain version
below; a tensor on the card takes the kernel or raises. Forward only: the
recomputing backward comes with the training path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
import torch.nn.functional as F

from sdumc_tpu_torch.ops.kernels import build, check_operand
from sdumc_tpu_torch.ops.masking import mask_time_scores

# Kernel launches by query count (7: CrossAttention, 1: FRA2UTTNew pool).
# A launch of the kernel pair counts once; the plain version counts nothing.
LAUNCHES: Dict[int, int] = {1: 0, 7: 0}

KERNEL_D = 256                   # the kernel's compile-time feature width
_TILE_T = 64                     # frames per tile in the kernel
_sm_count: Dict[int, int] = {}


def reset_launches() -> None:
    for q in LAUNCHES:
        LAUNCHES[q] = 0


def fused_cross_attention_plain(q, x, weight, bias, t_max=None,
                                softmax_scale: float = 0.3):
    """The einsum formulation, with per-row masking: the CPU path and the
    kernel's oracle."""
    k = torch.tanh(F.linear(x, weight, bias))
    scores = torch.einsum("btd,bqd->btq", k, q)
    scores = mask_time_scores(softmax_scale * scores, t_max, axis=1)
    attn = torch.softmax(scores, dim=1)
    return torch.einsum("btd,btq->bqd", x, attn)


def fused_cross_attention(q, x, weight, bias, t_max=None,
                          softmax_scale: float = 0.3):
    """out [B, Q, D]: each projected query attends over x's time axis.

    ``weight``/``bias`` are the key projection in nn.Linear layout
    ([out, in]); ``t_max`` is None, an int, or a per-row [B] tensor.
    """
    if x.device.type == "cpu":
        return fused_cross_attention_plain(q, x, weight, bias, t_max,
                                           softmax_scale)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, Q, D], got {tuple(q.shape)}")
    return launch(q, x, weight, bias, t_max, softmax_scale, q_batched=True)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_cross")
    fn = lib.sdumc_fused_cross
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, p, p, p, p, p,
                       i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.sdumc_cuda_error_string.argtypes = [i]
        lib.sdumc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def splits_for(sm_count: int, B: int, T: int) -> int:
    """Blocks per row along time: one per 64-frame tile, so that B rows fill
    the card's SMs several times over, up to 16 blocks per SM in all (which
    bounds the partials); each block takes an equal run of a row's tiles."""
    return max(1, min(math.ceil(T / _TILE_T), math.ceil(16 * sm_count / B)))


def _splits(device: torch.device, B: int, T: int) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return splits_for(_sm_count[idx], B, T)


def launch(q, x, weight, bias, t_max, softmax_scale, *, q_batched: bool):
    """Run the kernel on the card. ``q`` is [B, Q, D], or [Q, D] shared by
    every row when ``q_batched`` is False."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernel runs on a CUDA device, x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, x, weight, bias)):
        raise RuntimeError("the fused kernel is forward-only; run it under "
                           "torch.inference_mode() or torch.no_grad()")
    B, T, D = x.shape
    Q = q.shape[-2]
    if D != KERNEL_D or not 1 <= Q <= 8:
        raise ValueError(f"the kernel takes D = {KERNEL_D} (the fusion net's "
                         f"width) and 1 <= Q <= 8, got D={D}, Q={Q}")
    dev = x.device
    check_operand("x", x, (B, T, D), dev)
    check_operand("q", q, (B, Q, D) if q_batched else (Q, D), dev)
    check_operand("weight", weight, (D, D), dev)
    check_operand("bias", bias, (D,), dev)

    tmax_ptr, tmax_scalar = None, T
    if isinstance(t_max, torch.Tensor):
        if t_max.is_floating_point() or t_max.is_complex():
            raise TypeError(f"t_max must be integer, got {t_max.dtype}")
        if t_max.device != dev:
            raise ValueError(f"t_max is on {t_max.device}, x on {dev}")
        if t_max.ndim == 0:
            t_max = t_max.reshape(1).expand(B)
        if tuple(t_max.shape) != (B,):
            raise ValueError(f"t_max must be a scalar or [B={B}], got {tuple(t_max.shape)}")
        t_max = t_max.to(torch.int32).contiguous()
        tmax_ptr = t_max.data_ptr()
    elif t_max is not None:
        tmax_scalar = int(t_max)

    qp = 1 if Q == 1 else 8
    nsplit = _splits(dev, B, T)
    out = torch.empty((B, Q, D), dtype=torch.float32, device=dev)
    m_part = torch.empty(B * nsplit * qp, dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty(B * nsplit * qp * D, dtype=torch.float32, device=dev)
    w_split = torch.empty(2 * D * D, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdumc_fused_cross(
            q.data_ptr(), Q * D if q_batched else 0, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), tmax_ptr, tmax_scalar,
            out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), w_split.data_ptr(), B, Q, T, D, nsplit,
            float(softmax_scale),
            stream)
    if err:
        raise RuntimeError("fused_cross kernel launch failed: "
                           + lib.sdumc_cuda_error_string(err).decode())
    LAUNCHES[Q] = LAUNCHES.get(Q, 0) + 1
    return out
