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
below; a tensor on the card takes the kernel or raises.

``x`` is f32, or bf16 (the production store's frame streams): the bf16
instance reads x as bf16, keeps W, the bias, the keys, the scores and the
softmax in f32, and rounds the output to bf16, as the Pallas kernel does at
bf16 x. Its plain version is the f32 formula on the widened inputs, rounded
to x's dtype at the end. On the card it runs its key projection on bf16
tensor cores: W is cut into three bf16 parts (``split_w_bf16``), each x .
part is exact in f32, and the keys are their f32 sum (``keys_bf16_order``
is that order in plain torch).

Python reaches the kernel through one ``torch.library`` custom op,
``sdumc::fused_cross`` (called through ``op``): its CUDA implementation is
``launch`` (the only caller of the ``ctypes`` entry points), its CPU
implementation the plain version, and its fake implementation gives
``torch.export`` the output's shape without running either. The wrappers
call the op on both devices, so a program exported on the CPU holds the
same node as one exported on the card. A schema takes no union, so the op
takes ``t_max`` as an optional tensor (0-d or [B]) beside an optional host
int. The op itself has no gradient formula: ``call_op`` wraps it in
``Recomputed`` when autograd wants one.

The gradient is the JAX package's: its ``custom_vjp`` recomputes the
forward through the einsum formulation and differentiates that, so no
backward kernel exists there either. Here ``Recomputed`` wraps the op: it
saves the op's inputs, and its backward runs the plain version under
``torch.enable_grad()`` and takes ``torch.autograd.grad`` of it (cuBLAS
products and elementwise ops on the card; launch counts are unchanged).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from sdumc_tpu_torch.ops.attention_pool import attention_pool
from sdumc_tpu_torch.ops.kernels import build, check_operand
from sdumc_tpu_torch.ops.masking import mask_time_scores

# Kernel launches by query count (7: CrossAttention, 1: FRA2UTTNew pool), of
# the f32 instance and of the bf16 instance. A launch of the kernel pair
# counts once; the plain version counts nothing.
LAUNCHES: Dict[int, int] = {1: 0, 7: 0}
LAUNCHES_BF16: Dict[int, int] = {1: 0, 7: 0}

KERNEL_D = 256                   # the kernel's compile-time feature width
_TILE_T = 64                     # frames per tile in the f32 instance
TILE_T_BF16 = 256                # ... in the bf16 instance
W_PARTS = 3                      # the bf16 instance's parts of W
_sm_count: Dict[int, int] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for q in counts:
            counts[q] = 0


def fused_cross_attention_plain(q, x, weight, bias, t_max=None,
                                softmax_scale: float = 0.3):
    """The einsum formulation, with per-row masking: the CPU path and the
    kernel's oracle. A bf16 x computes in f32 on the widened inputs and
    rounds the output to bf16."""
    if x.dtype == torch.bfloat16:
        return fused_cross_attention_plain(q.float(), x.float(), weight.float(), bias.float(),
                                           t_max, softmax_scale).to(x.dtype)
    k = torch.tanh(F.linear(x, weight, bias))
    scores = torch.einsum("btd,bqd->btq", k, q)
    scores = mask_time_scores(softmax_scale * scores, t_max, axis=1)
    attn = torch.softmax(scores, dim=1)
    return torch.einsum("btd,btq->bqd", x, attn)


def fused_attention_pool_plain(x, weight, bias, context, t_max=None,
                               softmax_scale: float = 0.3):
    """The Q = 1 case with the pool's context [D] as the query
    (ops/attention_pool.py; ``fused_pool`` re-exports it): the CPU path and
    the kernel's oracle. A bf16 x computes in f32 on the widened inputs and
    rounds the output to bf16."""
    if x.dtype == torch.bfloat16:
        return fused_attention_pool_plain(x.float(), weight.float(), bias.float(),
                                          context.float(), t_max, softmax_scale).to(x.dtype)
    return attention_pool(x, weight, bias, context,
                          softmax_scale=softmax_scale, t_max=t_max)[0]


def split_w_bf16(weight: torch.Tensor):
    """(hi, mid, lo), the bf16 instance's parts of an f32 W: each part is
    the bf16 rounding toward zero (the top 16 bits) of what the earlier
    parts leave, and each remainder is exact in f32. So hi + mid + lo == W
    to the bit for every |w| >= 2^-110 and 0 (below that a part would fall
    under bf16's smallest subnormal, 2^-133), and a bf16 x times a part (8
    by 8 significant bits) is exact in f32. The plain twin of the kernel's
    ``cross_split_w3_kernel``."""
    rest = weight.float().contiguous()
    parts = []
    for _ in range(W_PARTS):
        top = (rest.view(torch.int32) & -65536).view(torch.float32)   # 0xffff0000
        parts.append(top.bfloat16())
        rest = rest - top
    return tuple(parts)


def keys_bf16_order(x, weight, bias):
    """tanh(x W^T + b) as the bf16 instance sums it: x . lo, x . mid and
    x . hi, each an f32 product of exact terms, added in that order in f32,
    then the bias. Within f32 reassociation of the f32 formula on the
    widened x."""
    hi, mid, lo = split_w_bf16(weight)
    xf = x.float()
    k = F.linear(xf, lo.float())
    k = k + F.linear(xf, mid.float())
    k = k + F.linear(xf, hi.float())
    return torch.tanh(k + bias.float())


def fused_cross_attention(q, x, weight, bias, t_max=None,
                          softmax_scale: float = 0.3):
    """out [B, Q, D]: each projected query attends over x's time axis.

    ``weight``/``bias`` are the key projection in nn.Linear layout
    ([out, in]); ``t_max`` is None, an int, a 0-d or a per-row [B] tensor.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be [B, Q, D], got {tuple(q.shape)}")
    return call_op(op, fused_cross_attention_plain, q, x, weight, bias, t_max,
                   softmax_scale)


def call_op(kernel, plain, q, x, weight, bias, t_max, softmax_scale):
    """``kernel(q, x, weight, bias, t_max, softmax_scale)``, a function that
    calls ``sdumc::fused_cross``, on either device: through ``Recomputed``
    (whose backward differentiates ``plain``) when autograd wants a
    gradient, else directly."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, x, weight, bias)):
        return Recomputed.apply(kernel, plain, q, x, weight, bias, t_max, softmax_scale)
    return kernel(q, x, weight, bias, t_max, softmax_scale)


def op(q, x, weight, bias, t_max, softmax_scale, q_batched: bool = True):
    """``sdumc::fused_cross`` with ``t_max`` in any of its four forms: out
    [B, Q, D] for ``q`` [B, Q, D], or pooled [B, D] for the pool's context
    ``q`` [D] shared by every row when ``q_batched`` is False."""
    if isinstance(t_max, torch.Tensor):
        tensor, scalar = t_max, None
    else:
        tensor, scalar = None, None if t_max is None else int(t_max)
    if q_batched:
        return torch.ops.sdumc.fused_cross(q, x, weight, bias, tensor, scalar,
                                           float(softmax_scale), True)
    return torch.ops.sdumc.fused_cross(q.reshape(1, -1), x, weight, bias, tensor, scalar,
                                       float(softmax_scale), False)[:, 0]


def _t_max(t_max: Optional[torch.Tensor], t_max_scalar: Optional[int]):
    return t_max if t_max is not None else t_max_scalar


@torch.library.custom_op("sdumc::fused_cross", mutates_args=(), device_types="cpu")
def _fused_cross_op(q: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, t_max: Optional[torch.Tensor],
                    t_max_scalar: Optional[int], softmax_scale: float,
                    q_batched: bool) -> torch.Tensor:
    """out [B, Q, D] in x's dtype. ``q`` is [B, Q, D], or the pool's context
    [1, D] shared by every row when ``q_batched`` is False; ``t_max`` a 0-d
    or [B] integer tensor, else ``t_max_scalar`` a host int, else None (no
    mask). The CPU implementation: the plain version."""
    t = _t_max(t_max, t_max_scalar)
    if q_batched:
        return fused_cross_attention_plain(q, x, weight, bias, t, softmax_scale).contiguous()
    if q.shape[0] != 1:
        raise ValueError(f"a shared query is the pool's one context [1, D], got {tuple(q.shape)}")
    return fused_attention_pool_plain(x, weight, bias, q[0], t, softmax_scale)[:, None].contiguous()


@_fused_cross_op.register_kernel("cuda")
def _fused_cross_cuda(q, x, weight, bias, t_max, t_max_scalar, softmax_scale, q_batched):
    return launch(q, x, weight, bias, _t_max(t_max, t_max_scalar), softmax_scale,
                  q_batched=q_batched)


@_fused_cross_op.register_fake
def _fused_cross_fake(q, x, weight, bias, t_max, t_max_scalar, softmax_scale, q_batched):
    return x.new_empty((x.shape[0], q.shape[-2], x.shape[2]))


@register_flop_formula(torch.ops.sdumc.fused_cross)
def fused_cross_flops(q_shape, x_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    """The op's flops for ``torch.utils.flop_counter`` (``FlopCounterMode``,
    ``utils.roofline.program_cost``): tanh(x W^T + b), 2 B T D_out D_in; the
    scores k . q and the weighted sum p . x, 2 B Q T D each, over the padded
    T whatever t_max, as the plain version computes them. Q is the output's
    (the pool's shared context gives Q = 1)."""
    B, T, d_in = x_shape
    d_out = weight_shape[0]
    Q = out_shape[1]
    return 2 * B * T * d_out * d_in + 2 * B * Q * T * d_out + 2 * B * Q * T * d_in


class Recomputed(torch.autograd.Function):
    """``kernel``'s forward, and a backward that recomputes ``plain`` on the
    saved inputs and differentiates it. Both functions take
    ``(q, x, weight, bias, t_max, softmax_scale)``; ``q`` may be the pool's
    shared context, whose gradient autograd then sums over the rows."""

    @staticmethod
    def forward(ctx, kernel, plain, q, x, weight, bias, t_max, softmax_scale):
        ctx.plain, ctx.softmax_scale = plain, softmax_scale
        if isinstance(t_max, torch.Tensor):
            ctx.save_for_backward(q, x, weight, bias, t_max)
        else:
            ctx.save_for_backward(q, x, weight, bias)
            ctx.t_max = t_max
        return kernel(q, x, weight, bias, t_max, softmax_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        q, x, weight, bias, *t_max = ctx.saved_tensors
        t_max = t_max[0] if t_max else ctx.t_max
        needs = ctx.needs_input_grad[2:6]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((q, x, weight, bias), needs)]
            out = ctx.plain(*inputs, t_max, ctx.softmax_scale)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (None, None, *(next(grads) if need else None for need in needs), None, None)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_cross")
    if lib.sdumc_cuda_error_string.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.sdumc_fused_cross, lib.sdumc_fused_cross_bf16):
            fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, p, p, p, p, p,
                           i, i, i, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
        lib.sdumc_cuda_error_string.argtypes = [i]
        lib.sdumc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def splits_for(sm_count: int, B: int, T: int, tile: int = _TILE_T) -> int:
    """Blocks per row along time: one per tile of ``tile`` frames (the f32
    instance's 64, the bf16 instance's 256), so that B rows fill the card's
    SMs several times over, up to 16 blocks per SM in all (which bounds the
    partials); each block takes an equal run of a row's tiles. A row shorter
    than a tile takes one block whatever its length: the short buckets'
    calls run B blocks (64 of the 132 SMs at the dual batch), since a tile's
    key columns are never split across blocks (its scores sum over them)."""
    return max(1, min(math.ceil(T / tile), math.ceil(16 * sm_count / B)))


def _splits(device: torch.device, B: int, T: int, tile: int = _TILE_T) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return splits_for(_sm_count[idx], B, T, tile)


def launch(q, x, weight, bias, t_max, softmax_scale, *, q_batched: bool):
    """Run the kernel on the card: the f32 instance for an f32 ``x``, the
    bf16 instance for a bf16 one (the output takes x's dtype). ``q`` is
    [B, Q, D], or [Q, D] shared by every row when ``q_batched`` is False;
    a bf16 ``q`` is widened to f32 here (exact)."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernel runs on a CUDA device, x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    B, T, D = x.shape
    Q = q.shape[-2]
    if D != KERNEL_D or not 1 <= Q <= 8:
        raise ValueError(f"the kernel takes D = {KERNEL_D} (the fusion net's "
                         f"width) and 1 <= Q <= 8, got D={D}, Q={Q}")
    dev = x.device
    check_operand("x", x, (B, T, D), dev, (torch.float32, torch.bfloat16))
    bf16 = x.dtype == torch.bfloat16
    if bf16 and q.dtype == torch.bfloat16:
        q = q.float()
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
    nsplit = _splits(dev, B, T, TILE_T_BF16 if bf16 else _TILE_T)
    out = torch.empty((B, Q, D), dtype=x.dtype, device=dev)
    m_part = torch.empty(B * nsplit * qp, dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty(B * nsplit * qp * D, dtype=torch.float32, device=dev)
    # W's split: hi and lo in f32, or the bf16 instance's three bf16 parts
    w_split = (torch.empty(W_PARTS * D * D, dtype=torch.bfloat16, device=dev) if bf16
               else torch.empty(2 * D * D, dtype=torch.float32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.sdumc_fused_cross_bf16 if bf16 else lib.sdumc_fused_cross
        err = entry(
            q.data_ptr(), Q * D if q_batched else 0, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), tmax_ptr, tmax_scalar,
            out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), w_split.data_ptr(), B, Q, T, D, nsplit,
            float(softmax_scale),
            stream)
    if err:
        raise RuntimeError("fused_cross kernel launch failed: "
                           + lib.sdumc_cuda_error_string(err).decode())
    counts = LAUNCHES_BF16 if bf16 else LAUNCHES
    counts[Q] = counts.get(Q, 0) + 1
    return out
