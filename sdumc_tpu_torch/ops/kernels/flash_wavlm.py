"""WavLM gated-rel-pos attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``sdumc_tpu/ops/pallas/flash_wavlm.py::_flash_kernel``
(``pallas_call`` at flash_wavlm.py:371, public as ``flash_gated_attention``).
For q, k, v [B, T, H, hd], the gru_rel_pos gate [B, H, T] and the shared
bucket embedding rel_embed [num_buckets, H]:

    s[b,h,t,u] = q[b,t,h] . k[b,u,h] / sqrt(hd)
                 + gate[b,h,t] * rel_embed[bucket(u - t), h]   (-1e30 where
                                                                kvalid[b,u] = 0)
    out[b,t,h] = sum_u softmax_u(s[b,h,t,:]) * v[b,u,h]

The bias depends on (t, u) only through r = u - t, so the kernel takes it as
a per-head diagonal vector ``bias_diag[h, r + T - 1] = rel_embed[bucket(r),
h]`` of shape [H, 2T - 1]; the encoder builds it once per forward and
carries it across its layers. Its buckets are always computed on the CPU,
so the kernel and the plain version see the same ones whatever the device's
``log`` rounds to. The kernel (``csrc/flash_wavlm.cu``) streams key tiles
through an online softmax and never stores the [T, T] scores; its header
says what bounds it on an H100. A tensor on the CPU takes the plain version
below; a tensor on the card takes the kernel or raises. Forward only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdumc_tpu_torch.ops.kernels import build, check_operand

NEG = -1e30
KERNEL_HEAD_DIMS = (16, 64)       # hd instances: wavlm-large's 64, the card tests' 16

# Kernel launches; the plain version counts nothing.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def bucket_from_rel(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5-style bidirectional bucketing of signed relative positions (HF
    WavLMAttention.compute_bias), in f32 with truncation to int32, as the
    JAX package's bucket_from_rel does."""
    nb = num_buckets // 2
    buckets = (rel > 0).to(torch.int32) * nb
    rel = rel.abs()
    max_exact = nb // 2
    is_small = rel < max_exact
    rel_large = (
        max_exact
        + torch.log(rel.clamp(min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).to(torch.int32)
    rel_large = rel_large.clamp(max=nb - 1)
    return buckets + torch.where(is_small, rel.to(torch.int32), rel_large)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """[q_len, k_len] int32 buckets of (key - query), on the CPU."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    return bucket_from_rel(rel, num_buckets, max_distance)


def bias_diag_for(rel_embed: torch.Tensor, T: int, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[H, 2T - 1] f32: entry r + T - 1 of head h is rel_embed[bucket(r), h]
    for r = key - query in [-(T - 1), T - 1]. Buckets come from the CPU."""
    buckets = bucket_from_rel(torch.arange(-(T - 1), T), num_buckets, max_distance)
    diag = rel_embed.float()[buckets.to(device=rel_embed.device, dtype=torch.long)]
    return diag.t().contiguous()


def dense_bias(bias_diag: torch.Tensor, T: int) -> torch.Tensor:
    """[H, T, T] bias[h, t, u] = bias_diag[h, u - t + T - 1]."""
    idx = torch.arange(T, device=bias_diag.device)
    return bias_diag[:, idx[None, :] - idx[:, None] + (T - 1)]


def flash_gated_attention_plain(q, k, v, gate, rel_embed, kvalid=None, bias_diag=None,
                                *, num_buckets: int, max_distance: int):
    """The einsum formulation: the CPU path and the kernel's oracle.
    ``bias_diag`` ([H, 2T - 1], from ``bias_diag_for``) stands in for
    ``rel_embed`` when given."""
    B, T, H, hd = q.shape
    if bias_diag is None:
        bias_diag = bias_diag_for(rel_embed, T, num_buckets, max_distance)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    scores = scores + gate[..., None] * dense_bias(bias_diag, T)[None]
    if kvalid is not None:
        scores = scores.masked_fill(~(kvalid[:, None, None, :] > 0), NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def flash_gated_attention(q, k, v, gate, rel_embed, kvalid=None, bias_diag=None,
                          *, num_buckets: int, max_distance: int):
    """out [B, T, H, hd] (see the module docstring).

    q/k/v are [B, T, H, hd], gate [B, H, T], rel_embed [num_buckets, H]
    (may be None when ``bias_diag`` is given), kvalid an optional [B, T]
    0/1 (or bool) key mask, any pattern, and bias_diag the optional
    precomputed [H, 2T - 1] diagonal bias.
    """
    if q.device.type == "cpu":
        return flash_gated_attention_plain(
            q, k, v, gate, rel_embed, kvalid, bias_diag,
            num_buckets=num_buckets, max_distance=max_distance)
    return launch(q, k, v, gate, rel_embed, kvalid, bias_diag,
                  num_buckets=num_buckets, max_distance=max_distance)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_wavlm")
    fn = lib.sdumc_flash_wavlm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.sdumc_flash_wavlm_error_string.argtypes = [i]
        lib.sdumc_flash_wavlm_error_string.restype = ctypes.c_char_p
    return lib


def launch(q, k, v, gate, rel_embed, kvalid=None, bias_diag=None, *,
           num_buckets: int, max_distance: int):
    """Run the kernel on the card; raises on what it does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on a CUDA device, q is on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, hd], got {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, gate, rel_embed, bias_diag)):
        raise RuntimeError("the flash kernel is forward-only; run it under "
                           "torch.inference_mode() or torch.no_grad()")
    B, T, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {KERNEL_HEAD_DIMS}, got hd={hd}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, (B, T, H, hd), dev)
    check_operand("gate", gate, (B, H, T), dev)
    if bias_diag is None:
        if rel_embed is None:
            raise ValueError("pass rel_embed or bias_diag")
        check_operand("rel_embed", rel_embed, (num_buckets, H), dev)
        bias_diag = bias_diag_for(rel_embed, T, num_buckets, max_distance)
    check_operand("bias_diag", bias_diag, (H, 2 * T - 1), dev)
    kvalid_ptr = None
    if kvalid is not None:
        if kvalid.device != dev:
            raise ValueError(f"kvalid is on {kvalid.device}, q on {dev}")
        if tuple(kvalid.shape) != (B, T):
            raise ValueError(f"kvalid must be [B={B}, T={T}], got {tuple(kvalid.shape)}")
        kvalid = kvalid.to(torch.float32).contiguous()
        kvalid_ptr = kvalid.data_ptr()

    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdumc_flash_wavlm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias_diag.data_ptr(), kvalid_ptr, out.data_ptr(),
            B, T, H, hd, 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError("flash_wavlm kernel launch failed: "
                           + lib.sdumc_flash_wavlm_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return out
