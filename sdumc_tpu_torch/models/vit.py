"""Pieces the port's vision transformers share (CLIP, DINOv2, VideoMAE,
EVA-02): the head split and the self-attention as the JAX package writes
it, scores q·kᵀ/√hd, a softmax over the keys in f32, the weighted sum of
v. Plain f32 PyTorch products (cuBLAS on the card, TF32 off at the entry
points); no kernel of the port runs here."""

from __future__ import annotations

import math

import torch


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, heads, T, D / heads]."""
    B, T, D = x.shape
    return x.view(B, T, heads, D // heads).transpose(1, 2)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, T, hd] -> [B, T, H * hd]."""
    B, H, T, hd = q.shape
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * hd)
