"""Plain PyTorch reference of WavLM's forward (microsoft/wavlm-large, as
HF's ``WavLMModel`` computes it) up to a hidden-state tap, for one clip at
a time. It imports nothing of the program under test.

  wave [S], normalised to zero mean and unit variance (the feature
  extractor's ``do_normalize``) -> 7 temporal convs, each with a layer norm
  over channels and gelu -> layer norm + projection to the hidden size ->
  + gelu(grouped positional conv, kernel K, padding K // 2, last frame cut
  for even K) -> pre-LN transformer layers, each with self-attention whose
  scores add a relative position bias (T5-style bidirectional buckets of
  key - query, an embedding per bucket and head) scaled by a per-layer,
  per-frame gate (gru_rel_pos), then a gelu feed-forward.

hidden_states[i] is the input of layer i (entry 0 the input of the first
layer); the tap -5 of wavlm-large's 25 entries is entry 20, the output of
the 20th layer, so the reference stops there. One clip runs alone at its
own length, so no padding or mask is needed: the program's batched,
padded, masked forward has to give the same frames.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision


def normalise(wave: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance (eps 1e-7), in the wave's float32."""
    wave = np.asarray(wave, np.float32)
    return (wave - wave.mean()) / np.sqrt(wave.var() + 1e-7)


def output_frames(cfg: Dict, n_samples: int) -> int:
    t = n_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
    return t


def buckets(T: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """[T, T] bucket of (key - query), computed in f32 on the CPU."""
    rel = torch.arange(T)[None, :] - torch.arange(T)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).to(torch.long) * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
    large = (max_exact + large * (nb - max_exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, nb - 1))
    return out + torch.where(rel < max_exact, rel, large)


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def forward_tap(p: Dict[str, torch.Tensor], cfg: Dict, wave: np.ndarray, pr: Precision,
                tap: int) -> torch.Tensor:
    """hidden_states[tap] ([T, D]) of one clip; ``tap`` counts from 0
    (0: the first layer's input) and is at most the layer count - 1."""
    dev = next(iter(p.values())).device
    eps = cfg["layer_norm_eps"]
    x = torch.from_numpy(normalise(wave)).to(dev)[None, None, :]          # [1, 1, S]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        pre = f"feature_extractor.conv_layers.{i}"
        x = pr.conv1d(x, p[pre + ".conv.weight"], p.get(pre + ".conv.bias"), stride=s)
        x = F.gelu(_ln(x.transpose(1, 2), p, pre + ".layer_norm", eps).transpose(1, 2))
    x = x.transpose(1, 2)[0]                                               # [T, C]
    x = _ln(x, p, "feature_projection.layer_norm", eps)
    x = pr.linear(x, p["feature_projection.projection.weight"],
                  p["feature_projection.projection.bias"])                # [T, D]
    K = cfg["num_conv_pos_embeddings"]
    pos = pr.conv1d(x.t()[None], p["encoder.pos_conv_embed.conv.weight"],
                    p["encoder.pos_conv_embed.conv.bias"], padding=K // 2,
                    groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos)[0].t()

    T, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    bucket = buckets(T, cfg["num_buckets"], cfg["max_bucket_distance"]).to(dev)
    bias = p["encoder.layers.0.attention.rel_attn_embed.weight"][bucket].permute(2, 0, 1)
    for i in range(tap):
        pre = f"encoder.layers.{i}"
        h = _ln(x, p, pre + ".layer_norm", eps)

        def proj(name, t):
            return pr.linear(t, p[f"{pre}.attention.{name}.weight"],
                             p[f"{pre}.attention.{name}.bias"])

        q = proj("q_proj", h).view(T, H, hd)
        k = proj("k_proj", h).view(T, H, hd)
        v = proj("v_proj", h).view(T, H, hd)
        heads = h.view(T, H, hd).transpose(0, 1)                           # [H, T, hd]
        g = proj("gru_rel_pos_linear", heads).view(H, T, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)                 # [H, T, 1]
        const = p[f"{pre}.attention.gru_rel_pos_const"][0]                 # [H, 1, 1]
        gate = gate_a * (gate_b * const - 1.0) + 2.0
        scores = pr.einsum("thd,shd->hts", q, k) / math.sqrt(hd) + gate * bias
        probs = torch.softmax(scores, dim=-1)
        out = pr.einsum("hts,shd->thd", probs, v).reshape(T, D)
        x = x + proj("out_proj", out)
        h = _ln(x, p, pre + ".final_layer_norm", eps)
        ff = pr.linear(h, p[f"{pre}.feed_forward.intermediate_dense.weight"],
                       p[f"{pre}.feed_forward.intermediate_dense.bias"])
        x = x + pr.linear(F.gelu(ff), p[f"{pre}.feed_forward.output_dense.weight"],
                          p[f"{pre}.feed_forward.output_dense.bias"])
    return x


def weight_layout(cfg: Dict):
    """WavLM's tensors, in HF's names (the positional conv's weight norm
    folded into its weight), as (name, shape, lo, hi): convolutions and
    Linears at torch's default range U(+-1/sqrt(fan_in)), layer norms near
    (1, 0), the gates' constants near 1, the relative position embedding
    in U(-1, 1)."""
    D, H, I = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    out = []

    def uni(name, shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        out.append((name, tuple(shape), -b, b))

    def lin(name, n_out, n_in):
        uni(name + ".weight", (n_out, n_in), n_in)
        uni(name + ".bias", (n_out,), n_in)

    def ln(name, n):
        out.append((name + ".weight", (n,), 0.9, 1.1))
        out.append((name + ".bias", (n,), -0.1, 0.1))

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}"
        uni(pre + ".conv.weight", (c, c_in, k), c_in * k)
        if cfg["conv_bias"]:
            uni(pre + ".conv.bias", (c,), c_in * k)
        ln(pre + ".layer_norm", c)
        c_in = c
    ln("feature_projection.layer_norm", c_in)
    lin("feature_projection.projection", D, c_in)
    K, G = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    uni("encoder.pos_conv_embed.conv.weight", (D, D // G, K), D // G * K)
    uni("encoder.pos_conv_embed.conv.bias", (D,), D // G * K)
    ln("encoder.layer_norm", D)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        out.append((pre + ".attention.gru_rel_pos_const", (1, H, 1, 1), 0.9, 1.1))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{pre}.attention.{name}", D, D)
        lin(pre + ".attention.gru_rel_pos_linear", 8, D // H)
        if i == 0:
            out.append((pre + ".attention.rel_attn_embed.weight", (cfg["num_buckets"], H),
                        -1.0, 1.0))
        ln(pre + ".layer_norm", D)
        lin(pre + ".feed_forward.intermediate_dense", I, D)
        lin(pre + ".feed_forward.output_dense", D, I)
        ln(pre + ".final_layer_norm", D)
    return out
