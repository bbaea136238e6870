"""DINOv2 vision tower, the port of ``sdumc_tpu/models/dinov2.py``: the
self-supervised ViT among the reference's alternative visual encoders
(extract_vision_huggingface.py:134-146), HF ``Dinov2Model`` semantics.

  pixels [B, 3, H, W] -> patch conv (+bias) + CLS + learned positions ->
  N pre-LN layers, LayerScale (``lambda1``) on both residual branches, a
  gelu MLP or, with ``use_swiglu_ffn``, SwiGLU -> final ``layernorm``;
  pooled is the CLS row (HF's pooler_output).

Submodules carry HF's names (``encoder.layer.0.attention.attention.query``,
``layer_scale1.lambda1``), so its state dict loads as it is
(``convert/hf_dinov2.py``; HF's unused ``embeddings.mask_token`` is
dropped there). Positions are not interpolated: the input is the size the
config names, as JAX feeds it. NCHW, f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.vit import self_attention, split_heads


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    image_size: int = 518
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    use_swiglu_ffn: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def swiglu_hidden(self) -> int:
        """JAX's SwiGLU width (``models/dinov2.py:72``)."""
        return int(self.hidden_size * self.mlp_ratio * 2 / 3 + 7) // 8 * 8

    @staticmethod
    def tiny(**kw) -> "Dinov2Config":
        base = dict(hidden_size=32, num_layers=2, num_heads=4, image_size=28, patch_size=7)
        base.update(kw)
        return Dinov2Config(**base)


class PatchEmbeddings(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.projection = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)


class Dinov2Embeddings(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, c.num_patches + 1, c.hidden_size))
        self.patch_embeddings = PatchEmbeddings(c)

    def forward(self, pixels):
        patches = self.patch_embeddings.projection(pixels).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(patches.shape[0], -1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embeddings


class SelfAttention(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        D = c.hidden_size
        self.heads = c.num_heads
        self.query, self.key, self.value = nn.Linear(D, D), nn.Linear(D, D), nn.Linear(D, D)

    def forward(self, x):
        return self_attention(*(split_heads(p(x), self.heads)
                                for p in (self.query, self.key, self.value)))


class AttentionOutput(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)


class Attention(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.attention = SelfAttention(c)
        self.output = AttentionOutput(c)

    def forward(self, x):
        return self.output.dense(self.attention(x))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.lambda1


class MLP(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.fc1 = nn.Linear(c.hidden_size, c.hidden_size * c.mlp_ratio)
        self.fc2 = nn.Linear(c.hidden_size * c.mlp_ratio, c.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFN(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.weights_in = nn.Linear(c.hidden_size, 2 * c.swiglu_hidden)
        self.weights_out = nn.Linear(c.swiglu_hidden, c.hidden_size)

    def forward(self, x):
        g, u = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(g) * u)


class Dinov2Layer(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = Attention(c)
        self.layer_scale1 = LayerScale(c.hidden_size)
        self.norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = SwiGLUFFN(c) if c.use_swiglu_ffn else MLP(c)
        self.layer_scale2 = LayerScale(c.hidden_size)

    def forward(self, x):
        x = x + self.layer_scale1(self.attention(self.norm1(x)))
        return x + self.layer_scale2(self.mlp(self.norm2(x)))


class Dinov2Encoder(nn.Module):
    def __init__(self, c: Dinov2Config):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(c) for _ in range(c.num_layers))


class Dinov2Model(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Dinov2Embeddings(cfg)
        self.encoder = Dinov2Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> dict:
        """pixels [B, 3, H, W] -> {"last_hidden_state" [B, 1+P, D], "pooled"
        [B, D] (the post-LN CLS row)}."""
        x = self.embeddings(pixels)
        for layer in self.encoder.layer:
            x = layer(x)
        x = self.layernorm(x)
        return {"last_hidden_state": x, "pooled": x[:, 0]}
