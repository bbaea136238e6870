"""CLIP vision tower (ViT), the port of ``sdumc_tpu/models/clip_vit.py``:
the alternative visual extractor the reference drives through HF
``get_image_features`` over face crops
(extract_vision_huggingface.py:134-146,172-179).

  pixels [B, 3, H, W] -> patch conv (stride = patch, no bias) + the class
  embedding + learned positions -> ``pre_layrnorm`` -> N pre-LN layers
  (quick-gelu MLP) -> ``post_layernorm`` on the CLS row = pooled ->
  ``visual_projection`` (no bias) = image_features.

Submodules carry HF's ``CLIPVisionModelWithProjection`` names
(``vision_model.encoder.layers.0.self_attn.q_proj``, HF's
``pre_layrnorm`` spelling included), so its state dict, or a whole
``CLIPModel``'s without the text tower, loads as it is
(``convert/hf_clip.py``). NCHW, f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.vit import self_attention, split_heads


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        base = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                    image_size=32, patch_size=8, projection_dim=24)
        base.update(kw)
        return CLIPVisionConfig(**base)


def activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unknown hidden_act {name!r}")


class CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(c.num_positions, c.hidden_size)

    def forward(self, pixels):
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)    # [B, P, D]
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPAttention(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        D, self.heads = c.hidden_size, c.num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(D, D) for _ in range(4))

    def forward(self, x):
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(self_attention(q, k, v))


class CLIPMLP(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.act = activation(c.hidden_act)
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(c)
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = CLIPMLP(c)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(c) for _ in range(c.num_layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.encoder = CLIPEncoder(c)
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class CLIPVisionTower(nn.Module):
    """Returns {"last_hidden_state" [B, 1+P, D], "pooled" [B, D],
    "image_features" [B, projection_dim]}."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> dict:
        """pixels: [B, 3, H, W], CLIP-normalised."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return {"last_hidden_state": x, "pooled": pooled,
                "image_features": self.visual_projection(pooled)}
