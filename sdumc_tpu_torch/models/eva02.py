"""EVA-02 vision tower, the port of ``sdumc_tpu/models/eva02.py``: the
MIM-pretrained ViT among the reference's alternative visual encoders
(timm ``eva02_base_patch14_224.mim_in22k``,
extract_vision_huggingface.py:23,142-146), built from the published
architecture (arXiv:2303.11331) as JAX builds it:

  pixels [B, 3, H, W] -> patch conv (+bias) + CLS + learned positions ->
  N pre-LN blocks with 2-D axial rotary embeddings on the patch tokens'
  q and k (CLS excluded), k without a bias, a SwiGLU MLP with a sub-LN
  (``mlp.norm``) before its down projection -> pooled: the mean of the
  patch tokens through ``fc_norm`` (timm's ``num_classes=0`` avg pool).

Submodules carry timm's names (``blocks.0.attn.q_proj``, ``mlp.fc1_g``),
so a timm state dict loads as it is (``convert/timm_eva02.py``). The rope
tables are built once per model, as buffers that follow it to its device.
NCHW, f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.vit import self_attention, split_heads


@dataclasses.dataclass(frozen=True)
class Eva02Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_hidden: int = 2048           # published base: mlp_ratio 4 * 2/3
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    rope_temperature: float = 10000.0
    ref_grid: Tuple[int, int] = (16, 16)   # rope coordinates are rescaled grid / ref_grid

    @property
    def grid(self) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g, g)

    @property
    def num_patches(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw) -> "Eva02Config":
        base = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_hidden=24,
                    image_size=28, patch_size=7, ref_grid=(4, 4))
        base.update(kw)
        return Eva02Config(**base)


def rope_2d(grid: Tuple[int, int], head_dim: int, ref_grid: Optional[Tuple[int, int]] = None,
            temperature: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Axial 2-D rotary tables (sin, cos), each [H * W, head_dim] f32: per
    axis head_dim / 4 bands of inverse-power frequency, coordinates
    rescaled to ``ref_grid``, the (axis, band) angles flattened axis-major
    and each repeated onto its interleaved pair (2i, 2i + 1)."""
    nb = head_dim // 4
    if nb * 4 != head_dim:
        raise ValueError(f"head_dim {head_dim} must be divisible by 4")
    bands = 1.0 / temperature ** (np.arange(nb, dtype=np.float64) / nb)
    coords = [np.arange(s, dtype=np.float64) for s in grid]
    if ref_grid is not None:
        coords = [c / g * r for c, g, r in zip(coords, grid, ref_grid)]
    mesh = np.stack(np.meshgrid(*coords, indexing="ij"), axis=-1)      # [H, W, 2]
    flat = (mesh[..., None] * bands).reshape(-1, 2 * nb)                # [N, hd / 2]
    sin = np.repeat(np.sin(flat), 2, axis=-1).astype(np.float32)
    cos = np.repeat(np.cos(flat), 2, axis=-1).astype(np.float32)
    return sin, cos


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs (2i, 2i + 1) of x [..., N, hd] by the
    angles of sin / cos [N, hd]."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


class PatchEmbed(nn.Module):
    def __init__(self, c: Eva02Config):
        super().__init__()
        self.proj = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)


class Eva02Attention(nn.Module):
    def __init__(self, c: Eva02Config):
        super().__init__()
        D = c.hidden_size
        self.heads = c.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D, bias=False)
        self.v_proj = nn.Linear(D, D)
        self.proj = nn.Linear(D, D)

    def forward(self, x, sin, cos):
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        # the patch tokens rotate; the CLS row has no spatial coordinate
        q = torch.cat([q[:, :, :1], apply_rope(q[:, :, 1:], sin, cos)], dim=2)
        k = torch.cat([k[:, :, :1], apply_rope(k[:, :, 1:], sin, cos)], dim=2)
        return self.proj(self_attention(q, k, v))


class SwiGLU(nn.Module):
    def __init__(self, c: Eva02Config):
        super().__init__()
        self.fc1_g = nn.Linear(c.hidden_size, c.mlp_hidden)
        self.fc1_x = nn.Linear(c.hidden_size, c.mlp_hidden)
        self.norm = nn.LayerNorm(c.mlp_hidden, eps=c.layer_norm_eps)     # sub-LN
        self.fc2 = nn.Linear(c.mlp_hidden, c.hidden_size)

    def forward(self, x):
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))


class Eva02Block(nn.Module):
    def __init__(self, c: Eva02Config):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attn = Eva02Attention(c)
        self.norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = SwiGLU(c)

    def forward(self, x, sin, cos):
        x = x + self.attn(self.norm1(x), sin, cos)
        return x + self.mlp(self.norm2(x))


class Eva02Model(nn.Module):
    def __init__(self, cfg: Eva02Config):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Eva02Block(cfg) for _ in range(cfg.num_layers))
        self.fc_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        sin, cos = rope_2d(cfg.grid, cfg.head_dim, cfg.ref_grid, cfg.rope_temperature)
        self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)
        self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)

    def forward(self, pixels: torch.Tensor) -> dict:
        """pixels [B, 3, H, W] -> {"last_hidden_state" [B, 1+P, D], "pooled"
        [B, D]}."""
        patches = self.patch_embed.proj(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(patches.shape[0], -1, -1), patches], dim=1)
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x, self.rope_sin, self.rope_cos)
        return {"last_hidden_state": x, "pooled": self.fc_norm(x[:, 1:].mean(dim=1))}
