"""VideoMAE encoder, the port of ``sdumc_tpu/models/videomae.py``: the
temporal ViT among the reference's alternative visual encoders, run over
16-frame windows of face crops (extract_vision_huggingface.py:134-146),
HF ``VideoMAEModel`` semantics.

  video [B, T, 3, H, W] -> tubelet Conv3d (tubelet x patch x patch) -> the
  fixed sinusoid table (built here, never stored) -> N pre-LN layers whose
  q and v carry a bias and whose k's bias is pinned to zero -> the final
  ``layernorm`` unless ``use_mean_pooling``; pooled is the token mean.

Submodules carry HF's names (``encoder.layer.0.attention.attention.q_bias``
sits on the attention module, not on the Linear, as in HF), so its state
dict loads as it is (``convert/hf_videomae.py``). f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.models.vit import self_attention, split_heads


@dataclasses.dataclass(frozen=True)
class VideoMAEConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    tubelet_size: int = 2
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    use_mean_pooling: bool = True    # True -> no final LN in the trunk

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2 * (self.num_frames // self.tubelet_size)

    @staticmethod
    def tiny(**kw) -> "VideoMAEConfig":
        base = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                    image_size=16, patch_size=8, num_frames=4, tubelet_size=2)
        base.update(kw)
        return VideoMAEConfig(**base)


def sinusoid_table(n_position: int, d: int) -> np.ndarray:
    """HF get_sinusoid_encoding_table, [1, n_position, d] f32 (the JAX
    package's ``models/videomae.py:51-60``)."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / d)
    table = np.zeros((n_position, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


class PatchEmbeddings(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        k = (c.tubelet_size, c.patch_size, c.patch_size)
        self.projection = nn.Conv3d(3, c.hidden_size, k, stride=k)


class VideoMAEEmbeddings(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        self.patch_embeddings = PatchEmbeddings(c)
        table = torch.from_numpy(sinusoid_table(c.num_patches, c.hidden_size))
        self.register_buffer("position_embeddings", table, persistent=False)

    def forward(self, video):
        x = self.patch_embeddings.projection(video.permute(0, 2, 1, 3, 4))   # [B, D, t, h, w]
        return x.flatten(2).transpose(1, 2) + self.position_embeddings


class SelfAttention(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        D = c.hidden_size
        self.heads = c.num_heads
        self.query = nn.Linear(D, D, bias=False)
        self.key = nn.Linear(D, D, bias=False)
        self.value = nn.Linear(D, D, bias=False)
        if c.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(D))
            self.v_bias = nn.Parameter(torch.zeros(D))
        else:
            self.q_bias = self.v_bias = None

    def forward(self, x):
        q = F.linear(x, self.query.weight, self.q_bias)
        v = F.linear(x, self.value.weight, self.v_bias)
        return self_attention(*(split_heads(t, self.heads) for t in (q, self.key(x), v)))


class Dense(nn.Module):
    """HF's ``VideoMAESelfOutput`` / ``Intermediate`` / ``Output``: one Linear
    named ``dense``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class Attention(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        self.attention = SelfAttention(c)
        self.output = Dense(c.hidden_size, c.hidden_size)


class VideoMAELayer(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        self.attention = Attention(c)
        self.intermediate = Dense(c.hidden_size, c.intermediate_size)
        self.output = Dense(c.intermediate_size, c.hidden_size)
        self.layernorm_before = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        att = self.attention
        x = x + att.output.dense(att.attention(self.layernorm_before(x)))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class VideoMAEEncoder(nn.Module):
    def __init__(self, c: VideoMAEConfig):
        super().__init__()
        self.layer = nn.ModuleList(VideoMAELayer(c) for _ in range(c.num_layers))


class VideoMAEModel(nn.Module):
    def __init__(self, cfg: VideoMAEConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = VideoMAEEmbeddings(cfg)
        self.encoder = VideoMAEEncoder(cfg)
        self.layernorm = (None if cfg.use_mean_pooling
                          else nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps))

    def forward(self, video: torch.Tensor) -> dict:
        """video [B, T, 3, H, W] (T = num_frames, HF's pixel_values layout)
        -> {"last_hidden_state" [B, P, D], "pooled" [B, D] (token mean)}."""
        x = self.embeddings(video)
        for layer in self.encoder.layer:
            x = layer(x)
        if self.layernorm is not None:
            x = self.layernorm(x)
        return {"last_hidden_state": x, "pooled": x.mean(dim=1)}
