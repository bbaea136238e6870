"""Whisper ASR (encoder-decoder), the port of ``sdumc_tpu/models/whisper.py``.

It produces the transcripts behind the reference's ASR text-variant recipes
(``-gt(base.en_vad)``): a conv-subsampled encoder over the log-mel window
(``ops/mel.py``), a decoder with per-layer self-attention caches and cross
K/V computed once, and ``greedy_transcribe``, the batched greedy decode
with HF's logit rules for Whisper. ``extract/asr.py`` turns wav directories
into the transcription csv the text stage reads.

Submodules carry HF's names (``encoder.layers.0.self_attn.q_proj`` ...), so
an HF ``WhisperModel`` state dict (``WhisperForConditionalGeneration``'s
without its ``model.`` prefix; ``proj_out`` is the tied embedding) loads
straight in (``convert/hf_whisper.py``). The model runs in f32; the entry
points turn TF32 off, as the port's other f32 stages do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 512               # base.en
    encoder_layers: int = 6
    encoder_heads: int = 8
    decoder_layers: int = 6
    decoder_heads: int = 8
    ffn_dim: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448

    @staticmethod
    def tiny(**kw) -> "WhisperConfig":
        base = dict(vocab_size=100, num_mel_bins=8, d_model=16,
                    encoder_layers=2, encoder_heads=2, decoder_layers=2,
                    decoder_heads=2, ffn_dim=32, max_source_positions=50,
                    max_target_positions=40)
        base.update(kw)
        return WhisperConfig(**base)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal table (stored as a weight in HF's
    checkpoints; built here so that a seeded model equals a converted one)."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


class Attention(nn.Module):
    """HF WhisperAttention: q, v and out have a bias, k has none; q is
    scaled by hd^-0.5 after its projection."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, S, D = t.shape
        return t.view(B, S, self.heads, D // self.heads).transpose(1, 2)

    def kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S, D] -> k, v [B, H, S, hd], heads first and contiguous: the
        layout the batched products read without a copy."""
        return (self._heads(self.k_proj(src)).contiguous(),
                self._heads(self.v_proj(src)).contiguous())

    def forward(self, x, k, v, mask: Optional[torch.Tensor] = None):
        """x [B, T, D] queries over k, v [B, H, S, hd]; mask an additive
        [T, S] (or broadcastable) f32 term."""
        B, T, D = x.shape
        q = self._heads(self.q_proj(x) * (D // self.heads) ** -0.5)
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.self_attn = Attention(cfg.d_model, cfg.encoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, x):
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, *self.self_attn.kv(h))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperEncoder(nn.Module):
    """conv1 (stride 1) -> gelu -> conv2 (stride 2) -> gelu -> + the
    sinusoidal table -> pre-LN layers -> final LN (HF WhisperEncoder)."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, cfg.d_model)
        with torch.no_grad():
            self.embed_positions.weight.copy_(sinusoids(cfg.max_source_positions, cfg.d_model))
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, mel):
        """mel [B, n_mels, 2 max_source_positions] -> [B, S, D]."""
        x = F.gelu(self.conv2(F.gelu(self.conv1(mel)))).transpose(1, 2)
        x = x + self.embed_positions.weight[: x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.self_attn = Attention(cfg.d_model, cfg.decoder_heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.encoder_attn = Attention(cfg.d_model, cfg.decoder_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)


class WhisperDecoder(nn.Module):
    """Token embedding + learned positions, pre-LN layers of causal
    self-attention (cached), cross-attention and FFN, the final LN; logits
    through the tied embedding (HF's proj_out), in f32."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def cross_kv(self, enc: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's cross-attention k, v of the encoder output, computed
        once per clip batch (HF's cross-attention past_key_value)."""
        return [layer.encoder_attn.kv(enc) for layer in self.layers]

    def forward(self, tokens, xkvs, start: int = 0, caches: Optional[List[Dict]] = None):
        """tokens [B, T] at positions start .. start + T - 1 against the
        cross k, v ``xkvs``. ``caches`` (from ``init_self_caches``): each
        layer's self-attention k, v are written at those slots and the
        queries attend to slots <= their position; without caches T tokens
        attend causally among themselves (start must be 0). Returns the f32
        logits [B, T, V]."""
        B, T = tokens.shape
        dev = tokens.device
        pos = torch.arange(start, start + T, device=dev)
        x = self.embed_tokens(tokens) + self.embed_positions(pos)[None]
        end = start + T
        keys = torch.arange(end, device=dev)
        mask = torch.where(keys[None, :] <= pos[:, None], 0.0, NEG)       # [T, end]
        for i, layer in enumerate(self.layers):
            h = layer.self_attn_layer_norm(x)
            k, v = layer.self_attn.kv(h)
            if caches is not None:
                caches[i]["k"][:, :, start:end] = k
                caches[i]["v"][:, :, start:end] = v
                k, v = caches[i]["k"][:, :, :end], caches[i]["v"][:, :, :end]
            x = x + layer.self_attn(h, k, v, mask)
            h = layer.encoder_attn_layer_norm(x)
            x = x + layer.encoder_attn(h, *xkvs[i])
            x = x + layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x))))
        x = self.layer_norm(x)
        return torch.einsum("btd,vd->btv", x.float(), self.embed_tokens.weight.float())


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    def forward(self, mel, tokens):
        """Teacher-forced logits [B, T, V] of tokens [B, T] (causal)."""
        return self.decoder(tokens, self.decoder.cross_kv(self.encoder(mel)))


def init_self_caches(cfg: WhisperConfig, batch: int, max_len: int, device=None,
                     dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Each decoder layer's self-attention k, v cache, [B, H, max_len, hd]."""
    hd = cfg.d_model // cfg.decoder_heads
    shape = (batch, cfg.decoder_heads, max_len, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.decoder_layers)]


def greedy_transcribe(
    model: WhisperModel,
    mel: torch.Tensor,
    *,
    start_id: int,
    eos_id: int,
    max_new_tokens: int = 200,
    forced_ids: Sequence[Tuple[int, int]] = (),
    suppress_ids: Sequence[int] = (),
    begin_suppress_ids: Sequence[int] = (),
    check_every: int = 8,
) -> Dict[str, torch.Tensor]:
    """Batched greedy ASR decode with HF ``generate``'s logit rules for
    Whisper (greedy, no timestamps), as JAX's ``greedy_transcribe``:

    - ``forced_ids`` (position, token): the token is forced at that sequence
      position (position 1 = the first generated token);
    - ``suppress_ids`` are -inf at every step, ``begin_suppress_ids`` at the
      first step that is not forced;
    - a clip is done at ``eos_id``; a done clip's tokens stay ``eos_id``.

    ``done`` is read on the host every ``check_every`` steps; a step taken
    after every clip is done changes nothing, so any ``check_every`` gives
    the tokens of 1. mel [B, n_mels, frames] (clips padded to the 30-s
    window are fully attended, as HF's recipe has it). Returns tokens [B,
    max_new_tokens] (int64) and n_tokens [B], on mel's device.
    """
    cfg = model.cfg
    B, dev = mel.shape[0], mel.device
    forced = [-1] * max_new_tokens
    for p, t in forced_ids:
        if 1 <= p <= max_new_tokens:
            forced[p - 1] = int(t)
    n_forced_prefix = 0
    while n_forced_prefix < max_new_tokens and forced[n_forced_prefix] >= 0:
        n_forced_prefix += 1
    sup = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
    sup[sorted({int(s) for s in suppress_ids})] = True
    bsup = torch.zeros_like(sup)
    bsup[sorted({int(s) for s in begin_suppress_ids})] = True

    xkvs = model.decoder.cross_kv(model.encoder(mel))
    caches = init_self_caches(cfg, B, max_new_tokens + 1, dev, mel.dtype)
    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.long, device=dev)
    last = torch.full((B, 1), start_id, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(max_new_tokens):
        if step and step % check_every == 0 and bool(done.all()):
            break
        logits = model.decoder(last, xkvs, start=step, caches=caches)[:, -1]     # [B, V]
        if forced[step] >= 0:
            nxt = torch.full((B,), forced[step], dtype=torch.long, device=dev)
        else:
            ban = sup | bsup if step == n_forced_prefix else sup
            nxt = logits.masked_fill(ban, -math.inf).argmax(dim=-1)
        nxt = torch.where(done, eos_id, nxt)
        tokens[:, step] = nxt
        done = done | (nxt == eos_id)
        last = nxt[:, None]
    return {"tokens": tokens, "n_tokens": (tokens != eos_id).sum(dim=1)}
