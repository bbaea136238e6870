"""WavLM audio encoder (wavlm-large), the audio feature extractor.

The port of ``sdumc_tpu/models/wavlm.py``. The reference runs HF
``WavLMModel`` per wav file and saves hidden state -5, [T, 1024]
(feature_extraction/audio/extract_transformers_embedding.py:29-111,125):

  raw wav [B, S] -> 7 temporal convs (layer norm + gelu) -> [B, T, 512]
  -> feature projection (LN + Linear to 1024)
  -> grouped positional conv embedding (kernel 128, 16 groups, weight norm
     folded at conversion)
  -> 24 pre-LN transformer layers with WavLM's T5-style bucketed relative
     position bias, shared across layers and gated per layer ("gru_rel_pos")
  -> final LayerNorm; hidden-state taps per layer.

Submodules carry HF's state_dict names, so an HF checkpoint loads as a
state dict (``convert/hf_wavlm.py``); only the positional conv's weight norm
is folded into ``encoder.pos_conv_embed.conv.weight``.

In bf16 (the model cast with ``.to(torch.bfloat16)``, as
``cli.extract audio --dtype bfloat16`` does) the model rounds where flax
rounds with bf16 parameters and no ``dtype``: a Dense or a conv rounds its
product to bf16 and then adds its bias in bf16 (``Linear`` / ``Conv1d``
below; a fused bias would round once); LayerNorm and GroupNorm take their
statistics and normalise in f32 and round once (torch's bf16 norms do the
same); the gate's sum over its 4 pairs accumulates in f32; the einsum
path's softmax is f32; the kernel path is the flash kernel's bf16 instance
(or its plain version on the CPU: f32 scores, p rounded to bf16); the
weight-normed positional conv is folded in f32 at conversion and rounded
with the other weights. Elementwise ops (gelu, sigmoid, the gate's
arithmetic) are torch's bf16 ops, each computed in f32 and rounded once.

Tensor parallelism (``parallel.shard_wavlm_model``, JAX's ``WAVLM_RULES``):
a rank's model has ``TPWavLMAttention`` (its heads' q/k/v, gate constant
and relative-position embedding; the kernel runs at ``num_heads / N``
heads) and ``TPFeedForward`` in each layer, their row-split outputs summed
over the ranks before the bias (``parallel/layers.py``); built by
``tp_model_from_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdumc_tpu_torch.ops.kernels.flash_wavlm import (
    NEG, bias_diag_for, flash_gated_attention, relative_position_buckets)
from sdumc_tpu_torch.parallel.layers import RowParallelLinear
from sdumc_tpu_torch.parallel.ring_attention import ring_bias_diags, ring_gated_attention


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"      # wavlm-large; "group" = base models
    do_stable_layer_norm: bool = True     # pre-LN; False = post-LN
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.float32
    # False = plain MHA (wav2vec2 / HuBERT: the same trunk without the gated
    # relative position bias)
    use_rel_pos_bias: bool = True
    # "einsum" materialises [B, H, T, T] scores and bias; "flash" runs the
    # hand-written kernel on the card (its plain version on the CPU); "auto"
    # is the kernel whenever the tensors are on CUDA and einsum on the CPU.
    # "ring" (sequence-parallel, parallel/ring_attention.py) runs only inside
    # ``parallel.wavlm_forward_sp``, which sets the ring's axis; it raises
    # anywhere else.
    attention_impl: str = "auto"
    # TPU knobs of the JAX package, kept so that configs and recipes carry
    # over; the port reads none of them (its kernel has fixed 64-row tiles
    # and "auto" does not depend on the clip length; the ring's axis is the
    # ``parallel.ModelAxis`` given to ``wavlm_forward_sp``, not a mesh axis's
    # name).
    flash_min_frames: int = 1280
    flash_score_budget: int = 8 << 30
    flash_block: int = 0
    flash_head_block: int = 8
    flash_exp_base2: bool = False
    ring_axis: str = "data"

    @staticmethod
    def tiny(**kw) -> "WavLMConfig":
        base = dict(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, conv_dim=(16, 16, 16),
                    conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                    num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4,
                    num_buckets=40, max_bucket_distance=100)
        base.update(kw)
        return WavLMConfig(**base)

    def output_length(self, n_samples: int) -> int:
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


def resolve_attention_impl(impl: str, device: torch.device,
                           dtype: torch.dtype = torch.float32, ring_axis=None) -> str:
    """"auto" is the kernel on the card, at any T, and its plain version on
    the CPU at bf16 (the kernel's semantics); einsum on the CPU at f32.
    "ring" only with a ring axis (set by ``parallel.wavlm_forward_sp``)."""
    if impl == "auto":
        return "flash" if device.type == "cuda" or dtype == torch.bfloat16 else "einsum"
    if impl == "ring":
        if ring_axis is None:
            raise ValueError("attention_impl='ring' needs a ring axis, which only "
                             "parallel.wavlm_forward_sp gives it")
        return impl
    if impl not in ("einsum", "flash"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    return impl


class Linear(nn.Linear):
    """nn.Linear; in bf16 the product is rounded before the bias is added,
    as flax's Dense with bf16 parameters does."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return F.linear(x, self.weight) + self.bias
        return super().forward(x)


class Conv1d(nn.Conv1d):
    """nn.Conv1d; in bf16 the convolution (f32 accumulate) is rounded before
    the bias is added, as the JAX model's ``_conv1d`` does. On the CPU the
    bf16 convolution runs on the widened inputs and is rounded once: torch's
    CPU bf16 grouped conv1d is wrong (relative error about 1 against f32 at
    groups 4, torch 2.13), and the f32 one is the same function."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        if x.device.type == "cpu":
            out = self._conv_forward(x.float(), self.weight.float(), None).to(x.dtype)
        else:
            out = self._conv_forward(x, self.weight, None)
        return out if self.bias is None else out + self.bias[:, None]


class ConvLayer(nn.Module):
    """One temporal conv of the feature encoder, with its norm and gelu."""

    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        in_dim = 1 if i == 0 else cfg.conv_dim[i - 1]
        dim = cfg.conv_dim[i]
        self.conv = Conv1d(in_dim, dim, cfg.conv_kernel[i],
                           stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        elif i == 0:   # "group": GroupNorm(groups = channels) on the first conv
            self.layer_norm = nn.GroupNorm(dim, dim, eps=1e-5)
        else:
            self.layer_norm = None

    def forward(self, x):                          # [B, C, S]
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """Temporal conv stack: raw wav [B, S] -> frame features [B, T, C]."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wav):
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, feats):
        return self.projection(self.layer_norm(feats))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding; the weight norm is folded into
    ``conv.weight`` at conversion."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups)
        self.trim = k % 2 == 0                     # HF's SamePad

    def forward(self, x):                          # [B, T, D]
        out = self.conv(x.transpose(1, 2))
        if self.trim:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class WavLMAttention(nn.Module):
    """Self-attention with the shared bucketed relative position bias and the
    per-layer gru_rel_pos gate (HF WavLMAttention), over ``heads`` heads:
    all of them here, a rank's in ``TPWavLMAttention``. ``ring_axis`` (a
    ``parallel.ModelAxis``, set only within ``parallel.wavlm_forward_sp``) is
    the axis of ``attention_impl="ring"``: x is then this rank's slice of the
    frames."""

    ring_axis = None

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.hidden_size, cfg.num_heads
        self.heads = H
        self.q_proj = Linear(D, D)
        self.k_proj = Linear(D, D)
        self.v_proj = Linear(D, D)
        self.out_proj = Linear(D, D)
        if cfg.use_rel_pos_bias:
            self.gru_rel_pos_linear = Linear(D // H, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)

    def _gate_input(self, x):
        """[B, heads, T, hd]: the heads of the (replicated) input that the
        gate reads."""
        B, T, D = x.shape
        return x.view(B, T, self.cfg.num_heads, D // self.cfg.num_heads).transpose(1, 2)

    def forward(self, x, position_bias=None, pad_mask=None):
        """x [B, T, D], pad_mask [B, T] bool (True attends). Returns (out,
        position_bias): the einsum path carries the [H, T, T] bias across
        layers, the kernel path its [H, 2T - 1] diagonal form, the ring its
        [P, H, 2T - 1] diagonals, one per key block (JAX's ring carries the
        embedding and rebuilds each step's bias, wavlm.py:305-319)."""
        cfg = self.cfg
        B, T, D = x.shape
        H = self.heads
        hd = D // cfg.num_heads
        q = self.q_proj(x).view(B, T, H, hd)
        k = self.k_proj(x).view(B, T, H, hd)
        v = self.v_proj(x).view(B, T, H, hd)

        if not cfg.use_rel_pos_bias:               # wav2vec2 / HuBERT
            scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
            if pad_mask is not None:
                scores = scores.masked_fill(~pad_mask[:, None, None, :], NEG)
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * hd)
            return self.out_proj(out), None

        impl = resolve_attention_impl(cfg.attention_impl, x.device, x.dtype, self.ring_axis)
        if position_bias is None:                  # layer 0: built once per forward
            rel_embed = self.rel_attn_embed.weight
            if impl == "einsum":
                buckets = relative_position_buckets(T, T, cfg.num_buckets, cfg.max_bucket_distance)
                position_bias = rel_embed[buckets.to(x.device, torch.long)].permute(2, 0, 1)
            elif impl == "ring":
                position_bias = ring_bias_diags(rel_embed, T, self.ring_axis, cfg.num_buckets,
                                                cfg.max_bucket_distance)
            else:
                position_bias = bias_diag_for(rel_embed, T, cfg.num_buckets,
                                              cfg.max_bucket_distance)

        gated = self._gate_input(x)                                        # [B, H, T, hd]
        proj = self.gru_rel_pos_linear(gated).view(B, H, T, 2, 4).sum(-1)  # [B, H, T, 2]
        gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)              # [B, H, T, 1]
        gate_out = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0

        if impl == "ring":
            kvalid = (torch.ones(B, T, device=x.device) if pad_mask is None
                      else pad_mask.float())
            out = ring_gated_attention(
                q, k, v, gate_out[..., 0], kvalid, None, axis=self.ring_axis,
                num_buckets=cfg.num_buckets, max_distance=cfg.max_bucket_distance,
                bias_diags=position_bias)
            return self.out_proj(out.reshape(B, T, H * hd)), position_bias

        if impl == "flash":
            out = flash_gated_attention(
                q, k, v, gate_out[..., 0].contiguous(), None, pad_mask, position_bias,
                num_buckets=cfg.num_buckets, max_distance=cfg.max_bucket_distance)
            return self.out_proj(out.reshape(B, T, H * hd)), position_bias

        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        scores = scores + gate_out * position_bias[None]
        if pad_mask is not None:
            scores = scores.masked_fill(~pad_mask[:, None, None, :], NEG)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * hd)
        return self.out_proj(out), position_bias


class FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, h):
        return self.output_dense(F.gelu(self.intermediate_dense(h)))


class TPWavLMAttention(WavLMAttention):
    """A rank's ``num_heads / world`` heads: q, k and v (weights and biases)
    split by head, as are ``gru_rel_pos_const`` and ``rel_attn_embed`` (so
    the bias, and its diagonal form, is built from the rank's own columns);
    the gate reads the rank's heads of the replicated input; ``out_proj``
    split by its input (``RowParallelLinear``)."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool, axis):
        nn.Module.__init__(self)
        self.cfg, self.axis = cfg, axis
        D, H = cfg.hidden_size, cfg.num_heads
        hd = D // H
        self.heads = H // axis.world
        width = self.heads * hd
        self.q_proj = Linear(D, width)
        self.k_proj = Linear(D, width)
        self.v_proj = Linear(D, width)
        self.out_proj = RowParallelLinear(width, D, axis, bias=True)
        if cfg.use_rel_pos_bias:
            self.gru_rel_pos_linear = Linear(hd, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, self.heads, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, self.heads)

    def _gate_input(self, x):
        first = self.axis.rank * self.heads
        return super()._gate_input(x)[:, first:first + self.heads]


class TPFeedForward(FeedForward):
    """A rank's ``intermediate_size / world`` columns: intermediate_dense
    split by output (weight and bias), output_dense by input
    (``RowParallelLinear``)."""

    def __init__(self, cfg: WavLMConfig, axis):
        nn.Module.__init__(self)
        inner = cfg.intermediate_size // axis.world
        self.intermediate_dense = Linear(cfg.hidden_size, inner)
        self.output_dense = RowParallelLinear(inner, cfg.hidden_size, axis, bias=True)


class EncoderLayer(nn.Module):
    """Pre-LN ("stable layer norm", wavlm-large) or post-LN per config."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, position_bias=None, pad_mask=None):
        if self.stable:
            h, position_bias = self.attention(self.layer_norm(x), position_bias, pad_mask)
            x = x + h
            x = x + self.feed_forward(self.final_layer_norm(x))
        else:
            h, position_bias = self.attention(x, position_bias, pad_mask)
            x = self.layer_norm(x + h)
            x = self.final_layer_norm(x + self.feed_forward(x))
        return x, position_bias


class Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, has_relative_position_bias=(i == 0))
            for i in range(cfg.num_layers))


class WavLMModel(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def prologue(self, wav, pad_mask: Optional[torch.Tensor] = None):
        """Everything before the transformer stack. ``pad_mask`` is the
        frame-level [B, T] bool mask (True = real frame); padded frames are
        zeroed before the positional conv, as HF does."""
        x = self.feature_projection(self.feature_extractor(wav))
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[:, :, None], 0.0)
        x = x + self.encoder.pos_conv_embed(x)
        if not self.cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
        return x

    def encoder_stack(self, x, frame_mask: Optional[torch.Tensor] = None,
                      output_hidden_states: bool = False):
        """The transformer layers (+ final LN for pre-LN variants)."""
        hidden_states = [x] if output_hidden_states else None
        position_bias = None
        for layer in self.encoder.layers:
            x, position_bias = layer(x, position_bias, frame_mask)
            if output_hidden_states:
                hidden_states.append(x)
        if self.cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
            if output_hidden_states:
                hidden_states[-1] = x
        return x, (tuple(hidden_states) if output_hidden_states else None)

    def forward(self, wav, pad_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False):
        """wav [B, S] (zero-mean / unit-var per clip). Returns
        last_hidden_state [B, T, D] and, if asked, hidden_states (num_layers
        + 1 taps, HF's convention: entry 0 is the post-pos-conv input, the
        last is post-final-LN)."""
        x = self.prologue(wav, pad_mask)
        x, hidden_states = self.encoder_stack(x, pad_mask, output_hidden_states)
        return {"last_hidden_state": x, "hidden_states": hidden_states}


def tp_model_from_state_dict(cfg: WavLMConfig, state_dict, specs, axis) -> WavLMModel:
    """A rank's tensor-parallel WavLMModel: built on the meta device, each
    layer's attention and feed-forward replaced by their tensor-parallel
    forms where ``specs`` (``parallel.sharding.wavlm_specs``) split their
    weights, and given the rank's tensors as they are, in eval mode."""

    def split(suffix: str) -> bool:
        return any(d is not None for k, d in specs.items() if k.endswith(suffix))

    with torch.device("meta"):
        model = WavLMModel(cfg)
        for i, layer in enumerate(model.encoder.layers):
            if split("attention.q_proj.weight"):
                layer.attention = TPWavLMAttention(cfg, i == 0, axis)
            if split("feed_forward.intermediate_dense.weight"):
                layer.feed_forward = TPFeedForward(cfg, axis)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.eval()
