"""Products of WavLM's forward to a tap, per clip at its own length, and the
work of its attention kernel's calls.

A clip of S samples: the conv encoder (each conv 2 T_out C_out C_in k /
groups), the feature projection, the positional conv (its T + 1 outputs
before the last is cut), and in each layer up to the tap the q, k, v and
output projections, the gate's projection, attention's two products (2 T^2
D each) and the feed-forward. Frames are the clip's own, never a bucket's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def frames(cfg: Dict, n_samples: int) -> int:
    t = n_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
    return t


def clip_flops(cfg: Dict, n_samples: int, layers: int) -> int:
    """Products of one clip through the conv encoder, the projection, the
    positional conv and the first `layers` transformer layers."""
    flops, t, c_in = 0, n_samples, 1
    for c, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        flops += 2 * t * c * c_in * k
        c_in = c
    D, H, I = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    K, G = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    flops += 2 * t * c_in * D
    flops += 2 * (t + 2 * (K // 2) - K + 1) * D * (D // G) * K
    per_layer = 8 * t * D * D + 2 * t * D * 8 + 4 * t * t * D + 4 * t * D * I
    return flops + layers * per_layer


def attention_call(cfg: Dict, clip_frames: Sequence[int]) -> Tuple[int, int]:
    """(flops, bytes) of one attention call over a batch of clips of
    `clip_frames` valid frames: each clip's 4 T^2 D products; q, k, v and
    the gate read and the output written for its valid frames, the bias
    diagonal [H, 2T - 1] of the longest and the key mask read once (f32)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    flops = sum(4 * t * t * D for t in clip_frames)
    T = max(clip_frames)
    bytes_ = 4 * sum(4 * t * D + t * H for t in clip_frames) + 4 * H * (2 * T - 1)
    bytes_ += len(clip_frames) * T
    return flops, bytes_


def tap_layers(cfg: Dict, tap: int) -> int:
    """The layers that run before hidden_states[tap] (a negative tap counts
    from the end of the layer count + 1 entries)."""
    n = cfg["num_hidden_layers"] + 1
    return tap % n
