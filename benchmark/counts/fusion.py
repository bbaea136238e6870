"""Products of the fusion net's dual-view step, and the work of its
frame-attention kernel's calls.

A batch of B clips at its own maximum lengths (ta, tt, tf, tv: audio,
text, feat4, video; the reference's batch-max padding, never the bucket's)
runs the two views as 2B rows: the audio and video projections once for
both views, the text projection for each view's stream, every later layer
on the 2B rows, and each row's frame attention over its own view's frames.
A product of an [m, k] by [k, n] is 2 m k n. The train step counts the
forward, the backward's products at twice the forward's, and the loss's
one product (RnC's masked sum); the optimizer and elementwise work count
nothing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Q = 7   # the cross attention's queries


def _frames(B: int, ta: int, tt: int, tf: int, tv: int):
    """Frames over the 2B rows of each stream: (audio, text, video)."""
    return 2 * B * ta, B * (tt + tf), 2 * B * tv


def forward_flops(cfg: Dict, B: int, ta: int, tt: int, tf: int, tv: int) -> int:
    Da, Dt, Dv = cfg["input_dims"]
    d = cfg["general_dim"]
    f0, f1 = cfg["fused_layers"]
    l0, l1 = cfg["layers"]
    r = cfg["rnc_proj_dim"]
    R = 2 * B
    n_a, n_t, n_v = _frames(B, ta, tt, tf, tv)
    n = n_a + n_t + n_v
    flops = 2 * B * d * (ta * Da + tv * Dv + (tt + tf) * Dt)        # input projections
    flops += 2 * n * d * d + 4 * n * d                               # 3 pools (Q = 1)
    flops += 3 * 2 * R * (d * f0 + f0 * f1)                          # modality MLPs
    flops += 2 * R * (3 * f1 * f0 + f0 * f1) + 2 * R * f1 * 3        # attention MLP, fc_att
    flops += 2 * R * f1 * (3 + 3 * 2)                                # the 4 weighted sums
    flops += 7 * 2 * R * f1 * d                                      # 7 query MLPs
    flops += 3 * 2 * R * Q * d * d                                   # 3 query projections
    flops += 2 * n * d * d + 4 * n * Q * d                           # 3 cross attentions
    flops += 3 * 2 * R * Q * (d * l0 + l0 * l1)                      # cross MLPs
    flops += 2 * R * Q * l1 * 3                                      # re-weighting
    flops += 2 * R * (Q * l1 * l0 + l0 * l1) + 2 * R * l1 * Q        # cross attention MLP, fc
    flops += 2 * R * l1 * Q                                          # the 7-slot collapse
    flops += 2 * R * l1 * cfg["output_dim"] + 2 * R * (l1 * r + r * r)   # heads
    return flops


def loss_flops(B: int) -> int:
    n = 2 * B
    return 2 * n * n * n


def train_step_flops(cfg: Dict, B: int, t_max: Tuple[int, int, int, int]) -> int:
    return 3 * (forward_flops(cfg, B, *t_max) + loss_flops(B))


def kernel_calls(cfg: Dict, B: int, t_max: Tuple[int, int, int, int]) -> List[Tuple[int, int]]:
    """(flops, bytes) of each frame-attention call of one dual-view forward
    (3 pools, then 3 cross attentions), from the work its inputs need: the
    key projection 2 d^2, the scores and the weighted sum 2 Q d each, per
    valid frame; x read up to each row's length, the projection, the
    queries and the lengths read once, the output written once (f32)."""
    d = cfg["general_dim"]
    R = 2 * B
    frames = _frames(B, *t_max)
    calls = []
    for q in (1, Q):
        for n in frames:
            flops = 2 * n * d * d + 4 * n * q * d
            queries = d if q == 1 else R * q * d
            bytes_ = 4 * (n * d + d * d + d + queries + R * q * d + R)
            calls.append((flops, bytes_))
    return calls
