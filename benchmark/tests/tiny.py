"""Tiny versions of the cells, for the CPU tests: the configurations at
toy widths, the traffic at toy lengths, the real limits of the checks."""

from __future__ import annotations

import copy

from benchmark.lib import spec

CELLS = [w["name"] for w in spec.benchmark_spec()["workloads"]]
FUSION = dict(input_dims=[24, 40, 16], feat4_dim=40, general_dim=16, layers=[16, 8],
              fused_layers=[16, 16], rnc_proj_dim=8, length_buckets=[8, 16, 32, 64, 128])
FUSION_LENGTHS = {"audio": [5, 40], "text": [2, 12], "video": [3, 20], "feat4": [2, 8]}
WAVLM = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
             conv_dim=[16, 16, 16], conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=40,
             max_bucket_distance=100, tap=-2)


def cell(name: str):
    """(spec, cell, cfg) of cell `name` at toy sizes."""
    bench = spec.benchmark_spec()
    c = copy.deepcopy(spec.cell(name))
    cfg = spec.config(c["config"])
    p = c["traffic_params"]
    if c["config"] == "sdumc-fusion":
        cfg.update(FUSION)
        p.update(batch_size=6, pool_clips=8, lengths=FUSION_LENGTHS)
        p["clips_per_epoch"] = 24
    else:
        cfg.update(WAVLM)
        p.update(waves_per_request=6, seconds=[0.05, 0.3], pool_seconds=2)
        c["check_clips"] = 4
    return bench, c, cfg
