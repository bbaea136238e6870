"""The frozen counts equal what torch.utils.flop_counter counts of the plain
references at toy widths."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import fusion as cf
from benchmark.counts import peaks
from benchmark.counts import wavlm as cw
from benchmark.lib import seeds, weights
from benchmark.reference import fusion as rf
from benchmark.reference import wavlm as rw
from benchmark.reference.precision import Precision
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def _fusion_batch(cfg, B, ta, tt, tf, tv):
    Da, Dt, Dv = cfg["input_dims"]
    g = torch.Generator().manual_seed(0)
    return {"audio": torch.randn(B, ta, Da, generator=g), "text": torch.randn(B, tt, Dt, generator=g),
            "feat4": torch.randn(B, tf, Dt, generator=g), "video": torch.randn(B, tv, Dv, generator=g),
            "vals": torch.rand(B, generator=g), "buckets": (64, 16, 32)}


def test_fusion_forward_and_loss_counts():
    _, _, cfg = tiny.cell("fusion-train-mosei")
    params = weights.state_dict(rf.weight_layout(cfg), 1, CPU)
    B, t = 5, (37, 11, 11, 19)
    batch = _fusion_batch(cfg, B, *t)
    drops = rf.Drops(None, 0.0, 0.0)
    got = _counted(lambda: rf.forward_dual(params, batch, cfg, Precision("f32"), drops))
    assert got == cf.forward_flops(cfg, B, *t)
    feats = torch.randn(2 * B, cfg["rnc_proj_dim"])
    got = _counted(lambda: rf.rnc_loss(Precision("f32"), feats, batch["vals"], 2.0))
    assert got == cf.loss_flops(B)
    assert cf.train_step_flops(cfg, B, t) == 3 * (cf.forward_flops(cfg, B, *t) + cf.loss_flops(B))


def test_fusion_count_leaves_out_the_student_rows_padding():
    """With feat4 shorter than text, the reference pads the stacked text
    stream to the longer; the count takes each view's own length."""
    _, _, cfg = tiny.cell("fusion-train-mosei")
    params = weights.state_dict(rf.weight_layout(cfg), 1, CPU)
    B, t = 4, (20, 12, 7, 9)
    batch = _fusion_batch(cfg, B, *t)
    got = _counted(lambda: rf.forward_dual(params, batch, cfg, Precision("f32"),
                                           rf.Drops(None, 0.0, 0.0)))
    d = cfg["general_dim"]
    padding = B * (t[1] - t[2])                         # student text frames padded
    per_frame = (2 * d * d + 4 * d) + (2 * d * d + 4 * 7 * d)   # the pool, the cross attention
    assert got - cf.forward_flops(cfg, B, *t) == padding * per_frame


def test_fusion_kernel_call_counts():
    _, _, cfg = tiny.cell("fusion-train-mosei")
    d = cfg["general_dim"]
    R, T = 6, 13
    x = torch.randn(R, T, d)
    w, b = torch.randn(d, d), torch.randn(d)
    lengths = torch.full((R,), T)
    pool = _counted(lambda: rf._frame_attention(Precision("f32"), torch.randn(d), x, w, b,
                                                lengths, 0.3))
    cross = _counted(lambda: rf._frame_attention(Precision("f32"), torch.randn(R, 7, d), x, w, b,
                                                 lengths, 0.3))
    calls = cf.kernel_calls(cfg, R // 2, (T, T, T, T))
    assert [c[0] for c in calls] == [pool] * 3 + [cross] * 3


def test_wavlm_counts():
    _, _, cfg = tiny.cell("wavlm-extract-mosei")
    params = weights.state_dict(rw.weight_layout(cfg), seeds.derive(1, "weights"), CPU)
    wave = np.random.default_rng(0).standard_normal(3001).astype(np.float32)
    layers = cw.tap_layers(cfg, cfg["tap"])
    got = _counted(lambda: rw.forward_tap(params, cfg, wave, Precision("f32"), layers))
    assert got == cw.clip_flops(cfg, len(wave), layers)
    assert cw.frames(cfg, len(wave)) == rw.output_frames(cfg, len(wave))
    T, D, H = 40, cfg["hidden_size"], cfg["num_attention_heads"]
    q = torch.randn(T, H, D // H)
    attn = _counted(lambda: Precision("f32").einsum(
        "hts,shd->thd", Precision("f32").einsum("thd,shd->hts", q, q).softmax(-1), q))
    assert cw.attention_call(cfg, [T])[0] == attn


def test_peaks_table():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert p["tf32_flops"] == 494.7e12 and p["hbm_bytes_per_s"] == 3.352e12
    assert peaks("cpu") is None
