#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdumc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --ab OTHER      # phases 2-3 only, for this checkout's
                                          # kernels and OTHER's (the root of
                                          # another checkout), in turns

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: the card's name and power limit, then the kernel build
     from the sources in this checkout (all sources compile in parallel);
  2. the fusion kernel against its plain PyTorch version on the card, at the
     shapes of the inference path's first dual batch (B = 64 rows, D = 256,
     the audio / text / video buckets), once with mixed per-row t_max and
     once with the batch's own lengths, which are also timed (CUDA events,
     and device time per call from torch.profiler) beside the plain version
     and the bound;
  3. the WavLM attention kernel against its plain version at wavlm-large's
     H = 16, hd = 64, for a 5-s bucket batch (B = 8, T = 249) and the 60-s
     clip (B = 1, T = 2999), with mixed key masks, timed the same way beside
     the plain version, the bound and one scaled_dot_product_attention call;
  4. the inference path: ``sdumc_tpu_torch.cli.infer.main`` on the
     synthetic store at the full published width (1024/4096/1024 -> 256,
     batch 32, dual view, seeded weights), with every launch counter set to
     0 before and read after it, and the first batch's predictions held
     against the same model's plain path on the CPU;
  5. the extraction path: ``sdumc_tpu_torch.cli.extract.main(["audio",
     ...])`` with its defaults on a seeded wavlm-large HF-format directory
     and 17 seeded wavs (16 of 2-24 s and one of 60 s), with the launch
     counters around it, every saved feature checked for shape and
     finiteness, and one short clip held against the plain path on the CPU.
  6. a second (warm) extraction of the same wavs under torch.profiler:
     device time by kernel and by family (attention kernel, convolutions,
     GEMMs, copies, the rest) and the device's busy share of the host-clock
     window.
The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or sdumc_tpu.

A bound is the least time the card could take for the call: the larger of
its bytes (each input read once, the output written once) at the HBM rate
and its operations at the rate of the units the kernel runs them on. Both
kernels run their matrix products on the tensor cores in the 3xTF32 split
(three TF32 passes, f32-grade results), so those flops count three times at
the TF32 rate; the fusion kernel's scores and weighted sum are f32 FMA and
count once at the f32 rate. The f32 bound (every flop at the f32 rate, the
bound of the earlier FFMA kernels) is printed beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores
TF32_PASSES = 3               # the 3xTF32 split: hi.hi + hi.lo + lo.hi
PEAK_HBM_BYTES = 3.35e12      # bytes/s
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # f32 reassociation over <= 2048 frames
MODEL_RTOL, MODEL_ATOL = 1e-3, 1e-4     # f32 reassociation through the whole net
B_DUAL, D = 64, 256
MAIN_ARGV = ["--synthetic", "--batch_size", "32", "--device", "cuda"]
REPLACES = {
    7: ("fused_cross", "sdumc_tpu/ops/pallas/fused_cross.py:37"),
    1: ("fused_pool", "sdumc_tpu/ops/pallas/fused_pool.py:32"),
}
SOURCE = "sdumc_tpu_torch/csrc/fused_cross.cu"
FLASH = {"name": "flash_wavlm", "source": "sdumc_tpu_torch/csrc/flash_wavlm.cu",
         "replaces": "sdumc_tpu/ops/pallas/flash_wavlm.py:140"}
FLASH_SHAPES = ((8, 249), (1, 2999))   # a 5-s bucket batch, the 60-s clip
FLASH_H, FLASH_HD = 16, 64             # wavlm-large's heads
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5    # f32, summed in another order over <= 3000 keys
FEAT_RTOL, FEAT_ATOL = 1e-3, 1e-3      # f32 reassociation through 20 of 24 layers
N_CLIPS, LONG_CLIP_S = 16, 60.0
# (family, name fragments) of the extraction's device kernels, matched in order
EXTRACTION_FAMILIES = (
    ("flash_wavlm kernel", ("flash_wavlm",)),
    ("cuDNN convolutions", ("conv", "fprop", "dgrad", "wgrad")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "sm80_xmma", "sm90_xmma")),
    ("memory copies", ("memcpy", "memset")),
)


def main_path_config():
    """The ExperimentConfig that ``cli.infer.main(MAIN_ARGV)`` runs with."""
    from sdumc_tpu_torch.cli.common import add_reference_args, add_runtime_args, args_to_config

    parser = argparse.ArgumentParser()
    add_reference_args(parser)
    add_runtime_args(parser)
    return args_to_config(parser.parse_args(MAIN_ARGV))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, names, calls: int = 20) -> float:
    """Device time per call of the kernels whose names contain one of
    `names`, from torch.profiler over `calls` warm calls: the kernel time
    without the wrapper's host overhead (NaN if no trace holds them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and any(n in e.key for n in names))
        if total > 0:
            return total / 1e3 / calls
    return math.nan


def bound_ms(q_count: int, t_valid, shared_query: bool):
    """Least time for one call, as {"bytes", "operations", "f32"} in ms:
    each input read once (x only up to each row's t_max) and the output
    written once, over the HBM rate; the key projection (2 D^2 per valid
    frame) in 3xTF32 over the TF32 rate plus bias + tanh (2 D), scores and
    weighted sum (4 Q D) over the f32 rate; and every flop over the f32
    rate, the earlier bound."""
    n = int(sum(t_valid))
    rows = len(t_valid)
    q_bytes = (1 if shared_query else rows) * q_count * D * 4
    nbytes = q_bytes + n * D * 4 + D * D * 4 + D * 4 + rows * 4 + rows * q_count * D * 4
    mma, ffma = n * 2 * D * D, n * (2 * D + 4 * q_count * D)
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES,
            "operations": 1e3 * (TF32_PASSES * mma / PEAK_TF32_FLOPS + ffma / PEAK_F32_FLOPS),
            "f32": 1e3 * (mma + ffma) / PEAK_F32_FLOPS}


def main_path_lengths(cfg):
    """{modality: (T, t_max)} of the main path's first dual batch: audio and
    video share one batch max over all 2B rows (an int, as the model passes
    it), the text stream carries per-row lengths (gt rows, then feat4 rows)
    padded to a common bucket."""
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders

    _, _, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    batch = next(iter(BatchIterator(test_ds, cfg.data.batch_size, shuffle=False,
                                    buckets=cfg.data.length_buckets, prefetch=0)))
    ta, tt, tv, tf4 = batch.t_max
    half = B_DUAL // 2
    return {"audio": (batch.audio.shape[1], ta),
            "text": (max(batch.text.shape[1], batch.feat4.shape[1]), [tt] * half + [tf4] * half),
            "video": (batch.video.shape[1], tv)}


def kernel_phase(torch, fused_cross, fused_pool, lengths):
    """Each kernel vs its plain version on the card: for correctness with
    mixed per-row t_max (= T, not a tile multiple, 1, 0, > T), then timed at
    the main path's lengths. Returns per-Q totals over the three modality
    calls of one dual batch."""
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    totals = {q: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                  "bytes_ms": 0.0, "operations_ms": 0.0, "f32_bound_ms": 0.0,
                  "device_ms": 0.0, "calls": {}} for q in REPLACES}
    print(f"kernel vs plain (B={B_DUAL}, D={D}; tolerance rtol={KERNEL_RTOL} "
          f"atol={KERNEL_ATOL}: f32 reassociation over <= 2048 frames)")
    for modality, (T, t_main) in lengths.items():
        x = (0.5 * torch.randn(B_DUAL, T, D, generator=gen)).to(dev)
        w = ((torch.rand(D, D, generator=gen) * 2 - 1) / 16).to(dev)
        b = ((torch.rand(D, generator=gen) * 2 - 1) / 16).to(dev)
        query = (0.5 * torch.randn(B_DUAL, 7, D, generator=gen)).to(dev)
        context = (0.1 * torch.randn(D, generator=gen)).to(dev)
        mixed = torch.randint(1, T + 1, (B_DUAL,), generator=gen, dtype=torch.int32)
        mixed[:5] = torch.tensor([T, max(1, T - 37), 1, 0, T + 5])
        mixed = mixed.to(dev)
        if isinstance(t_main, list):
            t_valid, t_main = t_main, torch.tensor(t_main, dtype=torch.int32, device=dev)
        else:
            t_valid = [t_main] * B_DUAL
        for q_count in REPLACES:
            if q_count == 7:
                def kern(t):
                    return fused_cross.fused_cross_attention(query, x, w, b, t)

                def plain(t):
                    return fused_cross.fused_cross_attention_plain(query, x, w, b, t)
            else:
                def kern(t):
                    return fused_pool.fused_attention_pool(x, w, b, context, t)

                def plain(t):
                    return fused_pool.fused_attention_pool_plain(x, w, b, context, t)
            with torch.inference_mode():
                errs = []
                for t in (mixed, t_main):
                    got, ref = kern(t), plain(t)
                    torch.cuda.synchronize()
                    errs.append((got - ref).abs().max().item())
                    if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                        raise AssertionError(
                            f"{REPLACES[q_count][0]} at T={T}: max abs err {errs[-1]} "
                            f"outside rtol={KERNEL_RTOL} atol={KERNEL_ATOL}")
                ms, plain_ms = time_ms(lambda: kern(t_main)), time_ms(lambda: plain(t_main))
                dev_ms = device_ms(torch, lambda: kern(t_main), ("cross_",))
            bnd = bound_ms(q_count, t_valid, q_count == 1)
            tot = totals[q_count]
            tot["bytes_ms"] += bnd["bytes"]
            tot["operations_ms"] += bnd["operations"]
            tot["f32_bound_ms"] += bnd["f32"]
            tot["ms"] += ms
            tot["device_ms"] += dev_ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += max(bnd["bytes"], bnd["operations"])
            tot["max_abs_err"] = max(tot["max_abs_err"], *errs)
            tot["calls"][modality] = ms
            print(f"  {REPLACES[q_count][0]:11s} {modality:5s} T={T:4d} "
                  f"t_max={sorted(set(t_valid))} frames={sum(t_valid)} "
                  f"max_abs_err mixed={errs[0]!r} main={errs[1]!r} "
                  f"kernel_ms={ms!r} device_ms={dev_ms!r} plain_ms={plain_ms!r} "
                  f"bound_ms={max(bnd['bytes'], bnd['operations'])!r} "
                  f"(bytes {bnd['bytes']!r}, operations {bnd['operations']!r}; "
                  f"f32 bound {bnd['f32']!r})")
    return totals


def reset_counts():
    from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross

    fused_cross.reset_launches()
    flash_wavlm.reset_launches()


def read_counts() -> dict:
    """{kernel name: launches}, every kernel of the port."""
    from sdumc_tpu_torch.ops.kernels import flash_wavlm, fused_cross

    counts = {REPLACES[q][0]: n for q, n in fused_cross.LAUNCHES.items()}
    counts[FLASH["name"]] = flash_wavlm.LAUNCHES
    return counts


def flash_bound_ms(B, T, n_valid, num_buckets=320):
    """Least time for one call, as {"bytes", "operations", "f32"} in ms: q,
    k, v, the gate, rel_embed and kvalid read once and out written once,
    over the HBM rate; QK^T and PV (4 hd flops per query and valid key) in
    3xTF32 over the TF32 rate; and the same flops over the f32 rate, the
    earlier bound. Keys that a row masks need no work, so only valid keys
    count."""
    H, hd = FLASH_H, FLASH_HD
    nbytes = 4 * (4 * B * T * H * hd + B * H * T + num_buckets * H + B * T)
    flops = 4 * H * hd * T * int(sum(n_valid))
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES,
            "operations": 1e3 * TF32_PASSES * flops / PEAK_TF32_FLOPS,
            "f32": 1e3 * flops / PEAK_F32_FLOPS}


def flash_phase(torch, flash_wavlm):
    """The WavLM attention kernel vs its plain version at wavlm-large's
    shapes, then timed beside the plain version, the bound and SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    kw = dict(num_buckets=320, max_distance=800)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "operations_ms": 0.0, "f32_bound_ms": 0.0, "max_abs_err": 0.0,
           "device_ms": 0.0, "calls": {}}
    print(f"flash_wavlm vs plain (H={FLASH_H}, hd={FLASH_HD}; tolerance rtol={FLASH_RTOL} "
          f"atol={FLASH_ATOL}: f32, summed in another order over <= 3000 keys)")
    for B, T in FLASH_SHAPES:
        rows = max(B, 3)        # correctness: one row at T, one at T - 37, one at 1
        q, k, v = (torch.randn(rows, T, FLASH_H, FLASH_HD, generator=gen).to(dev)
                   for _ in range(3))
        gate = (1 + torch.rand(rows, FLASH_H, T, generator=gen)).to(dev)
        rel = torch.randn(320, FLASH_H, generator=gen).to(dev)
        lengths = torch.randint(1, T + 1, (rows,), generator=gen)
        lengths[:3] = torch.tensor([T, T - 37, 1])
        kvalid = (torch.arange(T)[None, :] < lengths[:, None]).float().to(dev)
        with torch.inference_mode():
            diag = flash_wavlm.bias_diag_for(rel, T, **kw)
            got = flash_wavlm.flash_gated_attention(q, k, v, gate, None, kvalid, diag, **kw)
            ref = flash_wavlm.flash_gated_attention_plain(q, k, v, gate, None, kvalid, diag, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=FLASH_RTOL, atol=FLASH_ATOL):
                raise AssertionError(f"flash_wavlm at B={rows} T={T}: max abs err {err!r} "
                                     f"outside rtol={FLASH_RTOL} atol={FLASH_ATOL}")
            # timed at the slice's shape: the first B rows (B = 1: the full row)
            args = [t[:B].contiguous() for t in (q, k, v, gate)]
            mask_b = kvalid[:B].contiguous()
            def kern():
                return flash_wavlm.flash_gated_attention(*args, None, mask_b, diag, **kw)

            ms = time_ms(kern)
            dev_ms = device_ms(torch, kern, ("flash_wavlm",))
            plain_ms = time_ms(lambda: flash_wavlm.flash_gated_attention_plain(
                *args, None, mask_b, diag, **kw))
            # SDPA on the same function: heads-first q/k/v and a materialised
            # f32 mask gate * bias + keymask, all built outside the timed region
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in args[:3])
            attn_mask = (args[3][..., None] * flash_wavlm.dense_bias(diag, T)[None]
                         + torch.where(mask_b > 0, 0.0, flash_wavlm.NEG)[:, None, None, :])
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask))
            lib_err = (F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask)
                       .transpose(1, 2) - ref[:B]).abs().max().item()
        bnd = flash_bound_ms(B, T, lengths[:B].tolist())
        least = max(bnd["bytes"], bnd["operations"])
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", least), ("bytes_ms", bnd["bytes"]),
                         ("operations_ms", bnd["operations"]), ("f32_bound_ms", bnd["f32"]),
                         ("device_ms", dev_ms)):
            tot[key] += val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["calls"][f"B={B} T={T}"] = ms
        print(f"  flash_wavlm B={B} T={T} valid keys={lengths[:B].tolist() if B > 1 else T} "
              f"max_abs_err={err!r} (checked at B={rows}) kernel_ms={ms!r} device_ms={dev_ms!r} "
              f"plain_ms={plain_ms!r} sdpa_ms={lib_ms!r} (sdpa max abs diff {lib_err!r}) "
              f"bound_ms={least!r} (bytes {bnd['bytes']!r}, operations {bnd['operations']!r}; "
              f"f32 bound {bnd['f32']!r})")
    return tot


def main_path_phase(torch, fused_cross):
    from sdumc_tpu_torch.cli import infer
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict, make_eval_step

    reset_counts()
    t0 = time.perf_counter()
    out = infer.main(MAIN_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launches = dict(fused_cross.LAUNCHES)

    cfg = main_path_config()
    train_ds, _, test_ds = get_loaders(cfg.data.dataset, cfg.data, cfg.paths, synthetic=True)
    n_batches = math.ceil(len(test_ds) / cfg.data.batch_size)
    for q_count in REPLACES:
        if launches.get(q_count, 0) != 3 * n_batches:
            raise AssertionError(f"{REPLACES[q_count][0]}: {launches.get(q_count, 0)} launches "
                                 f"on the main path, expected 3 x {n_batches} batches")
    res = out["results"]
    for key in ("val_preds_full", "val_preds_missing"):
        preds = res[key]
        if preds.shape != (len(test_ds),) or not all(map(math.isfinite, preds.tolist())):
            raise AssertionError(f"{key}: shape {preds.shape} or non-finite values")
    print(f"inference path: {len(test_ds)} clips in {n_batches} dual batches, "
          f"{seconds!r} s host clock (data generation and model init included); "
          f"launches {counts}")

    # first batch: card predictions vs the same weights' plain path on the CPU
    batch = next(iter(BatchIterator(test_ds, cfg.data.batch_size, shuffle=False,
                                    buckets=cfg.data.length_buckets, prefetch=0)))
    cpu = torch.device("cpu")
    model = build_model(cfg, train_ds.input_dims(), cpu)
    v0, v1 = make_eval_step(model)(batch_to_device_dict(batch, cpu))
    n = batch.size
    for name, ref, got in (("full", v0, res["val_preds_full"][:n]),
                           ("missing", v1, res["val_preds_missing"][:n])):
        got = torch.from_numpy(got)
        err = (got - ref).abs().max().item()
        print(f"first batch {name} view: card vs CPU plain max abs diff {err!r} "
              f"(tolerance rtol={MODEL_RTOL} atol={MODEL_ATOL}: f32 reassociation "
              f"through the whole net)")
        if not torch.allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            raise AssertionError(f"{name} view: card and CPU predictions disagree")
    print(f"metrics full: {out['full']}")
    print(f"metrics missing: {out['missing']}")
    return launches


def write_wavlm_dir(torch, path: str, seed: int = 0):
    """A seeded wavlm-large in HF's format: config.json with HF's key names
    (the port's WavLMConfig defaults, wavlm-large's widths) and
    pytorch_model.bin at the published shapes, normal(0, 0.02) as HF's init
    draws Linear and Embedding weights, biases 0, norms 1 / 0,
    gru_rel_pos_const 1, the positional conv in HF's weight_g / weight_v
    form. Returns the config."""
    from sdumc_tpu_torch.convert.hf_wavlm import config_from_hf, fold_weight_norm
    from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    d = WavLMConfig()
    config = {"model_type": "wavlm", "architectures": ["WavLMModel"],
              "hidden_size": d.hidden_size, "num_hidden_layers": d.num_layers,
              "num_attention_heads": d.num_heads, "intermediate_size": d.intermediate_size,
              "conv_dim": list(d.conv_dim), "conv_kernel": list(d.conv_kernel),
              "conv_stride": list(d.conv_stride), "conv_bias": d.conv_bias,
              "feat_extract_norm": d.feat_extract_norm,
              "do_stable_layer_norm": d.do_stable_layer_norm,
              "num_conv_pos_embeddings": d.num_conv_pos_embeddings,
              "num_conv_pos_embedding_groups": d.num_conv_pos_embedding_groups,
              "num_buckets": d.num_buckets, "max_bucket_distance": d.max_bucket_distance,
              "layer_norm_eps": d.layer_norm_eps}
    cfg = config_from_hf(config)
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in WavLMModel(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("gru_rel_pos_const") or (key.endswith("norm.weight")):
            sd[key] = torch.ones(shape)
        elif key.endswith(".bias"):
            sd[key] = torch.zeros(shape)
        else:
            sd[key] = 0.02 * torch.randn(shape, generator=gen)
    pre = "encoder.pos_conv_embed.conv."
    w = sd.pop(pre + "weight")
    sd[pre + "weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pre + "weight_v"] = w
    assert torch.allclose(fold_weight_norm(sd[pre + "weight_g"], w), w, rtol=1e-6, atol=1e-7)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return cfg


def write_wavs(path: str, seed: int = 0):
    """N_CLIPS 16-bit PCM wavs of seeded durations in 2-24 s and one of
    60 s (T = 2999 frames); {name: samples}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seconds = list(rng.uniform(2.0, 24.0, size=N_CLIPS)) + [LONG_CLIP_S]
    os.makedirs(path, exist_ok=True)
    clips = {}
    for i, sec in enumerate(seconds):
        n = int(round(sec * 16000))
        pcm = (np.clip(0.1 * rng.standard_normal(n), -1, 1) * 32767).astype("<i2")
        name = f"clip_{i:02d}"
        with wave.open(os.path.join(path, f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(pcm.tobytes())
        clips[name] = n
    return clips


def profile_extraction(torch, model_dir: str, audio_dir: str, top: int = 15):
    """A warm extraction of every wav in audio_dir under torch.profiler:
    device time by kernel, and the device's busy share of the window."""
    import glob

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm
    from sdumc_tpu_torch.extract.audio import extract_audio_features, read_wav

    cfg, model = load_hf_wavlm(model_dir)
    model.to("cuda")
    wavs = [read_wav(p) for p in sorted(glob.glob(os.path.join(audio_dir, "*.wav")))]
    extract_audio_features(model, cfg, wavs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_audio_features(model, cfg, wavs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profiled extraction (warm, same wavs): {wall!r} s host clock, device busy "
          f"{busy!r} s, idle share {1 - busy / wall!r}; device time by kernel:")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d} calls "
              f"{e.self_device_time_total / 1e6 / busy:7.2%}  {e.key[:90]}")
    families = {}
    for e in kernels:
        name = e.key.lower()
        family = next((f for f, keys in EXTRACTION_FAMILIES if any(k in name for k in keys)),
                      "elementwise, norms and the rest")
        ms, calls = families.get(family, (0.0, 0))
        families[family] = (ms + e.self_device_time_total / 1e3, calls + e.count)
    print("device time by family:")
    for family, (ms, calls) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} ms {calls:6d} calls {ms / 1e3 / busy:7.2%}  {family}")


def extraction_phase(torch, flash_wavlm):
    """cli.extract audio at wavlm-large's full width on the card."""
    import numpy as np

    from sdumc_tpu_torch.cli import extract
    from sdumc_tpu_torch.convert.hf_wavlm import load_hf_wavlm
    from sdumc_tpu_torch.extract.audio import extract_audio_features, plan_batches, read_wav

    with tempfile.TemporaryDirectory() as tmp:
        model_dir, audio_dir, save_dir = (os.path.join(tmp, n) for n in ("model", "wavs", "out"))
        cfg = write_wavlm_dir(torch, model_dir)
        clips = write_wavs(audio_dir)
        names = sorted(clips)
        n_batches = len(plan_batches(cfg, [clips[n] for n in names], 8))

        reset_counts()
        out = extract.main(["audio", "--model_dir", model_dir, "--audio_dir", audio_dir,
                            "--save_dir", save_dir])
        torch.cuda.synchronize()
        counts = read_counts()
        if out["batches"] != n_batches or counts[FLASH["name"]] != cfg.num_layers * n_batches:
            raise AssertionError(f"flash_wavlm: {counts[FLASH['name']]} launches in "
                                 f"{out['batches']} batches, expected {cfg.num_layers} x "
                                 f"{n_batches}")
        if not out["save_dir"].endswith("wavlm-large-FRA_-5"):
            raise AssertionError(f"output directory {out['save_dir']}")
        for name in names:
            feat = np.load(os.path.join(out["save_dir"], f"{name}.npy"))
            want = (cfg.output_length(clips[name]), cfg.hidden_size)
            if feat.shape != want or not np.isfinite(feat).all():
                raise AssertionError(f"{name}: shape {feat.shape} (want {want}) or non-finite")
        print(f"extraction path: {out['clips']} clips ({out['audio_seconds']!r} s of audio, "
              f"longest T={cfg.output_length(max(clips.values()))} frames) in {out['batches']} "
              f"batches, {out['seconds']!r} s host clock (weights on the card; wav reading "
              f"included, weight loading and wav writing excluded): "
              f"{out['audio_seconds'] / out['seconds']!r} audio s per s host clock; "
              f"launches {counts}")

        # the shortest clip: card features vs the same weights' plain path on the CPU
        short = min(names, key=clips.get)
        _, cpu_model = load_hf_wavlm(model_dir)
        wav = read_wav(os.path.join(audio_dir, f"{short}.wav"))
        ref = extract_audio_features(cpu_model, cfg, [wav], device="cpu")[0]
        got = np.load(os.path.join(out["save_dir"], f"{short}.npy"))
        err = float(np.abs(got - ref).max())
        print(f"{short} ({clips[short] / 16000!r} s): card vs CPU plain max abs diff {err!r}, "
              f"max |feature| {float(np.abs(ref).max())!r} (tolerance rtol={FEAT_RTOL} "
              f"atol={FEAT_ATOL}: f32 reassociation through 20 of 24 layers)")
        if not np.allclose(got, ref, rtol=FEAT_RTOL, atol=FEAT_ATOL):
            raise AssertionError(f"{short}: card and CPU features disagree")
        profile_extraction(torch, model_dir, audio_dir)
    return counts


def kernels_only(torch, root: str, lengths: dict) -> dict:
    """Phases 2-3 with the kernels of the checkout at `root`, built from its
    own sources into its own build/kernels/; per-kernel totals."""
    sys.path.insert(0, os.path.abspath(root))
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool

    build.build()
    totals = kernel_phase(torch, fused_cross, fused_pool, lengths)
    return {REPLACES[7][0]: totals[7], REPLACES[1][0]: totals[1],
            FLASH["name"]: flash_phase(torch, flash_wavlm)}


def ab_phase(other: str) -> None:
    """Phases 2-3 for OTHER's kernels and this checkout's, each in its own
    process, in the order OTHER, this, this, OTHER, on one card; the inputs
    and the timing are this script's in every run."""
    here = os.path.dirname(os.path.abspath(__file__))
    lengths = json.dumps(main_path_lengths(main_path_config()), default=int)
    runs = []
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernels-from", root,
                               "--lengths", lengths], capture_output=True, text=True, timeout=1200)
        print(f"=== {label}: {os.path.abspath(root)} (exit {proc.returncode})")
        print(proc.stdout.rstrip())
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the kernel phases failed for {root}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    for name in (REPLACES[7][0], REPLACES[1][0], FLASH["name"]):
        for key in ("ms", "device_ms"):
            print(f"{name:12s} {key:9s} " + "  ".join(
                f"{label}={res[name][key]!r}" for label, res in runs))
        for call in runs[0][1][name]["calls"]:
            print(f"{name:12s} {call:12s} " + "  ".join(
                f"{label}={res[name]['calls'][call]!r}" for label, res in runs))
    print(json.dumps({"ab": [{"run": label, **res} for label, res in runs]}))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", metavar="OTHER", help="time phases 2-3 against OTHER's kernels")
    parser.add_argument("--kernels-from", help=argparse.SUPPRESS)
    parser.add_argument("--lengths", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.kernels_from:
        lengths = {m: tuple(v) for m, v in json.loads(args.lengths).items()}
        print(json.dumps(kernels_only(torch, args.kernels_from, lengths)))
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.ab:
        print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        ab_phase(args.ab)
        print(card_line())
        return 0
    from sdumc_tpu_torch.ops.kernels import build, flash_wavlm, fused_cross, fused_pool

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build()
    print(f"kernel build: {time.perf_counter() - t0!r} s for {sorted(report) or 'cached'}")
    for name, rep in report.items():
        print(f"--- nvcc {name} ---\n{rep['log'].strip()}")

    totals = kernel_phase(torch, fused_cross, fused_pool, main_path_lengths(main_path_config()))
    flash = flash_phase(torch, flash_wavlm)
    launches = main_path_phase(torch, fused_cross)
    extract_counts = extraction_phase(torch, flash_wavlm)

    kernels = []
    for q_count, (name, replaces) in REPLACES.items():
        tot = totals[q_count]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[q_count], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["operations_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
        })
    kernels.append({
        **FLASH, "route": "cuda", "launches": extract_counts[FLASH["name"]],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": "operations" if flash["operations_ms"] >= flash["bytes_ms"] else "bytes",
        "library_ms": flash["library_ms"],
    })
    print("fused_cross / fused_pool times are per dual batch: the sum of the "
          "audio, text and video calls above; library_ms is null: no single "
          "PyTorch call computes tanh(x W^T + b) keys, the masked softmax and "
          "the weighted sum (SDPA takes keys already projected). flash_wavlm "
          "times are the sum of one call at each of its two shapes above; its "
          "library_ms is scaled_dot_product_attention with a materialised f32 "
          "mask gate * bias + keymask, built outside the timed region. "
          "Launches are counted on each kernel's own path (cli.infer, "
          "cli.extract audio)")
    for name, tot in ((REPLACES[7][0], totals[7]), (REPLACES[1][0], totals[1]),
                      (FLASH["name"], flash)):
        print(f"{name}: kernel_ms={tot['ms']!r} device_ms={tot['device_ms']!r} "
              f"bound_ms={tot['bound_ms']!r} ({tot['ms'] and tot['bound_ms'] / tot['ms']:.1%} "
              f"of it) f32_bound_ms={tot['f32_bound_ms']!r}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
