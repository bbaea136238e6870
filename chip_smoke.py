#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sdumc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: the card's name and power limit, then the kernel build
     from the sources in this checkout (all sources compile in parallel);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the main path's first dual batch (B = 64 rows, D = 256, the
     audio / text / video buckets), once with mixed per-row t_max and once
     with the batch's own lengths, which are also timed beside the plain
     version and the bound;
  3. the main path: ``sdumc_tpu_torch.cli.infer.main`` on the synthetic
     store at the full published width (1024/4096/1024 -> 256, batch 32,
     dual view, seeded weights), with the launch counters read around it,
     and the first batch's predictions held against the same model's plain
     path on the CPU.
The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or sdumc_tpu.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
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


def bound_ms(q_count: int, t_valid, shared_query: bool):
    """Least time for one call, as (bytes_ms, operations_ms): each input
    read once (x only up to each row's t_max) and the output written once,
    over the HBM rate; f32 work of the key projection (2 D^2 per valid
    frame), bias + tanh (2 D), scores and weighted sum (4 Q D), over the
    f32 rate."""
    n = int(sum(t_valid))
    rows = len(t_valid)
    q_bytes = (1 if shared_query else rows) * q_count * D * 4
    nbytes = q_bytes + n * D * 4 + D * D * 4 + D * 4 + rows * 4 + rows * q_count * D * 4
    flops = n * (2 * D * D + 2 * D + 4 * q_count * D)
    return 1e3 * nbytes / PEAK_HBM_BYTES, 1e3 * flops / PEAK_F32_FLOPS


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
                  "bytes_ms": 0.0, "operations_ms": 0.0} for q in REPLACES}
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
            bytes_ms, ops_ms = bound_ms(q_count, t_valid, q_count == 1)
            bnd = max(bytes_ms, ops_ms)
            tot = totals[q_count]
            tot["bytes_ms"] += bytes_ms
            tot["operations_ms"] += ops_ms
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bnd
            tot["max_abs_err"] = max(tot["max_abs_err"], *errs)
            print(f"  {REPLACES[q_count][0]:11s} {modality:5s} T={T:4d} "
                  f"t_max={sorted(set(t_valid))} frames={sum(t_valid)} "
                  f"max_abs_err mixed={errs[0]!r} main={errs[1]!r} "
                  f"kernel_ms={ms!r} plain_ms={plain_ms!r} bound_ms={bnd!r}")
    return totals


def main_path_phase(torch, fused_cross):
    from sdumc_tpu_torch.cli import infer
    from sdumc_tpu_torch.cli.common import build_model
    from sdumc_tpu_torch.data.pipeline import BatchIterator, get_loaders
    from sdumc_tpu_torch.train.step import batch_to_device_dict, make_eval_step

    fused_cross.reset_launches()
    t0 = time.perf_counter()
    out = infer.main(MAIN_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
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
    print(f"main path: {len(test_ds)} clips in {n_batches} dual batches, "
          f"{seconds!r} s host clock (data generation and model init included); "
          f"launches {launches}")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdumc_tpu_torch.ops.kernels import build, fused_cross, fused_pool

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build()
    print(f"kernel build: {time.perf_counter() - t0!r} s for {sorted(report) or 'cached'}")
    for name, rep in report.items():
        print(f"--- nvcc {name} ---\n{rep['log'].strip()}")

    totals = kernel_phase(torch, fused_cross, fused_pool, main_path_lengths(main_path_config()))
    launches = main_path_phase(torch, fused_cross)

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
    print("kernel times are per dual batch: the sum of the audio, text and "
          "video calls above; library_ms is null: no single PyTorch call "
          "computes tanh(x W^T + b) keys, the masked softmax and the weighted "
          "sum (SDPA takes keys already projected)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
