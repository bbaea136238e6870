"""How far the card's bf16 frame streams part from the CPU's, and how far
streams in f32 would, per output of the fusion net.

    python -m sdumc_tpu_torch.bench.bf16_gap

Runs the fused dual view in eval mode on seeded weights and seeded bf16
features three ways: on the CPU with bf16 streams (the reference: the
kernel's plain version), on the card with bf16 streams (the sound run: the
same roundings, summed in another order) and on the card with the same
features widened to f32 (the control: no bf16 rounding in the streams).
For each output (the predictions, ``features``, ``rnc``, ``text_feat``,
``text_query_feat``) it prints the max abs difference over the output's
largest value and the relative L2 error, sound and control, for a tiny
configuration (widths 32 / 64 / 32) and the published one (1024 / 4096 /
1024, the phase-4 buckets) at 8-32 rows; then the card's name and power
limit. The limits of ``chip_smoke.py`` phase 18 and the bf16 card test sit
between the two readings.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from sdumc_tpu_torch.cli.common import bf16_full_precision_reduction
from sdumc_tpu_torch.core.config import ModelConfig
from sdumc_tpu_torch.models.fusion import SDUMCFusion

KEYS = ("features", "rnc", "text_feat", "text_query_feat")
TINY = ((32, 64, 32), ((70, 32), (20, 64), (12, 64), (40, 32)), (65, (17, 12), 33))
PUBLISHED = ((1024, 4096, 1024), ((2048, 1024), (128, 4096), (64, 4096), (512, 1024)),
             (1164, (96, 60), 298))
CASES = ([(TINY, 3, seed) for seed in range(5)]
         + [(PUBLISHED, rows, seed) for seed, rows in ((0, 8), (1, 8), (2, 8), (3, 16),
                                                      (4, 16), (5, 32))])


def gaps(config, rows: int, seed: int, device: torch.device) -> dict:
    """{output: (max sound, max control, l2 sound, l2 control)} of one case."""
    dims, shapes, t_max = config
    model = SDUMCFusion(ModelConfig(input_dims=dims), torch.Generator().manual_seed(seed)).eval()
    rng = np.random.default_rng(seed + 100)
    feats = [torch.from_numpy(rng.normal(size=(rows, n, d)).astype(np.float32)).bfloat16()
             for n, d in shapes]

    def run(a, t, f, v):
        return model(a, (t, f), v, t_max=t_max, dual=True)

    with torch.inference_mode(), bf16_full_precision_reduction():
        ref, ref_aux = run(*feats)
        model.to(device)
        got, aux = run(*(z.to(device) for z in feats))
        ctl, ctl_aux = run(*(z.float().to(device) for z in feats))
    out = {}
    for name, r, g, c in [("vals", ref, got, ctl)] + [
            (k, ref_aux[k], aux[k], ctl_aux[k]) for k in KEYS]:
        g, c = g.float().cpu(), c.float().cpu()
        top, norm = r.abs().max().item(), r.norm().item()
        out[name] = ((g - r).abs().max().item() / top, (c - r).abs().max().item() / top,
                     (g - r).norm().item() / norm, (c - r).norm().item() / norm)
    return out


def main() -> int:
    from sdumc_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("bf16_gap: no CUDA device is available")
        return 1
    build.build()
    device = torch.device("cuda")
    print("case: output max-rel sound / control, L2-rel sound / control")
    for config, rows, seed in CASES:
        res = gaps(config, rows, seed, device)
        print(f"dims={config[0]} rows={rows} seed={seed}: " + "; ".join(
            f"{k} {ms:.3e} / {mc:.3e}, {ls:.3e} / {lc:.3e}" for k, (ms, mc, ls, lc) in res.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
