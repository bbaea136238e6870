"""Where the fusion kernel's bf16 instance spends a block's time, on the card.

    python -m sdumc_tpu_torch.bench.fusion_phases

Builds ``csrc/fused_cross.cu`` with ``-DSDUMC_PHASE_STAMPS`` into its own
library under ``build/kernels/`` (the kernel then stamps the globaltimer at
its phases in four blocks), runs the bf16 instance through
``fused_cross.fused_cross_attention`` and ``fused_pool.fused_attention_pool``
on the main path's audio call (B = 64 rows, T = 2048, t_max 1164, seeded
x), and prints, for each query count, the mean microseconds and share of a
block's time: the x tile's load (with the block's set-up), the products of
each 128-column chunk, its tanh and scores, the softmax and the weighted
sum; then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import torch

PHASES = ("x tile landed (set-up, TMA from HBM)", "chunk 0 products", "chunk 0 tanh and scores",
          "chunk 1 products", "chunk 1 tanh and scores", "softmax", "weighted sum")


def _stamped_library() -> ctypes.CDLL:
    from sdumc_tpu_torch.ops.kernels import build

    flags = (*build.NVCC_FLAGS, "-DSDUMC_PHASE_STAMPS")
    source = build.PACKAGE_DIR / build.SOURCES["fused_cross"]
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted((build.PACKAGE_DIR / "csrc").glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / f"libfused_cross_phases-{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        subprocess.run([build._nvcc(), *flags, "-o", str(lib), str(source)], check=True,
                       capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("fusion_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from sdumc_tpu_torch.ops.kernels import fused_cross, fused_pool

    lib = _stamped_library()
    fused_cross._lib()                            # sets the entry points' argtypes
    for name in ("sdumc_fused_cross", "sdumc_fused_cross_bf16", "sdumc_cuda_error_string"):
        fn, ref = getattr(lib, name), getattr(fused_cross.build.load("fused_cross"), name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    fused_cross._lib = lambda: lib                # the wrapper now launches the stamped build
    lib.sdumc_fused_cross_phases.argtypes = [ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    x = (0.5 * torch.randn(64, 2048, 256, generator=gen)).to(dev).bfloat16()
    w = ((torch.rand(256, 256, generator=gen) * 2 - 1) / 16).to(dev)
    b = ((torch.rand(256, generator=gen) * 2 - 1) / 16).to(dev)
    q = (0.5 * torch.randn(64, 7, 256, generator=gen)).to(dev).bfloat16()
    c = (0.1 * torch.randn(256, generator=gen)).to(dev)
    calls = {7: lambda: fused_cross.fused_cross_attention(q, x, w, b, 1164),
             1: lambda: fused_pool.fused_attention_pool(x, w, b, c, 1164)}
    for q_count, call in calls.items():
        sums = [0.0] * len(PHASES)
        runs = 5
        for _ in range(runs + 1):                 # the first call warms up
            with torch.inference_mode():
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            if lib.sdumc_fused_cross_phases(buf):
                raise RuntimeError("could not read the phase stamps")
            for blk in range(4):
                st = buf[8 * blk:8 * blk + 8]
                for k in range(len(PHASES)):
                    sums[k] += (st[k + 1] - st[k]) / 1e3 / (4 * runs)
        total = sum(sums)
        print(f"Q={q_count}: a block (of 320, one 256-frame tile each) takes {total!r} us:")
        for label, us in zip(PHASES, sums):
            print(f"  {label}: {us!r} us ({us / total:.1%})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
