"""Rate of warp-level tensor-core products (``mma.sync``) on the card.

    python -m sdumc_tpu_torch.bench.mma_rate

Compiles a small CUDA source with nvcc for sm_90a into ``build/kernels/``
and runs one block on every SM. Each warp runs ``mma.sync`` into
independent accumulators, with no memory traffic in the loop, so the tensor
cores and the instruction's latency are all that bound it. Prints, for each
instruction at 32 warps and 8 accumulators a warp, the MACs per SM per clock
(from ``clock64`` in every block) and the rate in TFLOP/s (from CUDA
events), the TF32 one also with other operand registers for each MMA (as
in a kernel that loads its fragments); then the TF32 instruction's
MACs per SM per clock for 4-32 warps per SM and 1-8 accumulators a warp;
and the card's name and power limit.
The hand-written kernels of this package use the TF32 one.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int KIND, int NACC>
__global__ void __launch_bounds__(1024, 1) mma_loop(float* out, long long* cycles, int iters) {
  float acc[NACC][4];
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t a[2][4], b[NACC][2];
  for (int i = 0; i < 8; ++i) a[i / 4][i % 4] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2 * NACC; ++i) b[i / 2][i % 2] = __float_as_uint(1e-3f * (threadIdx.x - i));
  __syncthreads();
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      // KIND 2 feeds every MMA other operand registers (A alternating, B
      // its own), as a kernel's loads do; 0 and 1 repeat the same ones
      const uint32_t* aa = a[KIND == 2 ? j & 1 : 0];
      const uint32_t* bb = b[KIND == 2 ? j : 0];
      if (KIND != 1)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(aa[0]), "r"(aa[1]), "r"(aa[2]), "r"(aa[3]), "r"(bb[0]), "r"(bb[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(aa[0]), "r"(aa[1]), "r"(aa[2]), "r"(aa[3]), "r"(bb[0]), "r"(bb[1]));
    }
  }
  __syncthreads();
  const long long c1 = clock64();
  float s = 0.f;
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = c1 - c0;
}

template <int KIND>
void run(int nacc, int blocks, int threads, int iters, float* out, long long* cycles,
         cudaStream_t s) {
  switch (nacc) {
    case 1: mma_loop<KIND, 1><<<blocks, threads, 0, s>>>(out, cycles, iters); break;
    case 2: mma_loop<KIND, 2><<<blocks, threads, 0, s>>>(out, cycles, iters); break;
    case 4: mma_loop<KIND, 4><<<blocks, threads, 0, s>>>(out, cycles, iters); break;
    default: mma_loop<KIND, 8><<<blocks, threads, 0, s>>>(out, cycles, iters); break;
  }
}

extern "C" int mma_rate_run(int kind, int nacc, int blocks, int threads, int iters, float* out,
                            long long* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    run<0>(nacc, blocks, threads, iters, out, cycles, s);
  else if (kind == 1)
    run<1>(nacc, blocks, threads, iters, out, cycles, s);
  else
    run<2>(nacc, blocks, threads, iters, out, cycles, s);
  return (int)cudaGetLastError();
}
"""

# (name, MACs per instruction)
KINDS = (("mma.sync m16n8k8 tf32 (f32 accumulate)", 16 * 8 * 8),
         ("mma.sync m16n8k16 bf16 (f32 accumulate)", 16 * 8 * 16),
         ("mma.sync m16n8k8 tf32, other operand registers for each MMA", 16 * 8 * 8))


def _library() -> ctypes.CDLL:
    from sdumc_tpu_torch.ops.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
    lib = build.BUILD_DIR / f"libmma_rate-{digest}.so"
    if not lib.exists():
        src = build.BUILD_DIR / f"mma_rate-{digest}.cu"
        src.write_text(SOURCE)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    i = ctypes.c_int
    dll.mma_rate_run.argtypes = [i, i, i, i, i, p, p, p]
    dll.mma_rate_run.restype = ctypes.c_int
    return dll


def measure(kind: int, warps: int = 32, accumulators: int = 8, iters: int = 20000) -> dict:
    """{"instruction", "macs_per_sm_clock", "tflops"} of one run on the current card."""
    lib = _library()
    name, macs = KINDS[kind]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 32 * warps, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):                           # the first launch warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.mma_rate_run(kind, accumulators, sms, 32 * warps, iters, out.data_ptr(),
                               cycles.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"mma_rate launch failed: cudaError {err}")
    per_sm = warps * iters * accumulators * macs
    return {"instruction": name,
            "macs_per_sm_clock": per_sm / cycles.double().mean().item(),
            "tflops": 2 * per_sm * sms / (start.elapsed_time(end) * 1e-3) / 1e12}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for kind in range(len(KINDS)):
        r = measure(kind)
        print(f"{r['instruction']}, 32 warps per SM, 8 accumulators a warp: "
              f"{r['macs_per_sm_clock']!r} MAC per SM per clock, {r['tflops']!r} TFLOP/s")
    print(f"{KINDS[0][0]}: MAC per SM per clock by warps per SM (rows) and "
          f"independent accumulators a warp (columns 1, 2, 4, 8)")
    for warps in (4, 8, 12, 16, 32):
        row = [measure(0, warps, acc, iters=4000)["macs_per_sm_clock"] for acc in (1, 2, 4, 8)]
        print(f"  {warps:2d} warps: " + "  ".join(f"{x:7.1f}" for x in row))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
