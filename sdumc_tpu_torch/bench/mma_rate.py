"""Rate of tensor-core products (``mma.sync`` and ``wgmma``) on the card.

    python -m sdumc_tpu_torch.bench.mma_rate

Compiles a small CUDA source with nvcc for sm_90a into ``build/kernels/``
and runs one block on every SM. Each warp runs ``mma.sync`` into
independent accumulators, with no memory traffic in the loop, so the tensor
cores and the instruction's latency are all that bound it. Prints, for each
instruction at 32 warps and 8 accumulators a warp, the MACs per SM per clock
(from ``clock64`` in every block) and the rate in TFLOP/s (from CUDA
events), the TF32 one also with other operand registers for each MMA (as
in a kernel that loads its fragments); then bf16 ``wgmma`` at m64n128k16
and m64n256k16, two warpgroups an SM, each issuing 8 products a group into
one accumulator with both operands read from shared memory (no copies in
the loop); then the TF32 instruction's MACs per SM per clock for 4-32
warps per SM and 1-8 accumulators a warp; and the card's name and power
limit. The f32 instances of the hand-written kernels issue the TF32
``mma.sync``, the bf16 instances the bf16 one; ``wgmma`` is the yardstick
of what a warpgroup design could reach. The card's dense peak is 1024 TF32
or 2048 bf16 MACs per SM per clock.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import torch


def _wgmma_product(n: int) -> str:
    """wgmma_bf16<n>: one m64n{n}k16 bf16 product into n / 2 f32 registers a
    thread (the instruction names every one)."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(acc[{i}])' for i in range(n // 2))
    return f"""
template <>
__device__ __forceinline__ void wgmma_bf16<{n}>(float* acc, uint64_t da, uint64_t db) {{
  asm volatile(
      "{{\\n .reg .pred p;\\n setp.ne.b32 p, %{n // 2 + 2}, 0;\\n"
      " wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs}}}, %{n // 2}, %{n // 2 + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(1));
}}
"""


WGMMA_NS = (128, 256)
WGMMA_SOURCE = r"""
// bf16 wgmma, both operands from shared memory through no-swizzle K-major
// descriptors (start address / 16, leading byte offset 128 / 16, stride
// byte offset 256 / 16); the accumulator is kept (scale-d 1).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* acc, uint64_t da, uint64_t db);
""" + "".join(_wgmma_product(n) for n in WGMMA_NS) + r"""
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3fff) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

// Two warpgroups; each issues 8 products a commit group into its one
// accumulator and keeps one group in flight.
template <int N>
__global__ void __launch_bounds__(256, 1) wgmma_loop(float* out, long long* cycles, int iters) {
  __shared__ __align__(128) uint16_t tiles[(64 + N) * 16];   // A [64 x 16], B [N x 16] bf16
  for (int i = threadIdx.x; i < (64 + N) * 16; i += blockDim.x) tiles[i] = 0x3c00 + (i & 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t da = wgmma_desc(tiles), db = wgmma_desc(tiles + 64 * 16);
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_bf16<N>(acc, da, db);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  __syncthreads();
  const long long c1 = clock64();
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = c1 - c0;
}

extern "C" int wgmma_rate_run(int n, int blocks, int iters, float* out, long long* cycles,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 128)
    wgmma_loop<128><<<blocks, 256, 0, s>>>(out, cycles, iters);
  else
    wgmma_loop<256><<<blocks, 256, 0, s>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
"""

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
""" + WGMMA_SOURCE

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
    dll.wgmma_rate_run.argtypes = [i, i, i, p, p, p]
    dll.wgmma_rate_run.restype = ctypes.c_int
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


def measure_wgmma(n: int, iters: int = 4000) -> dict:
    """{"instruction", "macs_per_sm_clock", "tflops"} of bf16 wgmma m64n{n}k16,
    two warpgroups on every SM."""
    lib = _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):                           # the first launch warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.wgmma_rate_run(n, sms, iters, out.data_ptr(), cycles.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"wgmma_rate launch failed: cudaError {err}")
    per_sm = 2 * iters * 8 * 64 * n * 16
    return {"instruction": f"wgmma m64n{n}k16 bf16 (f32 accumulate), operands in shared memory",
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
    for n in WGMMA_NS:
        r = measure_wgmma(n)
        print(f"{r['instruction']}, 2 warpgroups per SM: "
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
