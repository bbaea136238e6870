// f32-grade matrix products on Hopper's tensor cores: the 3xTF32 split.
//
// A TF32 tensor-core product keeps 10 explicit mantissa bits of each operand
// (relative error about 1e-3 on a score). Splitting each f32 operand into
//
//     a = a_hi + a_lo,   a_hi = tf32(a),   a_lo = tf32(a - a_hi)
//
// and summing three products in f32,
//
//     a . b  ~=  a_lo . b_hi + a_hi . b_lo + a_hi . b_hi,
//
// drops only a_lo . b_lo (about 2^-22 relative), so the result is of f32
// grade (about 1e-6 relative) at three tensor-core passes: 495 / 3 = 165
// TFLOP/s of f32-grade work on an H100 SXM, against 67 TFLOP/s of f32 FFMA.
// mma.sync itself reaches about two thirds of the TF32 peak
// (sdumc_tpu_torch/bench/mma_rate.py); wgmma is the way to the rest.
// The kernels that include this header always run the three passes: their
// precision is fixed at f32 grade and does not follow torch's allow_tf32.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// for lane = 4 * g + t (g = lane / 4, t = lane % 4):
//
//     A [16 x 8]: a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//     B [8 x 8]:  b0 (t, g)   b1 (t + 4, g)                   (row = k, col = n)
//     C [16 x 8]: c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// The kernels map the MMA's k index t to the contracted element 2t of their
// 8-wide step and t + 4 to 2t + 1. The product sums over k, so any one-to-one
// map of k onto the contracted axis gives the same sum, as long as A and B use
// the same map. With it, the two values a lane feeds as (a0, a2), or as
// (b0, b1), sit next to each other in memory, and the pair a lane holds in
// c0, c1 of one product is its (a0, a2) of the next: P = softmax(Q K^T)
// passes from the scores' accumulators straight into P.V's A fragment.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// a rounded to TF32, to nearest with ties away from zero; the 13 low bits
// of the result are zero. These are the bits cvt.rna.tf32.f32 gives for
// every finite a (ptxas expands that instruction to the same add and mask
// behind an inf / NaN guard, four instructions instead of two); inf stays
// inf, NaN stays NaN, and a finite a past the largest TF32 rounds to inf.
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// The split of a: hi = tf32(a), lo = tf32(a - hi). a - hi is exact in f32.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// The split written back as floats, for tiles staged in shared memory.
__device__ __forceinline__ float4 split4(float4 a, float4& lo) {
  uint32_t h[4], l[4];
  split(a.x, h[0], l[0]);
  split(a.y, h[1], l[1]);
  split(a.z, h[2], l[2]);
  split(a.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// d += a . b on the tensor cores, one m16n8k8 TF32 product, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b at f32 grade: the two small terms first, then hi . hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// A fragment (hi and lo) of one 8-wide step from a lane's two rows: x0 holds
// row g's elements 2t, 2t + 1 of the step, x1 row g + 8's.
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(x0.x, hi[0], lo[0]);
  split(x1.x, hi[1], lo[1]);
  split(x0.y, hi[2], lo[2]);
  split(x1.y, hi[3], lo[3]);
}

}  // namespace tf32x3
