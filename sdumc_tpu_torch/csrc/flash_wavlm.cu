// WavLM gated relative-position attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel sdumc_tpu/ops/pallas/flash_wavlm.py::_flash_kernel
// (launched by flash_gated_attention, pallas_call at flash_wavlm.py:371). For
// batch row b, head h, query t and key u, with q, k, v laid out [B, T, H, hd]:
//
//     s[t, u] = q[t] . k[u] * scale + gate[b, h, t] * diag[h, u - t + T - 1]
//               (+ NEG = -1e30 where kvalid[b, u] == 0)
//     out[t]  = sum_u softmax_u(s[t, :]) * v[u]
//
// diag [H, 2T - 1] is the bucketed bias rel_embed[bucket(u - t), h] laid out
// by offset: the bias depends on (t, u) only through u - t, so one vector per
// head replaces the TPU kernel's Toeplitz tile table ([2n - 1, H, blk, blk]),
// and a (query tile, key tile) pair reads one window of 2 * 64 - 1 values.
// The TPU kernel's layout tricks (gate and mask columns appended to q and k, a
// ones column on v for the row sum, heads packed per grid step) exist only
// for Mosaic and are not carried over.
//
// What bounds it on an H100: 4 * B * H * T^2 * hd flops of QK^T and PV, at
// T = 2999 36.8 GFLOP against 49 MB of q, k, v and out. Both products run on
// the tensor cores in the 3xTF32 split of tf32x3.cuh (three TF32 passes, f32
// accumulate, f32-grade results; the precision is fixed and does not follow
// torch's allow_tf32), so the least time is 3 x 36.8 GFLOP at 495 TFLOP/s =
// 0.22 ms, against 0.015 ms for the bytes: bound by tensor-core throughput.
// mma.sync reaches 674 of the 1024 TF32 MACs an SM can do per clock
// (bench/mma_rate.py), and the f32 softmax, the hi / lo splits and the
// staging share the warps' instruction slots with it. The design, flash-attention-2
// style:
//  * One block of 4 warps per (b, h, 64-query tile); each warp owns 16 query
//    rows, keeps its q rows as A fragments (hi and lo, split once per block)
//    and its S and O accumulators in registers; the row max and row sum of
//    the online softmax are reduced across the 4 lanes of a quad. A loop over
//    64-key tiles keeps the [T, T] scores out of device memory.
//  * Each k and v tile lands raw (cp.async) and is split into hi and lo once
//    per block, into buffers that interleave the two parts so that one
//    16-byte load gives a lane a whole B fragment; no MMA repeats the split.
//    The next tile's raw copy is in flight during the current tile's
//    products, with two barriers per tile. (Splitting each fragment as it is
//    loaded instead, with no split pass, measured slower: each warp then
//    repeats the splits, and they cost more instruction slots than the pass's
//    shared-memory traffic.)
//  * The MMA's k index t reads element 2t of its 8-wide step and t + 4 reads
//    2t + 1 (tf32x3.cuh): the scores' accumulators are then P.V's A fragment
//    as they stand, with no shuffle and no round trip through shared memory.
//  * P.V of each tile sums into a fresh accumulator that is added to O in
//    f32: the tensor cores' accumulation rounds toward zero, and one running
//    sum over 3000 keys drifted by about 1e-4 relative.
//  * 104 KB of shared memory and 253 registers a thread: 2 blocks (8 warps)
//    share an SM.
//  * The ragged edge is masked in the kernel: key rows past T are zero-filled
//    and carry -inf, so they weigh exactly zero; query rows past T are not
//    stored; nothing is padded on the host. A masked key adds NEG, so a row
//    whose first tiles are all masked carries m = -1e30 until a valid key
//    arrives, and the rescale exp(m_old - m_new) then wipes what it summed. A
//    row with no valid key averages v over all T keys, as the plain version
//    does.
//
// The bf16 instance (sdumc_flash_wavlm_bf16) computes what the Pallas kernel
// computes at bf16 inputs (flash_wavlm.py:140-248, wrapper :251-371): q, k, v,
// the gate and the bias are bf16 (the wrapper rounds the gate and the bias
// to bf16, as the Pallas wrapper rounds its gate column and bias tiles),
// masked keys add NEG rounded to bf16, QK^T and P.V accumulate in f32, the
// scores, the gated bias and the softmax statistics are f32, p = exp(s - m)
// is rounded to bf16 before P.V, the row sum l is the f32 sum of the rounded
// p (the Pallas kernel takes it from v's ones column through the same dot),
// and out = acc / l is rounded to bf16 once. The scale 1 / sqrt(hd) is a
// power of two for hd 16 and 64, so applying it to the f32 score is exact
// and equals the Pallas wrapper's bf16 scaling of q. m is the running max of
// 64-key tiles, so p is rounded relative to it (the Pallas kernel's is of
// its own blocks); the plain version rounds against the same running max.
// Route: a bf16 value is exact in TF32 (8 significant bits against 11), so
// the tiles are staged at 2 bytes (cp.async, 8 values per 16 bytes), widened
// once per block into f32 buffers laid out for 8-byte fragment loads, and
// each product issues ONE TF32 mma.sync pass (m16n8k8) instead of three;
// the rounded p is exact in TF32 too. Its bound on this card: the same 36.8
// GFLOP at T = 2999 on bf16 operands at the dense bf16 tensor-core rate of
// 989 TFLOP/s, 0.037 ms, against 0.0073 ms for the 24.6 MB of bf16 q, k, v
// and out: bound by the tensor cores. The one TF32 pass chosen here can at
// best reach the 495 TFLOP/s TF32 rate, 0.074 ms, half the bf16 rate; a
// native bf16 mma (m16n8k16) or wgmma, for a later change, is what closes
// that factor. 55 KB of shared memory a block (hd = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kKeys = 64;           // keys per tile
constexpr int kNT = kKeys / 8;      // 8-key steps of a tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kKeys, "the bias window spans one 64 x 64 tile pair");

// Shared memory of a block, in floats. The raw f32 k and v tiles land in
// [64][HD + 4] buffers (cp.async); the split pass writes their hi and lo
// parts interleaved, so that one 16-byte load gives a lane its whole B
// fragment (hi and lo of both elements):
//   k: row u, element pair p (2p, 2p + 1) at u * KS + 4p:
//      hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)
//   v: key pair p (2p, 2p + 1), column c at p * VS + 4c:
//      hi(2p, c), hi(2p + 1, c), lo(2p, c), lo(2p + 1, c)
// KS = 2 HD + 16 and VS = 4 HD + 8 put the 8 lanes of a quarter warp on 32
// distinct banks.
template <int HD>
struct Layout {
  static constexpr int RS = HD + 4;
  static constexpr int KS = 2 * HD + 16;
  static constexpr int VS = 4 * HD + 8;
  static constexpr int kRawK = 0;
  static constexpr int kRawV = kRawK + kKeys * RS;
  static constexpr int kSplitK = kRawV + kKeys * RS;
  static constexpr int kSplitV = kSplitK + kKeys * KS;
  static constexpr int kWin = kSplitV + kKeys / 2 * VS;   // [128] bias window * log2 e, offset col - row + 63
  static constexpr int kMask = kWin + 2 * kKeys;       // [64]  key term: 0, NEG * log2 e, or -inf past T
  static constexpr size_t floats = (size_t)kMask + kKeys;
};

// Shared memory of the bf16 instance, in floats. The raw bf16 k and v tiles
// land in [64][HD + 8] bf16 buffers (cp.async); the widening pass writes them
// as f32:
//   k: row u, element e at u * KS + e
//   v: key pair p (2p, 2p + 1), column c at p * VS + 2c: v(2p, c), v(2p + 1, c)
// so that one 8-byte load gives a lane its B fragment. KS = HD + 8 and VS =
// 2 HD + 8 (both 8 mod 32) put a half warp's 16 loads on 32 distinct banks.
template <int HD>
struct LayoutB16 {
  static constexpr int RS = HD + 8;                        // bf16 values a raw row
  static constexpr int KS = HD + 8;
  static constexpr int VS = 2 * HD + 8;
  static constexpr int kRawK = 0;
  static constexpr int kRawV = kRawK + kKeys * RS / 2;
  static constexpr int kWideK = kRawV + kKeys * RS / 2;
  static constexpr int kWideV = kWideK + kKeys * KS;
  static constexpr int kWin = kWideV + kKeys / 2 * VS;
  static constexpr int kMask = kWin + 2 * kKeys;
  static constexpr size_t floats = (size_t)kMask + kKeys;
};

template <bool B16>
using Elem = typename std::conditional<B16, __nv_bfloat16, float>::type;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows t0 .. t0 + 63 of k and v for one head into the raw buffers; rows at or
// past T are zero-filled. One cp.async group. Thread tid copies float4 column
// tid % kC of rows tid / kC + kRows m, so every offset but the row is fixed.
template <int HD>
__device__ __forceinline__ void load_raw(float* smem, const float* k, const float* v, int t0,
                                         int T, size_t row_stride, int tid) {
  using L = Layout<HD>;
  constexpr int kC = HD / 4, kRows = kThreads / kC;
  static_assert(kThreads % kC == 0 && kKeys % kRows == 0, "whole rows per pass");
  const int r0 = tid / kC, c = tid % kC;
  const size_t src = (size_t)(t0 + r0) * row_stride + 4 * c;
  float* dk = smem + L::kRawK + r0 * L::RS + 4 * c;
  float* dv = smem + L::kRawV + r0 * L::RS + 4 * c;
  const int left = T - t0 - r0;
#pragma unroll
  for (int m = 0; m < kKeys / kRows; ++m) {
    if (kRows * m < left) {
      cp_async16(dk + m * kRows * L::RS, k + src + (size_t)m * kRows * row_stride);
      cp_async16(dv + m * kRows * L::RS, v + src + (size_t)m * kRows * row_stride);
    } else {
      *reinterpret_cast<float4*>(dk + m * kRows * L::RS) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dv + m * kRows * L::RS) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_commit();
}

// The raw k and v tiles split into their interleaved hi / lo buffers, with the
// same fixed column per thread as load_raw.
template <int HD>
__device__ __forceinline__ void split_tiles(float* smem, int tid) {
  using L = Layout<HD>;
  constexpr int kC = HD / 4, kRows = kThreads / kC;
  const int r0 = tid / kC, c = tid % kC;
  const float* sk = smem + L::kRawK + r0 * L::RS + 4 * c;
  float* dk = smem + L::kSplitK + r0 * L::KS + 8 * c;
#pragma unroll
  for (int m = 0; m < kKeys / kRows; ++m) {
    float4 lo;
    const float4 hi = tf32x3::split4(*reinterpret_cast<const float4*>(sk + m * kRows * L::RS), lo);
    float* d = dk + m * kRows * L::KS;
    *reinterpret_cast<float4*>(d) = make_float4(hi.x, hi.y, lo.x, lo.y);
    *reinterpret_cast<float4*>(d + 4) = make_float4(hi.z, hi.w, lo.z, lo.w);
  }
  // v: thread tid takes key pairs tid / kC + kRows m
  const float* sv = smem + L::kRawV + 2 * r0 * L::RS + 4 * c;
  float* dv = smem + L::kSplitV + r0 * L::VS + 16 * c;
#pragma unroll
  for (int m = 0; m < kKeys / 2 / kRows; ++m) {
    const float* src = sv + 2 * m * kRows * L::RS;
    float4 lo0, lo1;
    const float4 hi0 = tf32x3::split4(*reinterpret_cast<const float4*>(src), lo0);
    const float4 hi1 = tf32x3::split4(*reinterpret_cast<const float4*>(src + L::RS), lo1);
    float* d = dv + m * kRows * L::VS;
    *reinterpret_cast<float4*>(d) = make_float4(hi0.x, hi1.x, lo0.x, lo1.x);
    *reinterpret_cast<float4*>(d + 4) = make_float4(hi0.y, hi1.y, lo0.y, lo1.y);
    *reinterpret_cast<float4*>(d + 8) = make_float4(hi0.z, hi1.z, lo0.z, lo1.z);
    *reinterpret_cast<float4*>(d + 12) = make_float4(hi0.w, hi1.w, lo0.w, lo1.w);
  }
}

// The bf16 instance's load_raw: rows t0 .. t0 + 63 of k and v into the raw
// bf16 buffers, rows at or past T zero-filled; 16 bytes (8 values) a copy.
template <int HD>
__device__ __forceinline__ void load_raw_b16(float* smem, const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, int t0, int T,
                                             size_t row_stride, int tid) {
  using L = LayoutB16<HD>;
  constexpr int kC = HD / 8;
  __nv_bfloat16* rk = reinterpret_cast<__nv_bfloat16*>(smem + L::kRawK);
  __nv_bfloat16* rv = reinterpret_cast<__nv_bfloat16*>(smem + L::kRawV);
  for (int i = tid; i < kKeys * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    __nv_bfloat16* dk = rk + r * L::RS + 8 * c;
    __nv_bfloat16* dv = rv + r * L::RS + 8 * c;
    if (t0 + r < T) {
      const size_t src = (size_t)(t0 + r) * row_stride + 8 * c;
      cp_async16(dk, k + src);
      cp_async16(dv, v + src);
    } else {
      *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void widen8(uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 w = __bfloat1622float2(p[i]);
    f[2 * i] = w.x;
    f[2 * i + 1] = w.y;
  }
}

// The raw bf16 k and v tiles widened into their f32 buffers (exact).
template <int HD>
__device__ __forceinline__ void widen_tiles(float* smem, int tid) {
  using L = LayoutB16<HD>;
  constexpr int kC = HD / 8;
  const __nv_bfloat16* rk = reinterpret_cast<const __nv_bfloat16*>(smem + L::kRawK);
  const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(smem + L::kRawV);
  for (int i = tid; i < kKeys * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    float f[8];
    widen8(*reinterpret_cast<const uint4*>(rk + r * L::RS + 8 * c), f);
    float* d = smem + L::kWideK + r * L::KS + 8 * c;
    *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
  for (int i = tid; i < kKeys / 2 * kC; i += kThreads) {
    const int p = i / kC, c = i % kC;
    float a[8], b[8];
    widen8(*reinterpret_cast<const uint4*>(rv + 2 * p * L::RS + 8 * c), a);
    widen8(*reinterpret_cast<const uint4*>(rv + (2 * p + 1) * L::RS + 8 * c), b);
    float* d = smem + L::kWideV + p * L::VS + 16 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(d + 4 * j) =
          make_float4(a[2 * j], b[2 * j], a[2 * j + 1], b[2 * j + 1]);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^x on the SFU (relative error about 2^-22); flushes results below 2^-126 to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, bool B16>
__global__ void __launch_bounds__(kThreads, 2)
flash_wavlm_kernel(const Elem<B16>* __restrict__ q, const Elem<B16>* __restrict__ k,
                   const Elem<B16>* __restrict__ v, const Elem<B16>* __restrict__ gate,
                   const Elem<B16>* __restrict__ bias_diag,
                   const float* __restrict__ kvalid, Elem<B16>* __restrict__ out,
                   int T, int H, float scale) {
  static_assert(HD % 16 == 0 && HD <= 64, "8-wide steps, whole float4 rows");
  using L = Layout<HD>;
  using LB = LayoutB16<HD>;
  constexpr int kK = HD / 8;          // 8-wide steps of q . k; 8-column tiles of out

  extern __shared__ __align__(16) float smem[];
  const float* ks = smem + (B16 ? LB::kWideK : L::kSplitK);
  const float* vs = smem + (B16 ? LB::kWideV : L::kSplitV);
  float* w_s = smem + (B16 ? LB::kWin : L::kWin);
  float* n_s = smem + (B16 ? LB::kMask : L::kMask);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t head = ((size_t)b * T * H + h) * HD;
  const Elem<B16>* diag = bias_diag + (size_t)h * (2 * T - 1);
  const float* kv = kvalid ? kvalid + (size_t)b * T : nullptr;

  // this lane's two query rows: r0 (= fragment row g) and r1 (= g + 8)
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool in0 = q0 + r0 < T, in1 = q0 + r1 < T;

  if constexpr (B16)
    load_raw_b16<HD>(smem, k + head, v + head, 0, T, row_stride, tid);
  else
    load_raw<HD>(smem, k + head, v + head, 0, T, row_stride, tid);

  // q . k's A fragments, split once: step kk, k index t <-> element 8kk + 2t
  // (the bf16 instance: the widened values, their own TF32 hi)
  uint32_t qh[kK][4], ql[kK][4];
  {
    const Elem<B16>* qa = q + head + (size_t)(in0 ? q0 + r0 : 0) * row_stride + 2 * t;
    const Elem<B16>* qb = q + head + (size_t)(in1 ? q0 + r1 : 0) * row_stride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      if constexpr (B16) {
        const float2 x0 = in0 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qa + 8 * kk))
                              : make_float2(0.f, 0.f);
        const float2 x1 = in1 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + 8 * kk))
                              : make_float2(0.f, 0.f);
        qh[kk][0] = __float_as_uint(x0.x);
        qh[kk][1] = __float_as_uint(x1.x);
        qh[kk][2] = __float_as_uint(x0.y);
        qh[kk][3] = __float_as_uint(x1.y);
      } else {
        const float2 x0 = in0 ? *reinterpret_cast<const float2*>(qa + 8 * kk) : make_float2(0.f, 0.f);
        const float2 x1 = in1 ? *reinterpret_cast<const float2*>(qb + 8 * kk) : make_float2(0.f, 0.f);
        tf32x3::split_a(x0, x1, qh[kk], ql[kk]);
      }
    }
  }
  const Elem<B16>* gate_row = gate + ((size_t)b * H + h) * T + q0;
  float g0, g1;
  if constexpr (B16) {
    g0 = in0 ? __bfloat162float(gate_row[r0]) : 0.f;
    g1 = in1 ? __bfloat162float(gate_row[r1]) : 0.f;
  } else {
    g0 = in0 ? gate_row[r0] : 0.f;
    g1 = in1 ? gate_row[r1] : 0.f;
  }
  const float sl = scale * kLog2e;    // scores are kept in log2 units
  // a masked key's term: NEG (the bf16 instance: NEG rounded to bf16)
  const float neg = (B16 ? round_bf16(kNeg) : kNeg) * kLog2e;

  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;               // running sum over this lane's columns
  float o[kK][4];
#pragma unroll
  for (int n = 0; n < kK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int nk = (T + kKeys - 1) / kKeys;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kKeys;
    cp_async_wait_all();               // this tile's raw k and v landed
    __syncthreads();                   // ... for every thread; the split buffers are free
    if constexpr (B16)
      widen_tiles<HD>(smem, tid);
    else
      split_tiles<HD>(smem, tid);
    if (tid < kKeys) {
      const int u = k0 + tid;
      n_s[tid] = u >= T ? -INFINITY : (kv && !(kv[u] > 0.f)) ? neg : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = tid - kKeys + e * kKeys;     // 0 .. 127
        const long long d = (long long)k0 - q0 + T - 1 - (kKeys - 1) + c;
        float w = 0.f;
        if (c < 2 * kKeys - 1 && d >= 0 && d <= 2LL * T - 2) {
          if constexpr (B16)
            w = __bfloat162float(diag[d]) * kLog2e;
          else
            w = diag[d] * kLog2e;
        }
        w_s[c] = w;
      }
    }
    __syncthreads();                   // split tiles, mask and window in place; raw buffers free
    if (kt + 1 < nk) {
      if constexpr (B16)
        load_raw_b16<HD>(smem, k + head, v + head, k0 + kKeys, T, row_stride, tid);
      else
        load_raw<HD>(smem, k + head, v + head, k0 + kKeys, T, row_stride, tid);
    }

    // S = Q K^T: s[j] covers keys 8j .. 8j + 7 (c0, c1: row r0, keys 8j + 2t, + 1)
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if constexpr (B16) {
          const uint2 f = *reinterpret_cast<const uint2*>(ks + (8 * j + g) * LB::KS + 8 * kk + 2 * t);
          tf32x3::mma(s[j], qh[kk], f.x, f.y);
        } else {
          const uint4 f = *reinterpret_cast<const uint4*>(ks + (8 * j + g) * L::KS + 16 * kk + 4 * t);
          tf32x3::mma3(s[j], qh[kk], ql[kk], f.x, f.y, f.z, f.w);
        }
      }
    }

    // scale, gated bias, key term; online softmax across the quad's 64
    // columns. Keys past T carry -inf: they weigh 0 and never set the max.
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float nm = n_s[col];
        s[j][e] = fmaf(s[j][e], sl, fmaf(g0, w_s[col - r0 + kKeys - 1], nm));
        s[j][2 + e] = fmaf(s[j][2 + e], sl, fmaf(g1, w_s[col - r1 + kKeys - 1], nm));
        mt0 = fmaxf(mt0, s[j][e]);
        mt1 = fmaxf(mt1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);  // finite: key k0 < T
    const float alpha0 = exp2_ftz(m0 - mn0), alpha1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2_ftz(s[j][e] - mn0);
        s[j][2 + e] = exp2_ftz(s[j][2 + e] - mn1);
        if constexpr (B16) {        // p rounded to bf16; l sums the rounded p
          s[j][e] = round_bf16(s[j][e]);
          s[j][2 + e] = round_bf16(s[j][2 + e]);
        }
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    }
    l0 = fmaf(l0, alpha0, ps0);
    l1 = fmaf(l1, alpha1, ps1);

    // P V of this tile: step j's A fragment is s[j] itself (keys 8j + 2t,
    // 8j + 2t + 1). It sums into a fresh accumulator, and o = alpha o + pv
    // in f32: the tensor cores' accumulation rounds toward zero, so a
    // running sum over all T keys would drift by about 1e-4 at T = 3000.
    float pv[kK][4];
#pragma unroll
    for (int n = 0; n < kK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if constexpr (B16) {          // the rounded p is exact in TF32: one pass
        const uint32_t pa[4] = {__float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                                __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
#pragma unroll
        for (int n = 0; n < kK; ++n) {
          const uint2 f = *reinterpret_cast<const uint2*>(vs + (4 * j + t) * LB::VS + 2 * (8 * n + g));
          tf32x3::mma(pv[n], pa, f.x, f.y);
        }
      } else {
        uint32_t ph[4], pl[4];
        tf32x3::split_a(make_float2(s[j][0], s[j][1]), make_float2(s[j][2], s[j][3]), ph, pl);
#pragma unroll
        for (int n = 0; n < kK; ++n) {
          const uint4 f = *reinterpret_cast<const uint4*>(vs + (4 * j + t) * L::VS + 4 * (8 * n + g));
          tf32x3::mma3(pv[n], ph, pl, f.x, f.y, f.z, f.w);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kK; ++n) {
      o[n][0] = fmaf(o[n][0], alpha0, pv[n][0]);
      o[n][1] = fmaf(o[n][1], alpha0, pv[n][1]);
      o[n][2] = fmaf(o[n][2], alpha1, pv[n][2]);
      o[n][3] = fmaf(o[n][3], alpha1, pv[n][3]);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // o[n]: columns 8n + 2t, 8n + 2t + 1 of rows r0 (c0, c1) and r1 (c2, c3)
  if (in0) {
    Elem<B16>* dst = out + head + (size_t)(q0 + r0) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kK; ++n) {
      if constexpr (B16)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
      else
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][0] / l0, o[n][1] / l0);
    }
  }
  if (in1) {
    Elem<B16>* dst = out + head + (size_t)(q0 + r1) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kK; ++n) {
      if constexpr (B16)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
      else
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2] / l1, o[n][3] / l1);
    }
  }
}

template <int HD, bool B16>
cudaError_t launch(const Elem<B16>* q, const Elem<B16>* k, const Elem<B16>* v,
                   const Elem<B16>* gate, const Elem<B16>* bias_diag, const float* kvalid,
                   Elem<B16>* out, int B, int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (B16 ? LayoutB16<HD>::floats : Layout<HD>::floats);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wavlm_kernel<HD, B16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wavlm_kernel<HD, B16>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_wavlm_kernel<HD, B16><<<grid, kThreads, smem, stream>>>(
      q, k, v, gate, bias_diag, kvalid, out, T, H, scale);
  return cudaGetLastError();
}

template <bool B16>
int dispatch(const void* q, const void* k, const void* v, const void* gate,
             const void* bias_diag, const float* kvalid, void* out,
             int B, int T, int H, int hd, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  using E = Elem<B16>;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* ge = static_cast<const E*>(gate);
  const E* de = static_cast<const E*>(bias_diag);
  E* oe = static_cast<E*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16, B16>(qe, ke, ve, ge, de, kvalid, oe, B, T, H, scale, s);
    case 64: return (int)launch<64, B16>(qe, ke, ve, ge, de, kvalid, oe, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch (0 on
// success). q, k, v and out are contiguous f32 [B, T, H, hd] with hd 64
// (wavlm-large) or 16 (the card tests' tiny model); gate [B, H, T];
// bias_diag [H, 2T - 1]; kvalid an f32 [B, T] key mask (> 0 attends), or NULL
// when every key is valid.
int sdumc_flash_wavlm(const float* q, const float* k, const float* v, const float* gate,
                      const float* bias_diag, const float* kvalid, float* out,
                      int B, int T, int H, int hd, float scale, void* stream) {
  return dispatch<false>(q, k, v, gate, bias_diag, kvalid, out, B, T, H, hd, scale, stream);
}

// The bf16 instance: q, k, v, gate, bias_diag and out are bf16, with the
// f32 instance's shapes; kvalid stays f32. scale must be a power of two.
int sdumc_flash_wavlm_bf16(const void* q, const void* k, const void* v, const void* gate,
                           const void* bias_diag, const float* kvalid, void* out,
                           int B, int T, int H, int hd, float scale, void* stream) {
  return dispatch<true>(q, k, v, gate, bias_diag, kvalid, out, B, T, H, hd, scale, stream);
}

const char* sdumc_flash_wavlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
