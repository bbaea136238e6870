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
// and a (query tile, key tile) pair reads one window of it. The TPU kernel's
// layout tricks (gate and mask columns appended to q and k, a ones column on
// v for the row sum, heads packed per grid step) exist only for Mosaic and
// are not carried over. Three instances (f32, its block form, bf16) of two
// kernel bodies.
//
// The f32 instance (sdumc_flash_wavlm). What bounds it on an H100: 4 * B * H
// * T^2 * hd flops of QK^T and PV, at T = 2999 36.8 GFLOP against 49 MB of
// q, k, v and out. Both products run on the tensor cores in the 3xTF32 split
// of tf32x3.cuh (three TF32 passes, f32 accumulate, f32-grade results; the
// precision is fixed and does not follow torch's allow_tf32), so the least
// time is 3 x 36.8 GFLOP at 495 TFLOP/s = 0.22 ms, against 0.015 ms for the
// bytes: bound by tensor-core throughput. mma.sync reaches 674 of the 1024
// TF32 MACs an SM can do per clock (bench/mma_rate.py), and the f32 softmax,
// the hi / lo splits and the staging share the warps' instruction slots with
// it. The design, flash-attention-2 style:
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
// The block instance (sdumc_flash_wavlm_lse) is the same body, which also
// writes each row's log-sum-exp m + log l in f32 as [B, H, T]: the statistic
// that merges the blocks of ring attention (parallel/ring_attention.py). A
// ring step runs it on one (query block, key block) pair of T_local rows
// each, whose keys sit at an offset from its queries; the wrapper folds the
// offset into the diagonal bias, so the kernel sees a square block. A block
// whose keys a row masks entirely gives that row m = -1e30 and so an lse of
// -1e30, which weighs zero in the merge beside any block with a valid key.
// The extra write is B * H * T floats, a 1 / hd share of the output's
// bytes; the bound and the design are the f32 instance's.
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
// 128-key tiles, the Pallas kernel's default block (flash_wavlm.py:262), so p
// is rounded against the max the Pallas kernel rounds it against; the plain
// version rounds against the same running max.
// What bounds it on this card: the same 36.8 GFLOP at T = 2999 on bf16
// operands at the dense bf16 tensor-core rate of 989 TFLOP/s, 0.037 ms,
// against 0.0073 ms for the 24.6 MB of bf16 q, k, v and out: bound by the
// tensor cores. Its own kernel body feeds them bf16 directly:
//  * One block of two warpgroups (64 query rows each, 128 queries) per (b,
//    h, 128-query tile); the warps loop over 128-key tiles. S = Q K^T is one
//    wgmma m64n128k16 a 16-wide step, q's fragments held in registers and
//    the k tile [128 keys][hd] K-major in shared memory; P.V is wgmma
//    m64n{hd}k16 with p from registers (rounded to bf16 and packed in pairs
//    straight from the scores' accumulators) and the v tile read MN-major
//    (transposed) as it lies. No operand is widened and no TF32 instruction
//    is issued. The next tile's S is issued behind this tile's P.V, so the
//    two run together while the warps wait.
//  * Each tile's k and v arrive by TMA (cp.async.bulk.tensor, 3-D tensor
//    maps over [B, T, H * hd], 128-byte swizzle at hd 64, 32-byte at hd 16,
//    the swizzle wgmma's descriptors name) into a 3-stage ring with full and
//    empty mbarriers; warp 0 issues the copies, and writes the tile's bias
//    window and key-mask terms beside them, once every warp has released
//    the stage. (A producer warp of its own would make 9 warps, 3 on one of
//    the SM's four register files: ptxas then caps a thread at 168
//    registers and spills; 8 warps keep up to 255.) A box never crosses
//    into the next batch row: the map's T axis ends each row, and TMA fills
//    rows past T with zeros.
//  * P.V of each tile sums into a fresh accumulator, added to O in f32, as
//    in the f32 instance: one running sum over 3000 keys would move about
//    1e-4 relative, and with it many outputs' bf16 rounding.
//  * 102 KB of shared memory (hd 64): one block an SM; at B = 1, T = 2999
//    the grid is 24 query tiles x 16 heads = 384 blocks, 2.9 waves over 132
//    SMs; at B = 8, T = 249, 256 blocks, 1.9 waves. The scale, gated bias,
//    mask, exp2 and rounding of every score on the CUDA cores take about as
//    long as the products (PERF.md section 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kKeys = 64;           // keys per tile
constexpr int kNT = kKeys / 8;      // 8-key steps of a tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

// 2^x on the SFU (relative error about 2^-22); flushes results below 2^-126 to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_wavlm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ gate,
                   const float* __restrict__ bias_diag,
                   const float* __restrict__ kvalid, float* __restrict__ out,
                   float* __restrict__ lse, int T, int H, float scale) {
  static_assert(HD % 16 == 0 && HD <= 64, "8-wide steps, whole float4 rows");
  using L = Layout<HD>;
  constexpr int kK = HD / 8;          // 8-wide steps of q . k; 8-column tiles of out

  extern __shared__ __align__(16) float smem[];
  const float* ks = smem + L::kSplitK;
  const float* vs = smem + L::kSplitV;
  float* w_s = smem + L::kWin;
  float* n_s = smem + L::kMask;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t head = ((size_t)b * T * H + h) * HD;
  const float* diag = bias_diag + (size_t)h * (2 * T - 1);
  const float* kv = kvalid ? kvalid + (size_t)b * T : nullptr;

  // this lane's two query rows: r0 (= fragment row g) and r1 (= g + 8)
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool in0 = q0 + r0 < T, in1 = q0 + r1 < T;

  load_raw<HD>(smem, k + head, v + head, 0, T, row_stride, tid);

  // q . k's A fragments, split once: step kk, k index t <-> element 8kk + 2t
  uint32_t qh[kK][4], ql[kK][4];
  {
    const float* qa = q + head + (size_t)(in0 ? q0 + r0 : 0) * row_stride + 2 * t;
    const float* qb = q + head + (size_t)(in1 ? q0 + r1 : 0) * row_stride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float2 x0 = in0 ? *reinterpret_cast<const float2*>(qa + 8 * kk) : make_float2(0.f, 0.f);
      const float2 x1 = in1 ? *reinterpret_cast<const float2*>(qb + 8 * kk) : make_float2(0.f, 0.f);
      tf32x3::split_a(x0, x1, qh[kk], ql[kk]);
    }
  }
  const float* gate_row = gate + ((size_t)b * H + h) * T + q0;
  const float g0 = in0 ? gate_row[r0] : 0.f;
  const float g1 = in1 ? gate_row[r1] : 0.f;
  const float sl = scale * kLog2e;    // scores are kept in log2 units
  const float neg = kNeg * kLog2e;    // a masked key's term

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
        if (c < 2 * kKeys - 1 && d >= 0 && d <= 2LL * T - 2) w = diag[d] * kLog2e;
        w_s[c] = w;
      }
    }
    __syncthreads();                   // split tiles, mask and window in place; raw buffers free
    if (kt + 1 < nk)
      load_raw<HD>(smem, k + head, v + head, k0 + kKeys, T, row_stride, tid);

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
        const uint4 f = *reinterpret_cast<const uint4*>(ks + (8 * j + g) * L::KS + 16 * kk + 4 * t);
        tf32x3::mma3(s[j], qh[kk], ql[kk], f.x, f.y, f.z, f.w);
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
      uint32_t ph[4], pl[4];
      tf32x3::split_a(make_float2(s[j][0], s[j][1]), make_float2(s[j][2], s[j][3]), ph, pl);
#pragma unroll
      for (int n = 0; n < kK; ++n) {
        const uint4 f = *reinterpret_cast<const uint4*>(vs + (4 * j + t) * L::VS + 4 * (8 * n + g));
        tf32x3::mma3(pv[n], ph, pl, f.x, f.y, f.z, f.w);
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
  if (kLse && t == 0) {                // m is in log2 units: lse = m ln 2 + log l
    float* row = lse + ((size_t)b * H + h) * T + q0;
    if (in0) row[r0] = fmaf(m0, kLn2, logf(l0));
    if (in1) row[r1] = fmaf(m1, kLn2, logf(l1));
  }
  // o[n]: columns 8n + 2t, 8n + 2t + 1 of rows r0 (c0, c1) and r1 (c2, c3)
  if (in0) {
    float* dst = out + head + (size_t)(q0 + r0) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kK; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][0] / l0, o[n][1] / l0);
  }
  if (in1) {
    float* dst = out + head + (size_t)(q0 + r1) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kK; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2] / l1, o[n][3] / l1);
  }
}

template <int HD, bool kLse>
cudaError_t launch(const float* q, const float* k, const float* v, const float* gate,
                   const float* bias_diag, const float* kvalid, float* out, float* lse, int B,
                   int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<HD>::floats;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wavlm_kernel<HD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wavlm_kernel<HD, kLse>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_wavlm_kernel<HD, kLse><<<grid, kThreads, smem, stream>>>(
      q, k, v, gate, bias_diag, kvalid, out, lse, T, H, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the bf16 instance

namespace b16 {

using namespace hopper;

constexpr int kWarps = 8;                     // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;           // 128 queries per block
constexpr int kKTile = 128;                   // keys per tile: the Pallas kernel's default block
constexpr int kNT = kKTile / 8;               // 8-key accumulator tiles of S
constexpr int kStages = 3;
static_assert(kQTile == kKTile, "the bias window spans one 128 x 128 tile pair");

// One ring stage: the k tile [128][HD] and the v tile [128][HD] as TMA lays
// them (swizzled, each 1024-byte aligned), then the tile's bias window
// [256] (offset col - row + 127, times log2 e; the last entry unused) and
// key terms [128] (0, NEG_bf16 * log2 e, or -inf past T), f32.
template <int HD>
struct Stage {
  static constexpr int kTileBytes = kKTile * HD * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTileBytes;
  static constexpr int kWin = 2 * kTileBytes;
  static constexpr int kMask = kWin + 4 * 2 * kKTile;
  static constexpr int kBytes = (kMask + 4 * kKTile + 1023) / 1024 * 1024;
  // the ring, then the full and empty barriers; + 1024 to align the base
  static constexpr int kBars = kStages * kBytes;
  static constexpr size_t kSmem = (size_t)kBars + 16 * kStages + 1024;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Warp 0 fills stage s with key tile kt: the bias window and the key terms
// by hand, k and v by TMA; every lane arrives on the stage's full barrier,
// lane 0 with the TMA's bytes.
template <int HD>
__device__ __forceinline__ void fill_stage(uint8_t* smem, uint32_t base, uint32_t full,
                                           const CUtensorMap* k_map, const CUtensorMap* v_map,
                                           const __nv_bfloat16* diag, const float* kv, int s,
                                           int kt, int q0, int T, int h, int b, int lane) {
  using S = Stage<HD>;
  constexpr float kLog2e = 1.4426950408889634f;
  const int k0 = kt * kKTile;
  uint8_t* st = smem + s * S::kBytes;
  float* w_s = reinterpret_cast<float*>(st + S::kWin);
  float* n_s = reinterpret_cast<float*>(st + S::kMask);
  const float neg = round_bf16(-1e30f) * kLog2e;
#pragma unroll
  for (int e = 0; e < 2 * kKTile / 32; ++e) {
    const int c = lane + 32 * e;              // 0 .. 255
    const long long d = (long long)k0 - q0 + T - 1 - (kKTile - 1) + c;
    w_s[c] = (c < 2 * kKTile - 1 && d >= 0 && d <= 2LL * T - 2)
                 ? __bfloat162float(diag[d]) * kLog2e : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kKTile / 32; ++e) {
    const int c = lane + 32 * e, u = k0 + c;
    n_s[c] = u >= T ? -INFINITY : (kv && !(kv[u] > 0.f)) ? neg : 0.f;
  }
  if (lane == 0) {
    mbar_arrive_expect_tx(full, 2 * S::kTileBytes);
    tma_load_3d(base + s * S::kBytes + S::kK, k_map, full, h * HD, k0, b);
    tma_load_3d(base + s * S::kBytes + S::kV, v_map, full, h * HD, k0, b);
  } else {
    mbar_arrive(full);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ gate,
                  const __nv_bfloat16* __restrict__ bias_diag, const float* __restrict__ kvalid,
                  __nv_bfloat16* __restrict__ out, int T, int H, float scale) {
  static_assert(HD == 16 || HD == 64, "the instances the wrapper takes");
  using S = Stage<HD>;
  constexpr int kK = HD / 16;         // 16-wide steps of q . k
  constexpr int kN = HD / 8;          // 8-column tiles of out
  constexpr int kSpan = HD * 2;       // bytes of a k or v row: the swizzle's span
  constexpr uint32_t kLayout = HD == 64 ? 1 : 3;   // wgmma's code for that swizzle
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + S::kBars;           // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;      // empty[s] at empty0 + 8 s

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = (T + kKTile - 1) / kKTile;
  const __nv_bfloat16* diag = bias_diag + (size_t)h * (2 * T - 1);
  const float* kv = kvalid ? kvalid + (size_t)b * T : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);                 // warp 0's lanes (+ TMA's bytes)
      mbar_init(empty0 + 8 * s, kWarps);            // one lane of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp 0 also keeps the ring full: the first stages now, stage s again
  // once every warp is done with it
  if (warp == 0)
    for (int kt = 0; kt < kStages && kt < nk; ++kt)
      fill_stage<HD>(smem, base, full0 + 8 * kt, &k_map, &v_map, diag, kv, kt, kt, q0, T, h, b,
                     lane);

  // this lane's query rows r0 = 16 warp + g and r1 = r0 + 8 of the tile
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool in0 = q0 + r0 < T, in1 = q0 + r1 < T;
  const size_t row_stride = (size_t)H * HD;
  const size_t head = ((size_t)b * T * H + h) * HD;

  // q's A fragments, step kk: elements 16 kk + 2t (a0, a1) and + 8 (a2, a3)
  uint32_t qa[kK][4];
  {
    const __nv_bfloat16* pa = q + head + (size_t)(in0 ? q0 + r0 : 0) * row_stride + 2 * t;
    const __nv_bfloat16* pb = q + head + (size_t)(in1 ? q0 + r1 : 0) * row_stride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      qa[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(pa + 16 * kk) : 0u;
      qa[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(pb + 16 * kk) : 0u;
      qa[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(pa + 16 * kk + 8) : 0u;
      qa[kk][3] = in1 ? *reinterpret_cast<const uint32_t*>(pb + 16 * kk + 8) : 0u;
    }
  }
  const __nv_bfloat16* gate_row = gate + ((size_t)b * H + h) * T + q0;
  const float g0 = in0 ? __bfloat162float(gate_row[r0]) : 0.f;
  const float g1 = in1 ? __bfloat162float(gate_row[r1]) : 0.f;
  const float sl = scale * kLog2e;    // scores are kept in log2 units

  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;               // running sum of the rounded p, this lane's columns
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // S = Q K^T of key tile kt on the warpgroup (warps 4 wg .. 4 wg + 3, query
  // rows 64 wg .. 64 wg + 63) into sc, once the tile has landed: one
  // m64n128k16 wgmma a 16-wide step, q's fragments from registers, the k
  // tile [128 keys][HD] K-major from shared memory. sc[4j + e] is c_e of
  // keys 8j .. 8j + 7. Committed, not waited for.
  float sc[4 * kNT];
  auto issue_s = [&](int kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint32_t ks = base + s * S::kBytes + S::kK;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      wgmma_m64n128k16_rs(sc, qa[kk], desc_swizzled(ks + 32 * kk, kLayout, 8 * kSpan), kk);
    wgmma_commit();
  };
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const uint32_t round = kt / kStages;
    const uint32_t vs = base + s * S::kBytes + S::kV;
    const float* w_s = reinterpret_cast<const float*>(smem + s * S::kBytes + S::kWin);
    const float* n_s = reinterpret_cast<const float*>(smem + s * S::kBytes + S::kMask);

    // scale, gated bias, key term; online softmax across the quad's 128
    // columns. Keys past T carry -inf: they weigh 0 and never set the max.
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float nm = n_s[col];
        sc[4 * j + e] = fmaf(sc[4 * j + e], sl, fmaf(g0, w_s[col - r0 + kKTile - 1], nm));
        sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], sl, fmaf(g1, w_s[col - r1 + kKTile - 1], nm));
        mt0 = fmaxf(mt0, sc[4 * j + e]);
        mt1 = fmaxf(mt1, sc[4 * j + 2 + e]);
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

    // p = exp(s - m) rounded to bf16, summed as rounded, packed in pairs: the
    // pair a lane holds in c0, c1 of key tile j is its A fragment entry of
    // P.V's step j / 2 (a0 / a1 for even j, a2 / a3 for odd j)
    uint32_t pa[kNT][2];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float p0 = round_bf16(exp2_ftz(sc[4 * j + 0] - mn0));
      const float p1 = round_bf16(exp2_ftz(sc[4 * j + 1] - mn0));
      const float p2 = round_bf16(exp2_ftz(sc[4 * j + 2] - mn1));
      const float p3 = round_bf16(exp2_ftz(sc[4 * j + 3] - mn1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[j][0] = pack_bf16(p0, p1);
      pa[j][1] = pack_bf16(p2, p3);
    }
    l0 = fmaf(l0, alpha0, ps0);
    l1 = fmaf(l1, alpha1, ps1);

    // P V of this tile into a fresh accumulator (as in the f32 instance):
    // one m64n{HD}k16 wgmma a 16-key step, p from registers, the v tile
    // [128 keys][HD] MN-major (transposed) from shared memory, 16 rows of
    // it a step. pv[4n + e] is c_e of out columns 8n .. 8n + 7.
    // The next tile's S is issued behind it, so that its products run while
    // this one's finish; both are waited for together.
    float pv[4 * kN];
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const uint64_t db = desc_swizzled(vs + 16 * kSpan * kk, kLayout, 8 * kSpan);
      if constexpr (HD == 64)
        wgmma_m64n64k16_rs_mn(pv, a, db, kk);
      else
        wgmma_m64n16k16_rs_mn(pv, a, db, kk);
    }
    wgmma_commit();
    if (kt + 1 < nk) issue_s(kt + 1);
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);    // this warp is done with the stage
    if (warp == 0 && kt + kStages < nk) {          // refill it with tile kt + kStages
      mbar_wait(empty0 + 8 * s, round & 1);
      fill_stage<HD>(smem, base, full0 + 8 * s, &k_map, &v_map, diag, kv, s, kt + kStages, q0,
                     T, h, b, lane);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] = fmaf(o[n][0], alpha0, pv[4 * n + 0]);
      o[n][1] = fmaf(o[n][1], alpha0, pv[4 * n + 1]);
      o[n][2] = fmaf(o[n][2], alpha1, pv[4 * n + 2]);
      o[n][3] = fmaf(o[n][3], alpha1, pv[4 * n + 3]);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // o[n]: columns 8n + 2t, 8n + 2t + 1 of rows r0 (c0, c1) and r1 (c2, c3)
  if (in0) {
    __nv_bfloat16* dst = out + head + (size_t)(q0 + r0) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
  }
  if (in1) {
    __nv_bfloat16* dst = out + head + (size_t)(q0 + r1) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

// A 3-D map over x [B, T, H * HD] bf16 with boxes of HD x 128 rows of one
// batch row: a box never crosses into the next row, and rows past T read
// as zeros.
template <int HD>
bool head_tile_map(CUtensorMap* map, const void* x, int B, int T, int H) {
  const cuuint64_t dims[3] = {(cuuint64_t)H * HD, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * HD * 2, (cuuint64_t)T * H * HD * 2};
  const cuuint32_t box[3] = {HD, kKTile, 1};
  return bf16_tile_map(map, x, 3, dims, strides, box);
}

template <int HD>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* gate, const __nv_bfloat16* bias_diag,
                   const float* kvalid, __nv_bfloat16* out, int B, int T, int H, float scale,
                   cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  if (!head_tile_map<HD>(&k_map, k, B, T, H) || !head_tile_map<HD>(&v_map, v, B, T, H))
    return cudaErrorInvalidValue;
  const size_t smem = Stage<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQTile - 1) / kQTile, H, B);
  flash_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(k_map, v_map, q, gate, bias_diag,
                                                          kvalid, out, T, H, scale);
  return cudaGetLastError();
}

}  // namespace b16

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
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16, false>(q, k, v, gate, bias_diag, kvalid, out, nullptr, B, T, H,
                                    scale, s);
    case 64:
      return (int)launch<64, false>(q, k, v, gate, bias_diag, kvalid, out, nullptr, B, T, H,
                                    scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The block instance: the f32 instance's arguments, and lse, an f32 [B, H, T]
// that receives each row's log-sum-exp of its scores (natural log).
int sdumc_flash_wavlm_lse(const float* q, const float* k, const float* v, const float* gate,
                          const float* bias_diag, const float* kvalid, float* out, float* lse,
                          int B, int T, int H, int hd, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535 || !lse)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16, true>(q, k, v, gate, bias_diag, kvalid, out, lse, B, T, H, scale,
                                   s);
    case 64:
      return (int)launch<64, true>(q, k, v, gate, bias_diag, kvalid, out, lse, B, T, H, scale,
                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 instance: q, k, v, gate, bias_diag and out are bf16, with the
// f32 instance's shapes; kvalid stays f32. scale must be a power of two.
int sdumc_flash_wavlm_bf16(const void* q, const void* k, const void* v, const void* gate,
                           const void* bias_diag, const float* kvalid, void* out,
                           int B, int T, int H, int hd, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  using E = __nv_bfloat16;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* ge = static_cast<const E*>(gate);
  const E* de = static_cast<const E*>(bias_diag);
  E* oe = static_cast<E*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)b16::launch<16>(qe, ke, ve, ge, de, kvalid, oe, B, T, H, scale, s);
    case 64: return (int)b16::launch<64>(qe, ke, ve, ge, de, kvalid, oe, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sdumc_flash_wavlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
