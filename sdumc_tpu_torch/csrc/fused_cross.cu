// Fused key projection + masked online-softmax cross attention, for Hopper.
//
// Replaces the TPU kernel sdumc_tpu/ops/pallas/fused_cross.py::_cross_kernel
// (launched by _cross_forward, pallas_call at fused_cross.py:139). That one
// kernel carries both frame-attention ops of the fusion net: the 7-query
// CrossAttention (Q = 7) and, with the learned context vector as the single
// query, the FRA2UTTNew pool (fused_pool.py, Q = 1). For batch row b:
//
//     k[t]     = tanh(x[b, t] @ W^T + bias)     W in torch Linear layout [D, D]
//     s[q, t]  = scale * q[b, q] . k[t]         only for t < n_valid(b)
//     out[b, q] = sum_t softmax_t(s[q, :])[t] * x[b, t]
//
// n_valid(b) = min(t_max[b], T); t_max <= 0 masks every frame, and the
// softmax over all-equal masked scores is then uniform over all T frames,
// which the kernel reproduces with zero scores over all T.
//
// What bounds it on an H100: the key projection, 2 * D * D flops per valid
// frame against 4 * D bytes of x read once: at D = 256, 128 flop per byte.
// The projection runs on the tensor cores in the 3xTF32 split of tf32x3.cuh
// (three TF32 passes, f32 accumulate, f32-grade keys; the precision is fixed
// and does not follow torch's allow_tf32), so its least time is 3 x 2 D^2
// flops per frame at 495 TFLOP/s; the scores and the weighted sum (4 Q D
// flops per frame, Q = 7 padded to 8, or 1: below any MMA tile) stay f32 FMA
// on the CUDA cores beside it. The design:
//  * One block of 8 warps per (row, 64-frame tile): a row's tiles run on as
//    many blocks, so the 64-row dual batch fills the 132 SMs several times
//    over; blocks past the row's t_max exit at once. A second small kernel
//    merges the per-tile (max, sum, accumulator) triples, as flash-decoding
//    does, over the tiles that the row's t_max keeps.
//  * W (256 KB) is split into hi and lo once per call, by a first small
//    kernel, into a layout that interleaves the two parts: one 16-byte load
//    then gives a lane its whole B fragment, and the main loop splits only
//    the x fragments it loads.
//  * The [64, 256] block of k = x W^T is computed in 16 stages of 16 input
//    features; each stage's x columns and split W columns (38 KB) stream
//    through a 2-stage cp.async ring, so the next stage's loads fly while
//    this one's MMAs run. Warp w owns frames 32 (w % 2) .. + 31 and key
//    columns 64 (w / 2) .. + 63: two 16-row by eight 8-column accumulators.
//    W's pairs are swizzled by row parity so that a quarter warp's loads
//    fall on distinct banks.
//  * k never reaches device memory: tanh, the bias and the partial scores
//    over a warp's 64 columns are taken from the accumulators, summed across
//    the quad and then across the 4 column warps in shared memory.
//  * While the scores are taken, the f32 x tile is staged again into the
//    ring's 64 KB for the weighted sum, one column per thread.
//  * 84 KB of shared memory and at most 128 registers a thread let 2 blocks
//    share an SM.
//
// The bf16 instance (sdumc_fused_cross_bf16) is the same kernel with x read
// as bf16 and the output rounded to bf16 (to nearest even), as the Pallas
// kernel computes at bf16 x (out_shape takes x's dtype, :142): W, the bias,
// the query, the keys, the scores, the softmax and the accumulator stay f32.
// x's tiles are staged as bf16 (half the bytes of the f32 instance, 8 values
// per 16-byte cp.async) and widened when a fragment or a column is read. A
// bf16 value is exact in TF32 (7 stored mantissa bits against 10), so its
// 3xTF32 split has lo = 0: the x_lo . W_hi pass is dropped and the key
// projection issues 2 TF32 passes, with the same f32 sums as the three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps: 2 (frames) x 4 (key columns)
constexpr int kD = 256;                // feature width; one accumulator column per thread
constexpr int kBT = 64;                // frames per tile
constexpr int kKC = 16;                // input features per pipeline stage: two 8-wide steps
constexpr int kCS = kKC + 8;           // row stride of a stage's x: a quarter warp's float2
                                       // loads (4 rows g, elements 2t) hit 32 banks
constexpr int kCSb = kKC + 8;          // ... in bf16 elements (48 bytes): a warp's bf16 pair
                                       // loads (8 rows g, words t) hit 32 banks
constexpr int kWS = 2 * kKC;           // row stride of a stage's split W: 8 pairs of 4 floats
constexpr int kChunks = kD / kKC;
constexpr int kStages = 2;
constexpr int kXC = kBT * kCS;         // floats of a stage's x columns [64][kCS]
constexpr int kStage = kXC + kD * kWS; // ... and split W columns [256][kWS]
constexpr int kColWarps = 4;           // warps that share a frame, over the key columns
constexpr int kQG = 4;                 // queries per pass over a warp's keys

// The ring holds the stages during the projection, then the x tile [64][256]
// and the score scratch of the epilogue.
template <int QP>
__host__ __device__ constexpr int ring_floats() {
  return kStages * kStage > kBT * kD + (kColWarps + 1) * QP * kBT
             ? kStages * kStage : kBT * kD + (kColWarps + 1) * QP * kBT;
}

template <int QP>
constexpr size_t smem_floats() {
  return (size_t)ring_floats<QP>() + QP * kD + 3 * QP;
}

template <typename TX>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<TX, __nv_bfloat16>::value; }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W split once per call: w_split[j][4p .. 4p + 3] = hi(w[j][2p]),
// hi(w[j][2p + 1]), lo(w[j][2p]), lo(w[j][2p + 1]), one lane's whole B
// fragment of an 8-wide step. One block per row j, one thread per pair p.
__global__ void __launch_bounds__(kD / 2)
split_w_kernel(const float* __restrict__ w, float* __restrict__ w_split) {
  const int j = blockIdx.x, p = threadIdx.x;
  const float2 a = *reinterpret_cast<const float2*>(w + (size_t)j * kD + 2 * p);
  uint32_t h0, l0, h1, l1;
  tf32x3::split(a.x, h0, l0);
  tf32x3::split(a.y, h1, l1);
  *reinterpret_cast<uint4*>(w_split + (size_t)j * 2 * kD + 4 * p) = make_uint4(h0, h1, l0, l1);
}

// Frames t0 .. t0 + 63 of x and every row of the split W, input features
// 16c .. 16c + 15, into one ring stage; frames past `rows` are zero-filled.
// x's rows sit at a stride of kCS floats (kCSb bf16 values for bf16 x).
// In the stage, W row j's 8 pairs sit with pair q at q ^ 4 (j & 1), so the
// two rows a quarter warp reads fall on distinct banks.
template <typename TX>
__device__ __forceinline__ void load_stage(float* stage, const TX* xb, const float* w_split,
                                           int t0, int rows, int c, int tid) {
  constexpr int kVec = 16 / sizeof(TX);        // x values per 16-byte copy
  constexpr int kPerRow = kKC / kVec;          // copies per row of a stage
  constexpr int kXS = is_bf16<TX>() ? kCSb : kCS;
  if (tid < kBT * kPerRow) {
    const int r = tid / kPerRow, v = tid % kPerRow;
    TX* dst = reinterpret_cast<TX*>(stage) + r * kXS + kVec * v;
    if (r < rows)
      cp_async16(dst, xb + (size_t)(t0 + r) * kD + kKC * c + kVec * v);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int j0 = tid >> 3, q = tid & 7;
  float* ws = stage + kXC + j0 * kWS + 4 * (q ^ ((j0 & 1) << 2));
  const float* src = w_split + (size_t)j0 * 2 * kD + 2 * kKC * c + 4 * q;
#pragma unroll
  for (int m = 0; m < kD / (kThreads / 8); ++m)
    cp_async16(ws + m * (kThreads / 8) * kWS, src + (size_t)m * (kThreads / 8) * 2 * kD);
}

// 64-frame tiles of a row with this t_max (all T frames when t_max <= 0).
__device__ __forceinline__ int row_tiles(int tm, int T) {
  const int n_valid = tm <= 0 ? T : min(tm, T);
  return (n_valid + kBT - 1) / kBT;
}

template <int QP, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
cross_partial_kernel(const float* __restrict__ q, long long q_bstride,
                     const TX* __restrict__ x,
                     const float* __restrict__ w_split,
                     const float* __restrict__ bias,
                     const int* __restrict__ tmax, int tmax_scalar,
                     int Q, int T, int nsplit, float scale,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part) {
  static_assert(kBT == 64, "the softmax pass gives each lane two frames");
  static_assert(QP <= kThreads / 32, "one warp per query");
  static_assert(kD == kThreads, "one accumulator column per thread");
  static_assert(kKC == 16, "a stage is two 8-wide steps");

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int tm = tmax ? tmax[b] : tmax_scalar;
  const bool uniform = tm <= 0;
  const int n_valid = uniform ? T : min(tm, T);
  const int ntiles = row_tiles(tm, T);
  const int per_split = (ntiles + nsplit - 1) / nsplit;
  const int tile_begin = split * per_split;
  if (tile_begin >= ntiles) return;    // past this row's t_max: no partial
  const int tile_end = min(ntiles, tile_begin + per_split);

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // kStages x [x: 64][kCS] [W: 256][kWS], then:
  float* sp_s = ring + kBT * kD;         //   x tile [64][256]; [4][QP][kBT] scores over
  float* s_s = sp_s + kColWarps * QP * kBT;  // each column warp's keys; [QP][kBT] scores
  float* q_s = ring + ring_floats<QP>(); // [QP][kD]       queries, zero-padded
  float* m_s = q_s + QP * kD;            // [QP] running max
  float* l_s = m_s + QP;                 // [QP] running sum
  float* a_s = l_s + QP;                 // [QP] rescale of this tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp & 1);        // this warp's frames wm .. wm + 31
  const int wc = warp >> 1;              // ... and key columns 64 wc .. 64 wc + 63
  const int wn = 64 * wc;

  const TX* xb = x + (size_t)b * T * kD;
  const float* qb = q + (size_t)b * q_bstride;
  TX* x_tile = reinterpret_cast<TX*>(ring);  // [64][256] for the weighted sum
  for (int i = tid; i < QP * kD; i += kThreads) q_s[i] = i < Q * kD ? qb[i] : 0.f;
  if (tid < QP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc_out[QP];
#pragma unroll
  for (int j = 0; j < QP; ++j) acc_out[j] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int t0 = tile * kBT;
    const int rows = min(kBT, n_valid - t0);
    __syncthreads();  // the previous tile's readers of the ring and s_s are done

    // acc[mi][ni]: frames wm + 16 mi + (g, g + 8), columns wn + 8 ni + (2t, 2t + 1)
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    if (!uniform) {
      load_stage(ring, xb, w_split, t0, rows, 0, tid);
      cp_async_commit();
      static_assert(kChunks % kStages == 0, "unrolled by the ring's stages");
#pragma unroll 2
      for (int c = 0; c < kChunks; ++c) {
        cp_async_wait<0>();
        __syncthreads();  // stage c landed for everyone; stage c - 1's readers are done
        if (c + 1 < kChunks)
          load_stage(ring + ((c + 1) % kStages) * kStage, xb, w_split, t0, rows, c + 1, tid);
        cp_async_commit();

        const float* xs = ring + (c % kStages) * kStage;
        const float* ws = xs + kXC;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t ah[2][4], al[2][4];   // [m tile][fragment] of step s
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if constexpr (is_bf16<TX>()) {
              // a bf16 value widened to f32 is its own TF32 hi; lo = 0
              const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(xs) +
                                        (wm + 16 * mi + g) * kCSb + 8 * s + 2 * t;
              const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr));
              const float2 x1 =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + 8 * kCSb));
              ah[mi][0] = __float_as_uint(x0.x);
              ah[mi][1] = __float_as_uint(x1.x);
              ah[mi][2] = __float_as_uint(x0.y);
              ah[mi][3] = __float_as_uint(x1.y);
            } else {
              const float* xr = xs + (wm + 16 * mi + g) * kCS + 8 * s + 2 * t;
              tf32x3::split_a(*reinterpret_cast<const float2*>(xr),
                              *reinterpret_cast<const float2*>(xr + 8 * kCS), ah[mi], al[mi]);
            }
          }
          // pair 4s + t of W row wn + 8 ni + g (the row's parity is g's)
          const float* wr = ws + (wn + g) * kWS + 4 * ((4 * s + t) ^ ((g & 1) << 2));
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const uint4 f = *reinterpret_cast<const uint4*>(wr + 8 * ni * kWS);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if constexpr (is_bf16<TX>()) {
                tf32x3::mma(acc[mi][ni], ah[mi], f.z, f.w);   // x . W_lo, then x . W_hi
                tf32x3::mma(acc[mi][ni], ah[mi], f.x, f.y);
              } else {
                tf32x3::mma3(acc[mi][ni], ah[mi], al[mi], f.x, f.y, f.z, f.w);
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the ring
    }

    // stage the x tile again for the weighted sum; it lands during the scores
    constexpr int kVec = 16 / sizeof(TX);
#pragma unroll
    for (int k = 0; k < kBT * kD / kVec / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / (kD / kVec), cv = i % (kD / kVec);
      TX* dst = x_tile + r * kD + kVec * cv;
      if (r < rows)
        cp_async16(dst, xb + (size_t)(t0 + r) * kD + kVec * cv);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();

    if (uniform) {
      for (int i = tid; i < QP * kBT; i += kThreads) s_s[i] = 0.f;
    } else {
      // k = tanh(acc + bias) in place: acc[mi][ni] = k at frames wm + 16 mi
      // + (g, g + 8), columns wn + 8 ni + (2t, 2t + 1)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float2 bj = *reinterpret_cast<const float2*>(bias + wn + 8 * ni + 2 * t);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = tanhf(acc[mi][ni][0] + bj.x);
          acc[mi][ni][1] = tanhf(acc[mi][ni][1] + bj.y);
          acc[mi][ni][2] = tanhf(acc[mi][ni][2] + bj.x);
          acc[mi][ni][3] = tanhf(acc[mi][ni][3] + bj.y);
        }
      }
      // partial scores of this lane's 4 frames over its 16 columns, kQG
      // queries at a time, summed across the quad, then across the column warps
#pragma unroll
      for (int j0 = 0; j0 < QP; j0 += kQG) {
        constexpr int kG = QP < kQG ? QP : kQG;
        float sp[kG][2][2];
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) sp[j][mi][0] = sp[j][mi][1] = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
          for (int j = 0; j < kG; ++j) {
            const float2 qv =
                *reinterpret_cast<const float2*>(q_s + (j0 + j) * kD + wn + 8 * ni + 2 * t);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                sp[j][mi][hh] = fmaf(qv.x, acc[mi][ni][2 * hh],
                                     fmaf(qv.y, acc[mi][ni][2 * hh + 1], sp[j][mi][hh]));
          }
        }
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float v = sp[j][mi][hh];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              if (j % 4 == t)
                sp_s[(wc * QP + j0 + j) * kBT + wm + 16 * mi + 8 * hh + g] = v;
            }
      }
      __syncthreads();
      for (int i = tid; i < QP * kBT; i += kThreads) {
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < kColWarps; ++c) v += sp_s[c * QP * kBT + i];
        s_s[i] = scale * v;
      }
    }
    __syncthreads();

    // online softmax statistics; warp j owns query j
    if (warp < QP) {
      float* sr = s_s + warp * kBT;
      const bool ok0 = lane < rows, ok1 = lane + 32 < rows;
      const float v0 = ok0 ? sr[lane] : -INFINITY;
      const float v1 = ok1 ? sr[lane + 32] : -INFINITY;
      float mt = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, mt);  // finite: rows >= 1
      const float p0 = ok0 ? expf(v0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(v1 - m_new) : 0.f;
      sr[lane] = p0;
      sr[lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[warp] = alpha;
        l_s[warp] = alpha * l_s[warp] + ps;
        m_s[warp] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the x tile landed; weights and rescales are in place

    // acc_out[q][d] = alpha[q] * acc_out[q][d] + sum_t p[q][t] * x[t][d], d = tid;
    // four frames at a time: weights and x rows past `rows` are zero
#pragma unroll
    for (int j = 0; j < QP; ++j) acc_out[j] *= a_s[j];
    for (int r = 0; r < rows; r += 4) {
      const float x0 = widen(x_tile[r * kD + tid]), x1 = widen(x_tile[(r + 1) * kD + tid]);
      const float x2 = widen(x_tile[(r + 2) * kD + tid]), x3 = widen(x_tile[(r + 3) * kD + tid]);
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const float4 pw = *reinterpret_cast<const float4*>(s_s + j * kBT + r);
        acc_out[j] = fmaf(pw.x, x0, fmaf(pw.y, x1, fmaf(pw.z, x2, fmaf(pw.w, x3, acc_out[j]))));
      }
    }
  }

  __syncthreads();  // the statistics are final
  const size_t base = ((size_t)b * nsplit + split) * QP;
  if (tid < QP) {
    m_part[base + tid] = m_s[tid];
    l_part[base + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < QP; ++j) acc_part[(base + j) * kD + tid] = acc_out[j];
}

// out[b, q, d] = sum_s e^(m_s - M) acc_s[d] / sum_s e^(m_s - M) l_s, over
// the splits that hold a tile of row b (split 0 always does).
template <int QP, typename TX>
__global__ void __launch_bounds__(kThreads)
cross_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     const int* __restrict__ tmax, int tmax_scalar,
                     TX* __restrict__ out, int Q, int T, int nsplit) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int d = threadIdx.x;
  const int ntiles = row_tiles(tmax ? tmax[b] : tmax_scalar, T);
  const int per_split = (ntiles + nsplit - 1) / nsplit;
  const int nact = (ntiles + per_split - 1) / per_split;
  const size_t base = (size_t)b * nsplit * QP + j;
  float m = -INFINITY;
  for (int s = 0; s < nact; ++s) m = fmaxf(m, m_part[base + s * QP]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nact; ++s) {
    const size_t row = base + s * QP;
    const float e = expf(m_part[row] - m);
    l = fmaf(e, l_part[row], l);
    a = fmaf(e, acc_part[row * kD + d], a);
  }
  store_out(out + ((size_t)b * Q + j) * kD + d, a / l);
}

template <int QP, typename TX>
cudaError_t launch(const float* q, long long q_bstride, const TX* x,
                   const float* w, const float* bias, const int* tmax,
                   int tmax_scalar, TX* out, float* m_part, float* l_part,
                   float* acc_part, float* w_split, int B, int Q, int T, int nsplit,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<QP>();
  cudaError_t err = cudaFuncSetAttribute(
      cross_partial_kernel<QP, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cross_partial_kernel<QP, TX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  split_w_kernel<<<kD, kD / 2, 0, stream>>>(w, w_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_partial_kernel<QP, TX><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      q, q_bstride, x, w_split, bias, tmax, tmax_scalar, Q, T, nsplit, scale,
      m_part, l_part, acc_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_combine_kernel<QP, TX><<<dim3(B, Q), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, tmax, tmax_scalar, out, Q, T, nsplit);
  return cudaGetLastError();
}

template <typename TX>
int dispatch(const float* q, long long q_bstride, const TX* x, const float* w,
             const float* bias, const int* tmax, int tmax_scalar, TX* out, float* m_part,
             float* l_part, float* acc_part, float* w_split, int B, int Q, int T, int D,
             int nsplit, float scale, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || Q > 8 || D != kD || nsplit < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 1)
    return (int)launch<1, TX>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out,
                              m_part, l_part, acc_part, w_split, B, Q, T, nsplit, scale, s);
  return (int)launch<8, TX>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out,
                            m_part, l_part, acc_part, w_split, B, Q, T, nsplit, scale, s);
}

}  // namespace

extern "C" {

// Launches the kernel pair on `stream`; returns the cudaError_t of the
// launches (0 on success). q rows are [Q, D] at q + b * q_bstride (stride 0
// broadcasts one query set); x [B, T, D], w [D, D], bias [D], out [B, Q, D]
// are contiguous f32 with D = 256; tmax is an int32 [B] array, or NULL to
// use tmax_scalar for every row. m_part/l_part hold B*nsplit*QP floats and
// acc_part B*nsplit*QP*D, with QP = 1 for Q = 1 and 8 otherwise; w_split
// holds 2*D*D floats (W's hi and lo parts, written here).
int sdumc_fused_cross(const float* q, long long q_bstride, const float* x,
                      const float* w, const float* bias, const int* tmax,
                      int tmax_scalar, float* out, float* m_part,
                      float* l_part, float* acc_part, float* w_split, int B, int Q,
                      int T, int D, int nsplit, float scale, void* stream) {
  return dispatch<float>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out, m_part, l_part,
                         acc_part, w_split, B, Q, T, D, nsplit, scale, stream);
}

// The bf16 instance: x and out are bf16 ([B, T, D] and [B, Q, D]); every
// other argument as above.
int sdumc_fused_cross_bf16(const float* q, long long q_bstride, const void* x,
                           const float* w, const float* bias, const int* tmax,
                           int tmax_scalar, void* out, float* m_part,
                           float* l_part, float* acc_part, float* w_split, int B, int Q,
                           int T, int D, int nsplit, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, q_bstride, static_cast<const __nv_bfloat16*>(x), w, bias,
                                 tmax, tmax_scalar, static_cast<__nv_bfloat16*>(out), m_part,
                                 l_part, acc_part, w_split, B, Q, T, D, nsplit, scale, stream);
}

const char* sdumc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
