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
// The bf16 instance (sdumc_fused_cross_bf16) has its own kernel body and
// computes what the Pallas kernel computes at bf16 x (out_shape takes x's
// dtype, :142): W, the bias, the query, the keys, the scores, the softmax and
// the accumulator stay f32 and the output is rounded to bf16 (to nearest
// even) once. What bounds it: the key projection's 2 D^2 flops per valid
// frame on bf16 operands. A first small kernel cuts W into three bf16 parts
// (hi, mid, lo; each the top 16 bits of what the earlier parts leave, so
// hi + mid + lo = W exactly for |w| >= 2^-110), and each x . part is exact
// in f32, so the keys are f32 grade from 3 bf16 passes: at 989 TFLOP/s
// against the earlier design's 2 TF32 passes at 495. The design:
//  * One block of two warpgroups per (row, 256-frame tile), one block an
//    SM. The x tile [256][256] arrives by TMA (four boxes of 64 features,
//    128-byte swizzle, frames past T read as zeros) and stays resident from
//    the projection to the weighted sum: x is read from device memory once.
//  * W's parts stream through a 4-stage ring of 16 KB TMA boxes ([128 key
//    columns][64 features] of one part), once per 256-frame tile: 1.5 KB of
//    W a frame; thread 0 refills a stage once every warp has released it
//    (full and empty mbarriers).
//  * The projection is bf16 wgmma m64n128k16, both operands from shared
//    memory through 128-byte-swizzle descriptors: each warpgroup owns 128
//    frames (two m64 tiles) and one 128-column chunk at a time, summing
//    lo, mid and hi into one accumulator. (n = 64 needs 4 KB of shared
//    memory per 64 x 64 x 16 product, the 128 bytes a clock the SM reads,
//    and measured a quarter slower.)
//  * k = tanh(k + bias) and the partial scores are taken from the
//    accumulators (tanh by the SFU's exp, within 2e-7), summed across the
//    quad; the softmax over the tile's 256 frames runs a warp per query;
//    the weighted sum (Q <= 8, below any MMA tile) is f32 FMA, four output
//    columns and a quarter of the frames a thread. The merge kernel is the
//    f32 instance's, over 256-frame tiles.
//  * 209 KB of shared memory. Measured per block of the audio call at Q = 7
//    on an H100 (bench/fusion_phases.py): the x tile's load 17% of the
//    time, the products 45%, tanh and scores 22%, the weighted sum 13%.
//    One block an SM leaves no other block to overlap these phases with,
//    and a row shorter than a tile still costs a whole tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps: 2 (frames) x 4 (key columns)
constexpr int kD = 256;                // feature width; one accumulator column per thread
constexpr int kBT = 64;                // frames per tile
constexpr int kKC = 16;                // input features per pipeline stage: two 8-wide steps
constexpr int kCS = kKC + 8;           // row stride of a stage's x: a quarter warp's float2
                                       // loads (4 rows g, elements 2t) hit 32 banks
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
// x's rows sit at a stride of kCS floats. In the stage, W row j's 8 pairs
// sit with pair q at q ^ 4 (j & 1), so the two rows a quarter warp reads
// fall on distinct banks.
__device__ __forceinline__ void load_stage(float* stage, const float* xb, const float* w_split,
                                           int t0, int rows, int c, int tid) {
  constexpr int kVec = 4;                      // x values per 16-byte copy
  constexpr int kPerRow = kKC / kVec;          // copies per row of a stage
  if (tid < kBT * kPerRow) {
    const int r = tid / kPerRow, v = tid % kPerRow;
    float* dst = stage + r * kCS + kVec * v;
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

// Tiles of a row with this t_max (all T frames when t_max <= 0): 64 frames
// (the f32 instance) or `tile`.
__device__ __forceinline__ int row_tiles(int tm, int T, int tile = kBT) {
  const int n_valid = tm <= 0 ? T : min(tm, T);
  return (n_valid + tile - 1) / tile;
}

template <int QP>
__global__ void __launch_bounds__(kThreads, 2)
cross_partial_kernel(const float* __restrict__ q, long long q_bstride,
                     const float* __restrict__ x,
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

  const float* xb = x + (size_t)b * T * kD;
  const float* qb = q + (size_t)b * q_bstride;
  float* x_tile = ring;                  // [64][256] for the weighted sum
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
            const float* xr = xs + (wm + 16 * mi + g) * kCS + 8 * s + 2 * t;
            tf32x3::split_a(*reinterpret_cast<const float2*>(xr),
                            *reinterpret_cast<const float2*>(xr + 8 * kCS), ah[mi], al[mi]);
          }
          // pair 4s + t of W row wn + 8 ni + g (the row's parity is g's)
          const float* wr = ws + (wn + g) * kWS + 4 * ((4 * s + t) ^ ((g & 1) << 2));
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const uint4 f = *reinterpret_cast<const uint4*>(wr + 8 * ni * kWS);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              tf32x3::mma3(acc[mi][ni], ah[mi], al[mi], f.x, f.y, f.z, f.w);
          }
        }
      }
      __syncthreads();  // every warp is done with the ring
    }

    // stage the x tile again for the weighted sum; it lands during the scores
    constexpr int kVec = 4;
#pragma unroll
    for (int k = 0; k < kBT * kD / kVec / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / (kD / kVec), cv = i % (kD / kVec);
      float* dst = x_tile + r * kD + kVec * cv;
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
      const float x0 = x_tile[r * kD + tid], x1 = x_tile[(r + 1) * kD + tid];
      const float x2 = x_tile[(r + 2) * kD + tid], x3 = x_tile[(r + 3) * kD + tid];
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
// the splits that hold a tile of row b (split 0 always does); rows are cut
// into tiles of TILE frames.
template <int QP, typename TX, int TILE>
__global__ void __launch_bounds__(kThreads)
cross_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     const int* __restrict__ tmax, int tmax_scalar,
                     TX* __restrict__ out, int Q, int T, int nsplit) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int d = threadIdx.x;
  const int ntiles = row_tiles(tmax ? tmax[b] : tmax_scalar, T, TILE);
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

template <int QP>
cudaError_t launch(const float* q, long long q_bstride, const float* x,
                   const float* w, const float* bias, const int* tmax,
                   int tmax_scalar, float* out, float* m_part, float* l_part,
                   float* acc_part, float* w_split, int B, int Q, int T, int nsplit,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<QP>();
  cudaError_t err = cudaFuncSetAttribute(
      cross_partial_kernel<QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cross_partial_kernel<QP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  split_w_kernel<<<kD, kD / 2, 0, stream>>>(w, w_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_partial_kernel<QP><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      q, q_bstride, x, w_split, bias, tmax, tmax_scalar, Q, T, nsplit, scale,
      m_part, l_part, acc_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_combine_kernel<QP, float, kBT><<<dim3(B, Q), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, tmax, tmax_scalar, out, Q, T, nsplit);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the bf16 instance

namespace b16 {

using namespace hopper;

constexpr int kWarps = 8;                // two warpgroups of 128 frames each
constexpr int kTile = 32 * kWarps;       // 256 frames per tile
constexpr int kNC = 128;                 // key columns per chunk: one wgmma's n
constexpr int kParts = 3;                // W = hi + mid + lo
constexpr int kBox = 64;                 // features per TMA box: one 128-byte swizzled row
constexpr int kXBox = kTile * kBox * 2;  // 32 KB: a box of the x tile [256][64]
constexpr int kStageBytes = kNC * kBox * 2;  // 16 KB: a W stage, one part's [128][64] box
constexpr int kStages = 4;
constexpr int kPerChunk = kParts * (kD / kBox);      // 12 stages a column chunk
constexpr int kPerTile = (kD / kNC) * kPerChunk;     // 24 stages a tile
static_assert(kWarps * 32 == kD, "a thread per key column in the block's loads");

// x tile (4 boxes, resident from the projection to the weighted sum), the
// W ring, the queries [QP][256] and the tile's scores (then weights)
// [QP][256] in f32, the bias [256], the softmax statistics, the barriers.
template <int QP>
struct Smem {
  static constexpr int kX = 0;
  static constexpr int kRing = kX + (kD / kBox) * kXBox;
  static constexpr int kQ = kRing + kStages * kStageBytes;
  static constexpr int kS = kQ + QP * kD * 4;
  static constexpr int kBias = kS + QP * kTile * 4;
  static constexpr int kStat = kBias + kD * 4;              // m [QP], l [QP], alpha [QP]
  static constexpr int kBars = (kStat + 3 * QP * 4 + 7) / 8 * 8;
  // x full, x empty, W full [kStages], W empty [kStages]; + 1024 to align
  static constexpr size_t bytes = (size_t)kBars + 8 * (2 + 2 * kStages) + 1024;
};

// W in three bf16 parts, each the rounding toward zero (the top 16 bits) of
// what the earlier parts leave: parts [3][D][D] = hi, mid, lo. Each
// remainder is exact in f32, so hi + mid + lo = w for every |w| >= 2^-110
// (a part below bf16's smallest subnormal, 2^-133, is lost below that), and
// a bf16 x times a part (8 by 8 significant bits) is exact in f32.
__global__ void __launch_bounds__(kD)
cross_split_w3_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ parts) {
  const size_t i = (size_t)blockIdx.x * kD + threadIdx.x;
  float r = w[i];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const uint32_t bits = __float_as_uint(r);
    parts[(size_t)p * kD * kD + i] = __ushort_as_bfloat16((unsigned short)(bits >> 16));
    r -= __uint_as_float(bits & 0xffff0000u);
  }
}

// tanh(x) = 1 - 2 / (e^2x + 1) with the SFU's exp and reciprocal: within
// 2e-7 of tanh absolutely (tanhf is within an ulp relatively, and takes
// about four times the instructions); the keys stay f32.
__device__ __forceinline__ float tanh_f32(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// With SDUMC_PHASE_STAMPS defined (bench/fusion_phases.py), thread 0 of the
// blocks (0, 0..3) stamps the globaltimer at the phases of its (last) tile:
// the block's start, x landed, each chunk's products and keys done, the
// softmax and the weighted sum done.
#ifdef SDUMC_PHASE_STAMPS
__device__ unsigned long long g_phase[4][8];
#define PHASE(k)                                                              \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y < 4)                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_phase[blockIdx.y][k])); \
  } while (0)
#else
#define PHASE(k) do {} while (0)
#endif

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

// Thread 0 issues W stage gs of the block's sequence into ring slot gs % 4:
// per tile, the two column chunks in turn, each as its lo, mid and hi
// parts, each part in four stages of 64 input features.
__device__ __forceinline__ void issue_w_stage(const CUtensorMap* w_map, uint32_t ring,
                                              uint32_t w_full0, int gs) {
  const int s = gs % kStages, i = gs % kPerTile;
  const int nc = i / kPerChunk, kb = i % (kD / kBox);
  const int p = kParts - 1 - (i % kPerChunk) / (kD / kBox);
  const uint32_t full = w_full0 + 8 * s;
  mbar_arrive_expect_tx(full, kStageBytes);
  tma_load_2d(ring + s * kStageBytes, w_map, full, kBox * kb, kD * p + kNC * nc);
}

template <int QP>
__global__ void __launch_bounds__(kWarps * 32, 1)
cross_partial_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const float* __restrict__ q, long long q_bstride,
                          const float* __restrict__ bias,
                          const int* __restrict__ tmax, int tmax_scalar,
                          int Q, int T, int nsplit, float scale,
                          float* __restrict__ m_part, float* __restrict__ l_part,
                          float* __restrict__ acc_part) {
  using S = Smem<QP>;
  constexpr int kXBytes = (kD / kBox) * kXBox;
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int tm = tmax ? tmax[b] : tmax_scalar;
  const bool uniform = tm <= 0;
  const int n_valid = uniform ? T : min(tm, T);
  const int ntiles = row_tiles(tm, T, kTile);
  const int per_split = (ntiles + nsplit - 1) / nsplit;
  const int tile_begin = split * per_split;
  if (tile_begin >= ntiles) return;    // past this row's t_max: no partial
  const int tile_end = min(ntiles, tile_begin + per_split);
  const int n_stages = uniform ? 0 : (tile_end - tile_begin) * kPerTile;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t x_full = base + S::kBars, x_empty = x_full + 8;
  const uint32_t w_full0 = x_full + 16, w_empty0 = w_full0 + 8 * kStages;
  const uint32_t ring = base + S::kRing;
  float* q_s = reinterpret_cast<float*>(smem + S::kQ);
  float* s_s = reinterpret_cast<float*>(smem + S::kS);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  float* m_s = reinterpret_cast<float*>(smem + S::kStat);
  float* l_s = m_s + QP;
  float* a_s = l_s + QP;

  PHASE(0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // Thread 0 also keeps the copies in flight: x's four boxes of a tile once
  // every warp is done with the last, and W's stage gs + 4 once every warp
  // is done with stage gs. (A producer warp of its own would make 9 warps,
  // 3 on one of the SM's four register files: ptxas then caps a thread at
  // 168 registers; 8 warps keep up to 255.)
  if (tid == 0) {
    mbar_init(x_full, 1);
    mbar_init(x_empty, kWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w_full0 + 8 * s, 1);
      mbar_init(w_empty0 + 8 * s, kWarps);
    }
    mbar_init_fence();
    mbar_arrive_expect_tx(x_full, kXBytes);
    for (int kb = 0; kb < kD / kBox; ++kb)
      tma_load_3d(base + S::kX + kb * kXBox, &x_map, x_full, kBox * kb, tile_begin * kTile, b);
    for (int gs = 0; gs < kStages && gs < n_stages; ++gs) issue_w_stage(&w_map, ring, w_full0, gs);
  }

  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;                  // warpgroup: frames 128 wg .. 128 wg + 127
  const int wr = 16 * (warp & 3) + g;        // this lane's row in each of its 64-frame tiles
  const float* qb = q + (size_t)b * q_bstride;
  for (int i = tid; i < QP * kD; i += kD) q_s[i] = i < Q * kD ? qb[i] : 0.f;
  bias_s[tid] = bias[tid];
  if (tid < QP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();                           // the barriers, queries and bias are in place
  float acc_out[QP][4];
#pragma unroll
  for (int j = 0; j < QP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_out[j][e] = 0.f;

  const uint32_t xs = base + S::kX;
  int gs = 0;
  for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
    const int rows = min(kTile, n_valid - tile * kTile);
    mbar_wait(x_full, it & 1);                 // the x tile landed
    PHASE(1);

    if (uniform) {
      for (int i = tid; i < QP * kTile; i += kD) s_s[i] = 0.f;
    } else {
      // sp[j][m][h]: query j's partial score of frame 128 wg + 64 m + wr + 8 h
      // over this lane's key columns
      float sp[QP][2][2];
#pragma unroll
      for (int j = 0; j < QP; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) sp[j][m][0] = sp[j][m][1] = 0.f;
      // acc[m][4j + e]: frames 128 wg + 64 m + wr (+ 8 for e >= 2), columns
      // 128 nc + 8j + 2t + e % 2
      float acc[2][64];
      auto keys_and_scores = [&](int nc) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = kNC * nc + 8 * n + 2 * t;
          const float2 bj = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            acc[m][4 * n + 0] = tanh_f32(acc[m][4 * n + 0] + bj.x);
            acc[m][4 * n + 1] = tanh_f32(acc[m][4 * n + 1] + bj.y);
            acc[m][4 * n + 2] = tanh_f32(acc[m][4 * n + 2] + bj.x);
            acc[m][4 * n + 3] = tanh_f32(acc[m][4 * n + 3] + bj.y);
          }
#pragma unroll
          for (int j = 0; j < QP; ++j) {
            const float2 qv = *reinterpret_cast<const float2*>(q_s + j * kD + col);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                sp[j][m][hh] = fmaf(qv.x, acc[m][4 * n + 2 * hh],
                                    fmaf(qv.y, acc[m][4 * n + 2 * hh + 1], sp[j][m][hh]));
          }
        }
      };
      auto release = [&](int g2) {
        const int s = g2 % kStages;
        if (lane == 0) mbar_arrive(w_empty0 + 8 * s);
        if (tid == 0 && g2 + kStages < n_stages) {   // refill the slot
          mbar_wait(w_empty0 + 8 * s, (g2 / kStages) & 1);
          issue_w_stage(&w_map, ring, w_full0, g2 + kStages);
        }
      };
      // The projection, a W stage at a time: x's 64-feature box kb times one
      // part's [128][64] box on the tensor cores, two m64n128k16 products a
      // k16 step, summed into acc over the chunk's 12 stages (lo, mid, hi in
      // turn, so the small terms sum first; the accumulation's truncation,
      // about 48 roundings of 2^-23 relative, lies far below the output's
      // bf16 rounding). Stage st - 1 is released once st is issued and
      // st - 1 has completed; the chunk's keys and scores follow it.
      for (int c = 0; c < kD / kNC; ++c) {
        for (int st = 0; st < kPerChunk; ++st) {
          const int g2 = gs + c * kPerChunk + st, s = g2 % kStages, kb = st % (kD / kBox);
          mbar_wait(w_full0 + 8 * s, (g2 / kStages) & 1);
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          wgmma_fence();
          const uint32_t ws = ring + s * kStageBytes;
          const uint32_t xb = xs + kb * kXBox + 128 * wg * 128;
#pragma unroll
          for (int ks = 0; ks < kBox / 16; ++ks) {
            const uint64_t db = desc_swizzled(ws + 32 * ks, 1, 1024);
            const int acc_in = st | ks;            // 0 starts the chunk
            wgmma_m64n128k16(acc[0], desc_swizzled(xb + 32 * ks, 1, 1024), db, acc_in);
            wgmma_m64n128k16(acc[1], desc_swizzled(xb + 64 * 128 + 32 * ks, 1, 1024), db, acc_in);
          }
          wgmma_commit();
          if (st > 0) {
            wgmma_wait<1>();
            __syncwarp();
            release(g2 - 1);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        __syncwarp();
        release(gs + c * kPerChunk + kPerChunk - 1);
        PHASE(2 + 2 * c);
        keys_and_scores(c);
        PHASE(3 + 2 * c);
      }
      gs += kPerTile;
      // summed across the quad: the scores of this lane's 4 frames
#pragma unroll
      for (int j = 0; j < QP; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v = sp[j][m][hh];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) s_s[j * kTile + 128 * wg + 64 * m + wr + 8 * hh] = scale * v;
          }
    }
    block_sync();

    // online softmax statistics; warp j owns query j, 8 frames a lane
    if (warp < QP) {
      float* sr = s_s + warp * kTile;
      float v[kTile / 32];
      float mt = -INFINITY;
#pragma unroll
      for (int e = 0; e < kTile / 32; ++e) {
        const int f = lane + 32 * e;
        v[e] = f < rows ? sr[f] : -INFINITY;
        mt = fmaxf(mt, v[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, mt);  // finite: rows >= 1
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < kTile / 32; ++e) {
        const int f = lane + 32 * e;
        const float p = f < rows ? expf(v[e] - m_new) : 0.f;
        sr[f] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[warp] = alpha;
        l_s[warp] = alpha * l_s[warp] + ps;
        m_s[warp] = m_new;
      }
    }
    block_sync();
    PHASE(6);

    // acc_out[q][e] = alpha[q] * acc_out[q][e] + sum_t p[q][t] * x[t][d + e],
    // d = 4 (tid % 64), over this thread's quarter of the frames (tid / 64),
    // from the resident x tile; four frames at a time (weights past `rows`
    // are zero). The quarters are added once, after the last tile.
#pragma unroll
    for (int j = 0; j < QP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_out[j][e] *= a_s[j];
    {
      const int c4 = tid & 63, quarter = tid >> 6;
      const uint8_t* xcol = smem + S::kX + (c4 >> 4) * kXBox;
      const uint32_t cb = (c4 & 15) * 8;
      const int r_end = min(rows, kTile / 4 * (quarter + 1));
      for (int r = kTile / 4 * quarter; r < r_end; r += 4) {
        float xv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 raw = *reinterpret_cast<const uint2*>(xcol + swizzle<128>((r + i) * 128 + cb));
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          xv[i][0] = lo.x;
          xv[i][1] = lo.y;
          xv[i][2] = hi.x;
          xv[i][3] = hi.y;
        }
#pragma unroll
        for (int j = 0; j < QP; ++j) {
          const float4 pw = *reinterpret_cast<const float4*>(s_s + j * kTile + r);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_out[j][e] = fmaf(pw.x, xv[0][e], fmaf(pw.y, xv[1][e], fmaf(pw.z, xv[2][e],
                                 fmaf(pw.w, xv[3][e], acc_out[j][e]))));
        }
      }
    }
    PHASE(7);
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty);     // this warp is done with the x tile
    if (tid == 0 && tile + 1 < tile_end) {   // the next tile's x, once every warp is
      mbar_wait(x_empty, it & 1);
      mbar_arrive_expect_tx(x_full, kXBytes);
      for (int kb = 0; kb < kD / kBox; ++kb)
        tma_load_3d(base + S::kX + kb * kXBox, &x_map, x_full, kBox * kb, (tile + 1) * kTile, b);
    }
  }

  // the other quarters' sums through the x tile's buffer, once every warp
  // is done with the last tile
  block_sync();
  const int c4 = tid & 63, quarter = tid >> 6;
  float4* quarter_s = reinterpret_cast<float4*>(smem + S::kX);   // [3][QP][64]
  if (quarter > 0) {
#pragma unroll
    for (int j = 0; j < QP; ++j)
      quarter_s[((quarter - 1) * QP + j) * 64 + c4] =
          make_float4(acc_out[j][0], acc_out[j][1], acc_out[j][2], acc_out[j][3]);
  }
  block_sync();
  const size_t pbase = ((size_t)b * nsplit + split) * QP;
  if (tid < QP) {
    m_part[pbase + tid] = m_s[tid];
    l_part[pbase + tid] = l_s[tid];
  }
  if (quarter == 0) {
#pragma unroll
    for (int j = 0; j < QP; ++j) {
      float4 v = make_float4(acc_out[j][0], acc_out[j][1], acc_out[j][2], acc_out[j][3]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 o = quarter_s[(k * QP + j) * 64 + c4];
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      *reinterpret_cast<float4*>(acc_part + (pbase + j) * kD + 4 * c4) = v;
    }
  }
}

template <int QP>
cudaError_t launch(const float* q, long long q_bstride, const __nv_bfloat16* x,
                   const float* w, const float* bias, const int* tmax, int tmax_scalar,
                   __nv_bfloat16* out, float* m_part, float* l_part, float* acc_part,
                   __nv_bfloat16* w_parts, int B, int Q, int T, int nsplit, float scale,
                   cudaStream_t stream) {
  // x [B, T, 256] in boxes of 64 features x 256 frames of one row (frames
  // past T read as zeros); the parts [3 * 256, 256] in boxes of 64 x 64
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[3] = {kD, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {kD * 2, (cuuint64_t)T * kD * 2};
  const cuuint32_t x_box[3] = {kBox, kTile, 1};
  const cuuint64_t w_dims[2] = {kD, kParts * kD};
  const cuuint64_t w_strides[1] = {kD * 2};
  const cuuint32_t w_box[2] = {kBox, kNC};
  if (!bf16_tile_map(&x_map, x, 3, x_dims, x_strides, x_box) ||
      !bf16_tile_map(&w_map, w_parts, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  const size_t smem = Smem<QP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_partial_bf16_kernel<QP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cross_split_w3_kernel<<<kD, kD, 0, stream>>>(w, w_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_partial_bf16_kernel<QP><<<dim3(nsplit, B), kWarps * 32, smem, stream>>>(
      x_map, w_map, q, q_bstride, bias, tmax, tmax_scalar, Q, T, nsplit, scale, m_part, l_part,
      acc_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_combine_kernel<QP, __nv_bfloat16, kTile><<<dim3(B, Q), kD, 0, stream>>>(
      m_part, l_part, acc_part, tmax, tmax_scalar, out, Q, T, nsplit);
  return cudaGetLastError();
}

}  // namespace b16

bool bad_shape(int B, int Q, int T, int D, int nsplit) {
  return B < 1 || T < 1 || Q < 1 || Q > 8 || D != kD || nsplit < 1 || B > 65535;
}

}  // namespace

extern "C" {

// Launches the kernel trio on `stream` (W's split, the per-tile partials,
// their merge); returns the cudaError_t of the launches (0 on success). q
// rows are [Q, D] at q + b * q_bstride (stride 0 broadcasts one query set);
// x [B, T, D], w [D, D], bias [D], out [B, Q, D] are contiguous f32 with D =
// 256; tmax is an int32 [B] array, or NULL to use tmax_scalar for every row.
// m_part/l_part hold B*nsplit*QP floats and acc_part B*nsplit*QP*D, with QP
// = 1 for Q = 1 and 8 otherwise; w_split holds 2*D*D floats (W's hi and lo
// parts, written here).
int sdumc_fused_cross(const float* q, long long q_bstride, const float* x,
                      const float* w, const float* bias, const int* tmax,
                      int tmax_scalar, float* out, float* m_part,
                      float* l_part, float* acc_part, float* w_split, int B, int Q,
                      int T, int D, int nsplit, float scale, void* stream) {
  if (bad_shape(B, Q, T, D, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 1)
    return (int)launch<1>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out, m_part, l_part,
                          acc_part, w_split, B, Q, T, nsplit, scale, s);
  return (int)launch<8>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out, m_part, l_part,
                        acc_part, w_split, B, Q, T, nsplit, scale, s);
}

// The bf16 instance: x and out are bf16 ([B, T, D] and [B, Q, D]), and
// w_split holds 3*D*D bf16 (W's hi, mid and lo parts, written here); the
// partials are per 256-frame tile; every other argument as above.
int sdumc_fused_cross_bf16(const float* q, long long q_bstride, const void* x,
                           const float* w, const float* bias, const int* tmax,
                           int tmax_scalar, void* out, float* m_part,
                           float* l_part, float* acc_part, void* w_split, int B, int Q,
                           int T, int D, int nsplit, float scale, void* stream) {
  if (bad_shape(B, Q, T, D, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* wp = static_cast<__nv_bfloat16*>(w_split);
  if (Q == 1)
    return (int)b16::launch<1>(q, q_bstride, xb, w, bias, tmax, tmax_scalar, ob, m_part, l_part,
                               acc_part, wp, B, Q, T, nsplit, scale, s);
  return (int)b16::launch<8>(q, q_bstride, xb, w, bias, tmax, tmax_scalar, ob, m_part, l_part,
                             acc_part, wp, B, Q, T, nsplit, scale, s);
}

#ifdef SDUMC_PHASE_STAMPS
// The stamps of the last call, [4][8] globaltimer ns, into `host`.
int sdumc_fused_cross_phases(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, b16::g_phase, sizeof(b16::g_phase));
}
#endif

const char* sdumc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
