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
// What bounds it on an H100: the key projection, 2*D*D flops per valid frame
// in true f32 (no TF32: the fusion net's checkpoint-parity path), against
// 4*D bytes of x read once: at D = 256 that is 128 flop per byte, far above
// the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). So it is bound
// by f32 FMA throughput on the CUDA cores. The design:
//  * k never reaches device memory. A 64-frame tile of x sits in shared
//    memory; W (256 KB, more than a block's shared memory) streams through in
//    64-row chunks, and each chunk's [64, 64] block of k is folded into the
//    partial scores before the chunk's buffer is reused.
//  * The W chunks are double-buffered with cp.async: the next chunk (or the
//    next tile's first one) is in flight while the current one feeds the
//    FMAs, so the L2 latency is hidden behind the projection.
//  * The projection uses a 4x4 register tile per thread with float4 shared
//    loads (rows padded by 4 floats so the two rows a warp reads sit in
//    different banks). D is a compile-time 256 (the fusion net's width), so
//    every loop unrolls and all of a tile's loads are issued at once.
//  * Per-row t_max: tiles past it are never loaded; the last partial tile
//    masks its rows before the running max, so no tile yields NaN.
//  * Q = 1 and Q = 7 are below any MMA tile, so the scores and the weighted
//    sum are plain FMA loops; Q = 7 is padded to 8 with zero queries.
//  * One block per row gives only B blocks on 132 SMs, so time is split over
//    `nsplit` blocks per row; a second small kernel merges the per-split
//    (max, sum, accumulator) triples, as flash-decoding does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps; the 4x4 tiles cover 64 x 64
constexpr int kD = 256;        // feature width; one accumulator column per thread
constexpr int kBT = 64;        // frames per time tile
constexpr int kJC = 64;        // rows of W per streamed chunk
constexpr int kChunks = kD / kJC;
constexpr int kXS = kD + 4;    // padded row stride of the x and W tiles
constexpr int kKS = kJC + 1;   // row stride of the k block (odd: no conflicts)
constexpr int kD4 = kD / 4;

template <int QP>
constexpr size_t smem_floats() {
  return (size_t)kBT * kXS + 2 * kJC * kXS + kBT * kKS + QP * kD + QP * kBT + 3 * QP;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
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

// One 64-row chunk of W into a shared buffer: 16 float4 per thread.
__device__ __forceinline__ void load_w_chunk(float* w_buf, const float* w, int j0,
                                             int tid) {
#pragma unroll
  for (int k = 0; k < kJC * kD4 / kThreads; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / kD4, c = i % kD4;
    cp_async16(w_buf + r * kXS + 4 * c, w + (size_t)(j0 + r) * kD + 4 * c);
  }
}

template <int QP>
__global__ void __launch_bounds__(kThreads, 1)
cross_partial_kernel(const float* __restrict__ q, long long q_bstride,
                     const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const int* __restrict__ tmax, int tmax_scalar,
                     int Q, int T, int nsplit, float scale,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part) {
  static_assert(kBT == 64, "the softmax pass gives each lane two frames");
  static_assert(QP <= kThreads / 32, "one warp per query");
  static_assert(kD == kThreads, "one accumulator column per thread");
  // score pairs (q, t), pair = q * kBT + t: thread tid owns tid + p * kThreads
  constexpr int kPairs = (QP * kBT + kThreads - 1) / kThreads;
  constexpr int kQStep = kThreads / kBT;

  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                     // [kBT][kXS]      time tile of x
  float* w_s = x_s + kBT * kXS;          // 2 x [kJC][kXS]  chunks of W rows
  float* k_s = w_s + 2 * kJC * kXS;      // [kBT][kKS]      tanh(x W^T + b)
  float* q_s = k_s + kBT * kKS;          // [QP][kD]        queries, zero-padded
  float* s_s = q_s + QP * kD;            // [QP][kBT]       scores, then weights
  float* m_s = s_s + QP * kBT;           // [QP] running max
  float* l_s = m_s + QP;                 // [QP] running sum
  float* a_s = l_s + QP;                 // [QP] rescale of this tile

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int tm = tmax ? tmax[b] : tmax_scalar;
  const bool uniform = tm <= 0;
  const int n_valid = uniform ? T : min(tm, T);
  const int ntiles = (n_valid + kBT - 1) / kBT;
  const int per_split = (ntiles + nsplit - 1) / nsplit;
  const int tile_begin = split * per_split;
  const int tile_end = min(ntiles, tile_begin + per_split);

  const float* xb = x + (size_t)b * T * kD;
  const float* qb = q + (size_t)b * q_bstride;
  for (int i = tid; i < QP * kD; i += kThreads) q_s[i] = i < Q * kD ? qb[i] : 0.f;
  if (tid < QP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[QP];
#pragma unroll
  for (int j = 0; j < QP; ++j) acc[j] = 0.f;

  const int tx = tid & 15;   // k columns tx + 16c
  const int ty = tid >> 4;   // k rows ty + 16r
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t_own = tid % kBT;   // frame of this thread's score pairs
  const int q_own = tid / kBT;   // first query of this thread's score pairs

  if (!uniform && tile_begin < tile_end) {
    load_w_chunk(w_s, w, 0, tid);
    cp_async_commit();
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int t0 = tile * kBT;
    const int rows = min(kBT, n_valid - t0);
    __syncthreads();  // the previous tile's readers of x_s and s_s are done
#pragma unroll
    for (int k = 0; k < kBT * kD4 / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / kD4, c = i % kD4;
      float* dst = x_s + r * kXS + 4 * c;
      if (r < rows)
        cp_async16(dst, xb + (size_t)(t0 + r) * kD + 4 * c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();

    float sc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) sc[p] = 0.f;

    if (uniform) {
      cp_async_wait<0>();
    } else {
#pragma unroll 1
      for (int chunk = 0; chunk < kChunks; ++chunk) {
        // prefetch the next chunk (or the next tile's first) into the other
        // buffer; its last reader finished before the previous barrier
        const bool more = chunk + 1 < kChunks || tile + 1 < tile_end;
        if (more) {
          const int next = (chunk + 1) % kChunks;
          load_w_chunk(w_s + ((chunk + 1) & 1) * kJC * kXS, w, next * kJC, tid);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // this chunk (and the x tile) landed for everyone

        const float* wb = w_s + (chunk & 1) * kJC * kXS;
        float kacc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) kacc[r][c] = 0.f;
#pragma unroll 4
        for (int i = 0; i < kD; i += 4) {
          float4 xv[4], wv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            xv[r] = *reinterpret_cast<const float4*>(x_s + (ty + 16 * r) * kXS + i);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wv[c] = *reinterpret_cast<const float4*>(wb + (tx + 16 * c) * kXS + i);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float a = kacc[r][c];
              a = fmaf(xv[r].x, wv[c].x, a);
              a = fmaf(xv[r].y, wv[c].y, a);
              a = fmaf(xv[r].z, wv[c].z, a);
              a = fmaf(xv[r].w, wv[c].w, a);
              kacc[r][c] = a;
            }
        }
        const int j0 = chunk * kJC;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bj = bias[j0 + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            k_s[(ty + 16 * r) * kKS + tx + 16 * c] = tanhf(kacc[r][c] + bj);
        }
        __syncthreads();

        // partial scores over this chunk's columns for the pairs
        // (q_own + p * kQStep, t_own), which share their frame and its k row
        const float* kr = k_s + t_own * kKS;
#pragma unroll 16
        for (int j = 0; j < kJC; ++j) {
          const float kv = kr[j];
#pragma unroll
          for (int p = 0; p < kPairs; ++p)
            if (q_own + p * kQStep < QP)
              sc[p] = fmaf(q_s[(q_own + p * kQStep) * kD + j0 + j], kv, sc[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int pair = tid + p * kThreads;
      if (pair < QP * kBT) s_s[pair] = scale * sc[p];
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
    __syncthreads();

    // acc[q][d] = alpha[q] * acc[q][d] + sum_t p[q][t] * x[t][d], d = tid;
    // four frames at a time: weights and x rows past `rows` are zero
#pragma unroll
    for (int j = 0; j < QP; ++j) acc[j] *= a_s[j];
    for (int t = 0; t < rows; t += 4) {
      const float x0 = x_s[t * kXS + tid], x1 = x_s[(t + 1) * kXS + tid];
      const float x2 = x_s[(t + 2) * kXS + tid], x3 = x_s[(t + 3) * kXS + tid];
#pragma unroll
      for (int j = 0; j < QP; ++j) {
        const float4 pw = *reinterpret_cast<const float4*>(s_s + j * kBT + t);
        acc[j] = fmaf(pw.x, x0, fmaf(pw.y, x1, fmaf(pw.z, x2, fmaf(pw.w, x3, acc[j]))));
      }
    }
  }

  __syncthreads();  // the statistics are final (and initialised, if no tile)
  const size_t base = ((size_t)b * nsplit + split) * QP;
  if (tid < QP) {
    m_part[base + tid] = m_s[tid];
    l_part[base + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < QP; ++j) acc_part[(base + j) * kD + tid] = acc[j];
}

// out[b, q, d] = sum_s e^(m_s - M) acc_s[d] / sum_s e^(m_s - M) l_s.
// Split 0 always holds a tile, so M is finite; empty splits carry
// m = -inf and weigh zero.
template <int QP>
__global__ void __launch_bounds__(kThreads)
cross_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     float* __restrict__ out, int Q, int nsplit) {
  const int b = blockIdx.x;
  const int d = threadIdx.x;
  const size_t base = (size_t)b * nsplit * QP;
  for (int j = 0; j < Q; ++j) {
    float m = -INFINITY;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, m_part[base + s * QP + j]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t row = base + s * QP + j;
      const float e = expf(m_part[row] - m);
      l = fmaf(e, l_part[row], l);
      a = fmaf(e, acc_part[row * kD + d], a);
    }
    out[((size_t)b * Q + j) * kD + d] = a / l;
  }
}

template <int QP>
cudaError_t launch(const float* q, long long q_bstride, const float* x,
                   const float* w, const float* bias, const int* tmax,
                   int tmax_scalar, float* out, float* m_part, float* l_part,
                   float* acc_part, int B, int Q, int T, int nsplit,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<QP>();
  cudaError_t err = cudaFuncSetAttribute(
      cross_partial_kernel<QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cross_partial_kernel<QP><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      q, q_bstride, x, w, bias, tmax, tmax_scalar, Q, T, nsplit, scale,
      m_part, l_part, acc_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_combine_kernel<QP><<<B, kThreads, 0, stream>>>(
      m_part, l_part, acc_part, out, Q, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel pair on `stream`; returns the cudaError_t of the
// launches (0 on success). q rows are [Q, D] at q + b * q_bstride (stride 0
// broadcasts one query set); x [B, T, D], w [D, D], bias [D], out [B, Q, D]
// are contiguous f32 with D = 256; tmax is an int32 [B] array, or NULL to
// use tmax_scalar for every row. m_part/l_part hold B*nsplit*QP floats and
// acc_part B*nsplit*QP*D, with QP = 1 for Q = 1 and 8 otherwise.
int sdumc_fused_cross(const float* q, long long q_bstride, const float* x,
                      const float* w, const float* bias, const int* tmax,
                      int tmax_scalar, float* out, float* m_part,
                      float* l_part, float* acc_part, int B, int Q, int T,
                      int D, int nsplit, float scale, void* stream) {
  if (B < 1 || T < 1 || Q < 1 || Q > 8 || D != kD || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 1)
    return (int)launch<1>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out,
                          m_part, l_part, acc_part, B, Q, T, nsplit, scale, s);
  return (int)launch<8>(q, q_bstride, x, w, bias, tmax, tmax_scalar, out,
                        m_part, l_part, acc_part, B, Q, T, nsplit, scale, s);
}

const char* sdumc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
