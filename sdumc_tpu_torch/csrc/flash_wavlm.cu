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
// What bounds it on an H100: 4 * B * H * T^2 * hd flops of QK^T and PV in
// true f32 (the extraction path is checkpoint-exact, so no TF32), against
// about 4 * B * T * H * hd * 4 bytes of q, k, v and out: at T = 2999 that is
// 36.8 GFLOP (0.55 ms at 67 TFLOP/s) against 49 MB (0.015 ms at 3.35 TB/s),
// so it is bound by f32 FMA throughput on the CUDA cores. The design:
//  * One block of 256 threads per (b, h, 64-query tile); a loop over 64-key
//    tiles keeps the [T, T] scores out of device memory (online max, rescale
//    and sum, as flash attention does). At B = 1, T = 2999, H = 16 that is
//    752 blocks for 132 SMs.
//  * Scores and P.V are 4 x 4 register tiles per thread, fed by float4 shared
//    loads from rows padded by 4 floats (conflict-free across a quarter warp).
//  * The next key tile is fetched with cp.async while the softmax and P.V of
//    the current one run, and the next value tile while the next scores run.
//  * The ragged edge is masked in the kernel: key rows past T are zero-filled
//    and weigh exactly zero, query rows past T are not stored; nothing is
//    padded on the host. A masked key adds NEG, so a row whose first tiles
//    are all masked carries m = -1e30 until a valid key arrives, and the
//    rescale exp(m_old - m_new) then wipes what it summed. A row with no
//    valid key averages v over all T keys, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 tile of 64 x 64
constexpr int kTile = 64;       // query and key rows per tile
constexpr int kPS = kTile + 16; // row stride of P: two rows a warp writes are 16 banks apart
constexpr float kNeg = -1e30f;

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)3 * kTile * (HD + 4) + kTile * kPS + 2 * kTile + kTile;
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

// Rows t0 .. t0 + 63 of one head into a [64][HD + 4] shared tile; rows at or
// past T are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int t0, int T,
                                          size_t row_stride, int tid) {
  constexpr int kC = HD / 4;
#pragma unroll
  for (int i = tid; i < kTile * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    float* d = dst + r * (HD + 4) + 4 * c;
    if (t0 + r < T)
      cp_async16(d, src + (size_t)(t0 + r) * row_stride + 4 * c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_wavlm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ gate,
                   const float* __restrict__ bias_diag,
                   const float* __restrict__ kvalid, float* __restrict__ out,
                   int T, int H, float scale) {
  static_assert(HD == 16 || HD == 64, "16 threads share a row of out");
  constexpr int kS = HD + 4;       // row stride of the q, k and v tiles
  constexpr int kCPT = HD / 16;    // columns of out per thread

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [64][kS]
  float* k_s = q_s + kTile * kS;   // [64][kS]
  float* v_s = k_s + kTile * kS;   // [64][kS]
  float* p_s = v_s + kTile * kS;   // [64][kPS]  probabilities of this tile pair
  float* w_s = p_s + kTile * kPS;  // [128]      bias window, offset col - row + 63
  float* n_s = w_s + 2 * kTile;    // [64]       key mask term, 0 or NEG

  const int tid = threadIdx.x;
  const int tx = tid & 15;         // score columns tx + 16c, out columns kCPT tx + cc
  const int ty = tid >> 4;         // rows ty + 16r
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t head = ((size_t)b * T * H + h) * HD;
  const float* diag = bias_diag + (size_t)h * (2 * T - 1);
  const float* kv = kvalid ? kvalid + (size_t)b * T : nullptr;

  float g[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty + 16 * r;
    g[r] = t < T ? gate[((size_t)b * H + h) * T + t] : 0.f;
  }

  load_tile<HD>(q_s, q + head, q0, T, row_stride, tid);
  load_tile<HD>(k_s, k + head, 0, T, row_stride, tid);
  cp_async_commit();
  load_tile<HD>(v_s, v + head, 0, T, row_stride, tid);
  cp_async_commit();

  float m[4], l[4], o[4][kCPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) o[r][c] = 0.f;
  }

  const int nk = (T + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    const bool more = kt + 1 < nk;

    // this pair's key mask and bias window; their last readers finished
    // before the previous tile's barriers
    if (tid < kTile) {
      const int u = k0 + tid;
      n_s[tid] = (u < T && kv && !(kv[u] > 0.f)) ? kNeg : 0.f;
    } else if (tid < 3 * kTile) {
      const int i = tid - kTile;                  // 0 .. 127
      const long long d = (long long)k0 - q0 + T - 1 - (kTile - 1) + i;
      w_s[i] = (i < 2 * kTile - 1 && d >= 0 && d <= 2LL * T - 2) ? diag[d] : 0.f;
    }
    cp_async_wait<1>();          // q and this key tile landed; v may be in flight
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int i = 0; i < HD; i += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * r) * kS + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv4[c] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * c) * kS + i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[r][c];
          a = fmaf(qv[r].x, kv4[c].x, a);
          a = fmaf(qv[r].y, kv4[c].y, a);
          a = fmaf(qv[r].z, kv4[c].z, a);
          a = fmaf(qv[r].w, kv4[c].w, a);
          s[r][c] = a;
        }
    }

    // scale, gated bias, key mask; online softmax per row across 16 lanes
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float val = s[r][c] * scale + g[r] * w_s[col - row + kTile - 1] + n_s[col];
        s[r][c] = val;
        if (k0 + col < T) mt = fmaxf(mt, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);   // finite: key k0 < T is in every tile
      alpha[r] = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (k0 + tx + 16 * c < T) ? expf(s[r][c] - m_new) : 0.f;
        s[r][c] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha[r] + ps;
      m[r] = m_new;
    }
    __syncthreads();             // every reader of k_s, w_s and n_s is done

    if (more) {
      load_tile<HD>(k_s, k + head, k0 + kTile, T, row_stride, tid);
      cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) p_s[(ty + 16 * r) * kPS + tx + 16 * c] = s[r][c];
    if (more)
      cp_async_wait<1>();        // this value tile landed; the next key tile may not
    else
      cp_async_wait<0>();
    __syncthreads();

    // o = alpha * o + P . V over this tile's 64 keys
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCPT; ++c) o[r][c] *= alpha[r];
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * r) * kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vr[kCPT];
        const float* vrow = v_s + (j + jj) * kS + kCPT * tx;
        if constexpr (kCPT == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow);
          vr[0] = t4.x; vr[1] = t4.y; vr[2] = t4.z; vr[3] = t4.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCPT; ++c) vr[c] = vrow[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pw = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < kCPT; ++c) o[r][c] = fmaf(pw, vr[c], o[r][c]);
        }
      }
    }
    __syncthreads();             // every reader of v_s and p_s is done

    if (more) {
      load_tile<HD>(v_s, v + head, k0 + kTile, T, row_stride, tid);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty + 16 * r;
    if (t >= T) continue;
    float* dst = out + head + (size_t)t * row_stride + kCPT * tx;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) dst[c] = o[r][c] / l[r];
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* gate,
                   const float* bias_diag, const float* kvalid, float* out,
                   int B, int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wavlm_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_wavlm_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, gate, bias_diag, kvalid, out, T, H, scale);
  return cudaGetLastError();
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
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, gate, bias_diag, kvalid, out, B, T, H, scale, s);
    case 64: return (int)launch<64>(q, k, v, gate, bias_diag, kvalid, out, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sdumc_flash_wavlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
