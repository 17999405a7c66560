// Bifurcated flash-decode kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (kernels/_build.py builds this file with nvcc,
// kernels/bifurcated_decode.py binds and launches it).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bifurcated_decode.py:
//   * fused_bifurcated_decode  (_fused_kernel): every query row
//     r = (b_idx*p + p_idx)*n + n_idx of one kv head streams the shared
//     context K_c/V_c, then folds in its own sample's decode slots, and the
//     normalised output is written once;
//   * context_flash_partials   (_ctx_flash_kernel): the context arm alone,
//     writing the unnormalised fp32 (acc, m, l) partials.
// Both share one online-softmax update (the counterpart of _online_update):
// fp32 running (max, sumexp, acc), corrected by exp(m_prev - m_new); the
// softmax weights are cast to the value dtype before the value product.
// The bf16 kernels are instances of the template in decode_common.cuh,
// which the int8 and multi-prefix kernels (forest_q8_decode.cu) share.
//
// What bounds them on an H100: bytes. A decode step has b*p*n query rows
// per kv head (64 at the main path), so each K_c/V_c element is used by
// only that many rows: about 64 operations per byte read, far below the
// ~295 operations per byte at which the tensor cores, not HBM, become the
// limit. The context must be read at least once per launch:
// 2 * g * m_c * hd * 2 bytes (33.5 MB at g=8, m_c=8192, hd=128).
//
// What the design does about it: one CTA per (kv head, tile of 64 query
// rows) reads each K_c/V_c block from device memory ONCE for all its rows,
// which is all rows of the kv head at the main path, so the context is
// read once per launch, not once per sample (the paper's point). Blocks of
// 64 keys are staged through shared memory with cp.async, double-buffered,
// and both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate); the running state stays in registers and only the
// output reaches device memory. The decode arm of a row tile covers only
// the decode slots of the samples in that tile, not all b samples.
// Known limit: g CTAs per row tile (8 at the main path) leave most of the
// 132 SMs idle; splitting the context across CTAs is left for later.
//
// fp32 inputs take a plain SIMT kernel of the same structure (CUDA cores,
// fp32 throughout); it is for checks, not for serving.

#include "decode_common.cuh"

namespace {

using bifurcated::kMinL;
using bifurcated::kNegInf;
using bifurcated::kThreads;
using bifurcated::kWarps;
using bifurcated::Params;

// ---------------------------------------------------------------------------
// fp32 SIMT kernel (checks only): same arms, same update, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;   // query rows per CTA
constexpr int kF32Block = 32;  // keys per staged block

template <int HD, bool DECODE>
__device__ __forceinline__ void stream_arm_f32(float (&acc)[HD / 8], float* sQ, float* sK,
                               float* sV, float* sP, float* sM, float* sL,
                               float* sC, const float* k, const float* v,
                               int col_begin, int col_end, int limit,
                               float scale, const float* bias, int c_d, int pn,
                               int row0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int col0 = col_begin; col0 < col_end; col0 += kF32Block) {
    for (int i = tid; i < kF32Block * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool valid = col0 + r < limit;
      const size_t off = static_cast<size_t>(col0 + r) * HD + d;
      sK[r * (HD + 1) + d] = valid ? k[off] : 0.f;
      sV[r * HD + d] = valid ? v[off] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kF32Rows * kF32Block; e += kThreads) {
      const int r = e / kF32Block, j = e % kF32Block;
      const int row = row0 + r, col = col0 + j;
      float x = 0.f;
      for (int d = 0; d < HD; ++d) x += sQ[r * HD + d] * sK[j * (HD + 1) + d];
      x *= scale;
      bool valid = col < col_end;
      if (DECODE && valid) {
        x += bias[col];
        valid = (row / pn) == (col / c_d);
      }
      sP[r * kF32Block + j] = valid ? x : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < kF32Rows; r += kWarps) {
      const float x = sP[r * kF32Block + lane];
      float mx = x;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(sM[r], mx);
      const float p = expf(x - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sP[r * kF32Block + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(sM[r] - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    const int r = tid / 8, d0 = tid % 8;
    const float corr = sC[r];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int d = d0 + 8 * i;
      float pv = 0.f;
      for (int j = 0; j < kF32Block; ++j)
        pv += sP[r * kF32Block + j] * sV[j * HD + d];
      acc[i] = acc[i] * corr + pv;
    }
    __syncthreads();
  }
}

template <int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    f32_decode_kernel(const float* __restrict__ q,
                      const float* __restrict__ k_ctx,
                      const float* __restrict__ v_ctx,
                      const float* __restrict__ k_dec,
                      const float* __restrict__ v_dec,
                      const float* __restrict__ dec_bias,
                      float* __restrict__ out, float* __restrict__ acc_out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int rows, int m_c, int ld, int c_d, int pn,
                      float scale) {
  static_assert(kF32Rows * 8 == kThreads, "one thread per (row, dim group)");
  __shared__ float sQ[kF32Rows * HD];
  __shared__ float sK[kF32Block * (HD + 1)];
  __shared__ float sV[kF32Block * HD];
  __shared__ float sP[kF32Rows * kF32Block];
  __shared__ float sM[kF32Rows], sL[kF32Rows], sC[kF32Rows];
  const int gi = blockIdx.y;
  const int row0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  for (int i = tid; i < kF32Rows * HD; i += kThreads) {
    const int row = row0 + i / HD;
    sQ[i] = row < rows
                ? q[(static_cast<size_t>(gi) * rows + row) * HD + i % HD]
                : 0.f;
  }
  if (tid < kF32Rows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t ctx_off = static_cast<size_t>(gi) * m_c * HD;
  stream_arm_f32<HD, false>(acc, sQ, sK, sV, sP, sM, sL, sC, k_ctx + ctx_off,
                            v_ctx + ctx_off, 0, m_c, m_c, scale, nullptr, 1, 1,
                            row0);
  if (FUSED) {
    const int last_row = min(row0 + kF32Rows, rows) - 1;
    const int col_begin = (row0 / pn) * c_d;
    const int col_end = min(ld, (last_row / pn + 1) * c_d);
    const size_t dec_off = static_cast<size_t>(gi) * ld * HD;
    stream_arm_f32<HD, true>(acc, sQ, sK, sV, sP, sM, sL, sC, k_dec + dec_off,
                             v_dec + dec_off, col_begin, col_end, ld, scale,
                             dec_bias, c_d, pn, row0);
  }

  const int r = tid / 8, d0 = tid % 8;
  const int row = row0 + r;
  if (row >= rows) return;
  const size_t base = (static_cast<size_t>(gi) * rows + row) * HD;
  if (FUSED) {
    const float inv = 1.f / fmaxf(sL[r], kMinL);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) out[base + d0 + 8 * i] = acc[i] * inv;
  } else {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc_out[base + d0 + 8 * i] = acc[i];
    if (d0 == 0) {
      m_out[static_cast<size_t>(gi) * rows + row] = sM[r];
      l_out[static_cast<size_t>(gi) * rows + row] = sL[r];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, bool FUSED>
cudaError_t launch_f32(const Params& a, cudaStream_t stream) {
  dim3 grid((a.rows + kF32Rows - 1) / kF32Rows, a.g);
  f32_decode_kernel<HD, FUSED><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_ctx),
      static_cast<const float*>(a.v_ctx), static_cast<const float*>(a.k_dec),
      static_cast<const float*>(a.v_dec), a.dec_bias,
      static_cast<float*>(a.out), a.acc, a.m, a.l, a.rows, a.m_c, a.ld,
      a.c_d, a.pn, a.scale);
  return cudaGetLastError();
}

// dtype: 0 = float32 (SIMT copy), 1 = bfloat16 (tensor cores).
template <bool FUSED>
cudaError_t dispatch(const Params& a, int hd, int dtype, cudaStream_t s) {
  if (dtype == 1) return bifurcated::dispatch_hd<FUSED, false, false>(a, hd, s);
  if (dtype != 0 || a.g <= 0 || a.rows <= 0 || a.m_c <= 0 || a.pn <= 0 ||
      a.c_d <= 0)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_f32<16, FUSED>(a, s);
    case 64: return launch_f32<64, FUSED>(a, s);
    case 80: return launch_f32<80, FUSED>(a, s);
    case 128: return launch_f32<128, FUSED>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (g, rows, hd), k_ctx/v_ctx (g, m_c, hd), k_dec/v_dec (g, ld, hd) in the
// q dtype; dec_bias (ld,) f32; out (g, rows, hd) in the q dtype.
// Returns the CUDA error of the launch (0 when it was accepted).
int fused_bifurcated_decode(const void* q, const void* k_ctx,
                            const void* v_ctx, const void* k_dec,
                            const void* v_dec, const void* dec_bias, void* out,
                            int g, int rows, int m_c, int ld, int hd, int c_d,
                            int pn, float scale, int dtype, void* stream) {
  Params a{q, k_ctx, v_ctx, nullptr, nullptr, nullptr, nullptr, k_dec, v_dec,
           static_cast<const float*>(dec_bias), out, nullptr, nullptr,
           nullptr, 1, g, rows, m_c, ld, c_d, pn, scale};
  return static_cast<int>(
      dispatch<true>(a, hd, dtype, static_cast<cudaStream_t>(stream)));
}

// q (g, rows, hd), k_ctx/v_ctx (g, m_c, hd) in the q dtype; acc (g, rows, hd),
// m and l (g, rows), all f32.
int context_flash_partials(const void* q, const void* k_ctx, const void* v_ctx,
                           void* acc, void* m, void* l, int g, int rows,
                           int m_c, int hd, float scale, int dtype,
                           void* stream) {
  Params a{q, k_ctx, v_ctx, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, static_cast<float*>(acc),
           static_cast<float*>(m), static_cast<float*>(l), 1, g, rows, m_c,
           1, 1, 1, scale};
  return static_cast<int>(
      dispatch<false>(a, hd, dtype, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
