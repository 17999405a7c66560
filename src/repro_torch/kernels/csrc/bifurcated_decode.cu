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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTile = kWarps * 16;   // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;             // keys per staged block
constexpr int kPad = 8;                 // bf16 padding per smem row (16 B)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p,
                                              bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// Stage kBlockN rows [col0, col0 + kBlockN) of K and V (row length HD,
// rows at or past `limit` zero-filled) into shared memory.
template <int HD>
__device__ __forceinline__ void stage_block(__nv_bfloat16* sK,
                                            __nv_bfloat16* sV,
                                            const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, int col0,
                                            int limit) {
  constexpr int SROW = HD + kPad;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockN * CHUNKS; c += kThreads) {
    int r = c / CHUNKS, ch = c % CHUNKS;
    int col = col0 + r;
    bool valid = col < limit;
    size_t off = valid ? static_cast<size_t>(col) * HD + ch * 8 : 0;
    cp_async16(sK + r * SROW + ch * 8, k + off, valid);
    cp_async16(sV + r * SROW + ch * 8, v + off, valid);
  }
}

// Per-thread share of one warp's 16-row slab: rows gr and gr + 8.
template <int HD>
struct WarpState {
  uint32_t q[HD / 16][4];   // A fragments of the warp's 16 query rows
  float o[HD / 8][4];       // fp32 accumulator, C-fragment layout
  float m[2], l[2];         // running max / sumexp of rows gr, gr + 8
};

// Stream keys [col_begin, col_end) of one arm through the online softmax.
// DECODE: the decode arm — logits get the slot bias, and a row attends only
// its own sample's slots (row / pn == col / c_d). Memory rows at or past
// `limit` are never read.
template <int HD, bool DECODE>
__device__ __forceinline__ void stream_arm(WarpState<HD>& st, __nv_bfloat16* smem,
                           const __nv_bfloat16* k, const __nv_bfloat16* v,
                           int col_begin, int col_end, int limit, float scale,
                           const float* bias, int c_d, int pn, int wrow0) {
  constexpr int SROW = HD + kPad;
  constexpr int STAGE = kBlockN * SROW;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nblk = (col_end - col_begin + kBlockN - 1) / kBlockN;
  if (nblk <= 0) return;
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = smem + 2 * STAGE;

  // decode arm: the warp's rows read only their samples' slot range
  int wcol_lo = 0, wcol_hi = col_end;
  if (DECODE) {
    wcol_lo = (wrow0 / pn) * c_d;
    wcol_hi = ((wrow0 + 15) / pn + 1) * c_d;
  }

  stage_block<HD>(sK, sV, k, v, col_begin, limit);
  cp_async_commit();
  for (int blk = 0; blk < nblk; ++blk) {
    const int cur = blk & 1;
    const int col0 = col_begin + blk * kBlockN;
    if (blk + 1 < nblk)
      stage_block<HD>(sK + (cur ^ 1) * STAGE, sV + (cur ^ 1) * STAGE, k, v,
                      col0 + kBlockN, limit);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest is done: block blk
    __syncthreads();

    const bool active =
        !DECODE || (col0 < wcol_hi && col0 + kBlockN > wcol_lo);
    if (active) {
      const __nv_bfloat16* Ks = sK + cur * STAGE;
      const __nv_bfloat16* Vs = sV + cur * STAGE;
      float s[kBlockN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < HD / 16; ++kt) {
          const __nv_bfloat16* kp = Ks + (nt * 8 + gr) * SROW + kt * 16 + 2 * tq;
          mma_bf16(s[nt], st.q[kt], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
      // scale, mask, and the online update of rows gr (i=0) and gr+8 (i=1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wrow0 + gr + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + nt * 8 + 2 * tq + e;
            float x = s[nt][2 * i + e] * scale;
            bool valid = col < col_end;
            if (DECODE && valid) {
              x += bias[col];
              valid = (row / pn) == (col / c_d);
            }
            x = valid ? x : kNegInf;
            s[nt][2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(st.m[i], mx);
        const float corr = expf(st.m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[nt][2 * i + e] - m_new);
            s[nt][2 * i + e] = p;
            sum += p;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        st.l[i] = st.l[i] * corr + sum;
        st.m[i] = m_new;
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          st.o[nt][2 * i] *= corr;
          st.o[nt][2 * i + 1] *= corr;
        }
      }
      // acc += P V, P cast to bf16 as the A operand straight from registers
#pragma unroll
      for (int kt = 0; kt < kBlockN / 16; ++kt) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        const int mi = lane >> 3, r = lane & 7;
        const int key = kt * 16 + r + ((mi & 1) ? 8 : 0);
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + key * SROW + nt * 8 + ((mi & 2) ? 8 : 0));
          mma_bf16(st.o[nt], a, b[0], b[1]);
          mma_bf16(st.o[nt + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage `cur` is refilled by the next iteration
  }
}

template <int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    bf16_decode_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_ctx,
                       const __nv_bfloat16* __restrict__ v_ctx,
                       const __nv_bfloat16* __restrict__ k_dec,
                       const __nv_bfloat16* __restrict__ v_dec,
                       const float* __restrict__ dec_bias,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int rows, int m_c, int ld,
                       int c_d, int pn, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int gi = blockIdx.y;
  const int row0 = blockIdx.x * kRowTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + gr, rb = ra + 8;

  WarpState<HD> st;
  const __nv_bfloat16* qg = q + static_cast<size_t>(gi) * rows * HD;
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) {
    const int c = kt * 16 + 2 * tq;
    st.q[kt][0] = load_pair(qg + static_cast<size_t>(ra) * HD + c, ra < rows);
    st.q[kt][1] = load_pair(qg + static_cast<size_t>(rb) * HD + c, rb < rows);
    st.q[kt][2] = load_pair(qg + static_cast<size_t>(ra) * HD + c + 8, ra < rows);
    st.q[kt][3] = load_pair(qg + static_cast<size_t>(rb) * HD + c + 8, rb < rows);
  }
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    st.o[nt][0] = st.o[nt][1] = st.o[nt][2] = st.o[nt][3] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;

  const size_t ctx_off = static_cast<size_t>(gi) * m_c * HD;
  stream_arm<HD, false>(st, smem, k_ctx + ctx_off, v_ctx + ctx_off, 0, m_c,
                        m_c, scale, nullptr, 1, 1, wrow0);

  if (FUSED) {
    // decode slots of the samples in this CTA's row tile
    const int last_row = min(row0 + kRowTile, rows) - 1;
    const int col_begin = (row0 / pn) * c_d;
    const int col_end = min(ld, (last_row / pn + 1) * c_d);
    const size_t dec_off = static_cast<size_t>(gi) * ld * HD;
    stream_arm<HD, true>(st, smem, k_dec + dec_off, v_dec + dec_off,
                         col_begin, col_end, ld, scale, dec_bias, c_d, pn,
                         wrow0);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    const size_t base = (static_cast<size_t>(gi) * rows + row) * HD;
    if (FUSED) {
      const float inv = 1.f / fmaxf(st.l[i], kMinL);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const int c = nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(out + base + c) =
            __floats2bfloat162_rn(st.o[nt][2 * i] * inv,
                                  st.o[nt][2 * i + 1] * inv);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const int c = nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(acc_out + base + c) =
            make_float2(st.o[nt][2 * i], st.o[nt][2 * i + 1]);
      }
      if (tq == 0) {
        const size_t r = static_cast<size_t>(gi) * rows + row;
        m_out[r] = st.m[i];
        l_out[r] = st.l[i];
      }
    }
  }
}

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

struct Args {
  const void *q, *k_ctx, *v_ctx, *k_dec, *v_dec;
  const float* dec_bias;
  void* out;
  float *acc, *m, *l;
  int g, rows, m_c, ld, c_d, pn;
  float scale;
  cudaStream_t stream;
};

template <int HD, bool FUSED>
cudaError_t launch_bf16(const Args& a) {
  constexpr int smem = 2 * 2 * kBlockN * (HD + kPad) * sizeof(__nv_bfloat16);
  auto kern = bf16_decode_kernel<HD, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.rows + kRowTile - 1) / kRowTile, a.g);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k_ctx),
      static_cast<const __nv_bfloat16*>(a.v_ctx),
      static_cast<const __nv_bfloat16*>(a.k_dec),
      static_cast<const __nv_bfloat16*>(a.v_dec), a.dec_bias,
      static_cast<__nv_bfloat16*>(a.out), a.acc, a.m, a.l, a.rows, a.m_c,
      a.ld, a.c_d, a.pn, a.scale);
  return cudaGetLastError();
}

template <int HD, bool FUSED>
cudaError_t launch_f32(const Args& a) {
  dim3 grid((a.rows + kF32Rows - 1) / kF32Rows, a.g);
  f32_decode_kernel<HD, FUSED><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_ctx),
      static_cast<const float*>(a.v_ctx), static_cast<const float*>(a.k_dec),
      static_cast<const float*>(a.v_dec), a.dec_bias,
      static_cast<float*>(a.out), a.acc, a.m, a.l, a.rows, a.m_c, a.ld,
      a.c_d, a.pn, a.scale);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Head dims 16, 64, 80 and 128.
template <bool FUSED>
cudaError_t dispatch(const Args& a, int hd, int dtype) {
  if (a.g <= 0 || a.rows <= 0 || a.m_c <= 0 || a.pn <= 0 || a.c_d <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (hd) {
      case 16: return launch_bf16<16, FUSED>(a);
      case 64: return launch_bf16<64, FUSED>(a);
      case 80: return launch_bf16<80, FUSED>(a);
      case 128: return launch_bf16<128, FUSED>(a);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16, FUSED>(a);
      case 64: return launch_f32<64, FUSED>(a);
      case 80: return launch_f32<80, FUSED>(a);
      case 128: return launch_f32<128, FUSED>(a);
    }
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
  Args a{q, k_ctx, v_ctx, k_dec, v_dec, static_cast<const float*>(dec_bias),
         out, nullptr, nullptr, nullptr, g, rows, m_c, ld, c_d, pn, scale,
         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(a, hd, dtype));
}

// q (g, rows, hd), k_ctx/v_ctx (g, m_c, hd) in the q dtype; acc (g, rows, hd),
// m and l (g, rows), all f32.
int context_flash_partials(const void* q, const void* k_ctx, const void* v_ctx,
                           void* acc, void* m, void* l, int g, int rows,
                           int m_c, int hd, float scale, int dtype,
                           void* stream) {
  Args a{q, k_ctx, v_ctx, nullptr, nullptr, nullptr, nullptr,
         static_cast<float*>(acc), static_cast<float*>(m),
         static_cast<float*>(l), g, rows, m_c, 1, 1, 1, scale,
         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, hd, dtype));
}

}  // extern "C"
