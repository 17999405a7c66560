// Shared device code of the bifurcated flash-decode kernels for Hopper
// (sm_90a): the tensor-core online-softmax stream over one arm, and one
// kernel template that every bf16-query decode kernel of the port
// instantiates (bifurcated_decode.cu: the single-prefix bf16 kernels;
// forest_q8_decode.cu: the int8-context and multi-prefix kernels).
//
// One CTA of kThreads threads serves a tile of kRowTile query rows of one
// kv head (and, in the grouped kernels, one context segment). Each warp
// owns 16 rows; its running fp32 state (max, sumexp, acc) stays in
// registers. Keys stream in blocks of kBlockN through a two-stage
// cp.async ring in shared memory; both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate). The update is the port
// of the reference's _online_update (src/repro/kernels/bifurcated_decode.py):
// m_new = max(m, max_j s_j), corr = exp(m - m_new), p_j = exp(s_j - m_new),
// l = l * corr + sum_j p_j, acc = acc * corr + (p * p_scale) V, with the
// weights cast to bf16 for the value product and l left unscaled.
//
// int8 context arm (Q8): the int8 K/V block and its two f32 scale vectors
// are staged with cp.async (half the bytes of bf16), then converted once
// to bf16 in shared memory: an int8 value |v| <= 127 is exact in bf16, so
// q . K_q runs on the same bf16 tensor-core path and is exact up to fp32
// summation order. The f32 logits are multiplied by k_scale[col] (which
// carries the logit scale pre-folded: no multiply by `scale` on this
// arm), and the softmax weights by v_scale[col] before the value product,
// l unscaled. The reference runs that product in f32 (V_q cast to f32);
// here the weights p * s_v are rounded to bf16 for the tensor cores, a
// rounding inside the bf16 tolerance. The s8 tensor-core MMA is not used:
// it would need q quantised, which is another function.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bifurcated {

constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;

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

// 16-byte copy; 0 source bytes when !valid: the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(n));
}

// 4-byte copy (a scale), zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
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

// Shared-memory plan of one CTA, in bytes. bf16 arms: K and V, two stages
// each, rows padded by kPad. int8 arm: one converted bf16 K and V block,
// then the int8 K and V blocks and their f32 scales, two stages each. The
// decode arm of a q8 kernel reuses the bf16 plan from offset 0.
template <int HD>
struct Smem {
  static constexpr int SROW = HD + kPad;
  static constexpr int STAGE = kBlockN * SROW;   // bf16 elements
  static constexpr int BF16 = 2 * 2 * STAGE * 2;
  static constexpr int Q8 = 2 * STAGE * 2 + 2 * 2 * kBlockN * HD +
                            2 * 2 * kBlockN * 4;
  static constexpr int bytes(bool q8) { return q8 && Q8 > BF16 ? Q8 : BF16; }
};

// Stage kBlockN rows [col0, col0 + kBlockN) of bf16 K and V (row length
// HD, rows at or past `limit` zero-filled) into shared memory.
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

// The same for an int8 block and its scale vectors (unpadded rows).
template <int HD>
__device__ __forceinline__ void stage_block_q8(
    int8_t* qK, int8_t* qV, float* sKs, float* sVs, const int8_t* k,
    const int8_t* v, const float* ks, const float* vs, int col0, int limit) {
  constexpr int CHUNKS = HD / 16;
  for (int c = threadIdx.x; c < kBlockN * CHUNKS; c += kThreads) {
    int r = c / CHUNKS, ch = c % CHUNKS;
    int col = col0 + r;
    bool valid = col < limit;
    size_t off = valid ? static_cast<size_t>(col) * HD + ch * 16 : 0;
    cp_async16(qK + r * HD + ch * 16, k + off, valid);
    cp_async16(qV + r * HD + ch * 16, v + off, valid);
  }
  for (int r = threadIdx.x; r < kBlockN; r += kThreads) {
    int col = col0 + r;
    bool valid = col < limit;
    cp_async4(sKs + r, ks + (valid ? col : 0), valid);
    cp_async4(sVs + r, vs + (valid ? col : 0), valid);
  }
}

// Convert a staged int8 K/V block to bf16 (exact) in the padded layout.
template <int HD>
__device__ __forceinline__ void convert_block(__nv_bfloat16* cK,
                                              __nv_bfloat16* cV,
                                              const int8_t* qK,
                                              const int8_t* qV) {
  constexpr int SROW = HD + kPad;
  constexpr int CHUNKS = HD / 16;
  for (int c = threadIdx.x; c < 2 * kBlockN * CHUNKS; c += kThreads) {
    const bool is_v = c >= kBlockN * CHUNKS;
    const int cc = is_v ? c - kBlockN * CHUNKS : c;
    const int r = cc / CHUNKS, ch = cc % CHUNKS;
    const int4 raw =
        *reinterpret_cast<const int4*>((is_v ? qV : qK) + r * HD + ch * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = pack_bf16(static_cast<float>(b[2 * i]),
                       static_cast<float>(b[2 * i + 1]));
    __nv_bfloat16* dst = (is_v ? cV : cK) + r * SROW + ch * 16;
    *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(dst + 8) = make_int4(w[4], w[5], w[6], w[7]);
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
// its own sample's slots (row / pn == col / c_d). Q8: an int8 context arm
// with per-key scales ks (logit scale folded in) and vs. Memory rows at or
// past `limit` are never read.
template <int HD, bool DECODE, bool Q8>
__device__ __forceinline__ void stream_arm(
    WarpState<HD>& st, unsigned char* smem_raw, const void* k, const void* v,
    const float* ks, const float* vs, int col_begin, int col_end, int limit,
    float scale, const float* bias, int c_d, int pn, int wrow0) {
  static_assert(!(DECODE && Q8), "the decode arm is bf16");
  constexpr int SROW = HD + kPad;
  constexpr int STAGE = kBlockN * SROW;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nblk = (col_end - col_begin + kBlockN - 1) / kBlockN;
  if (nblk <= 0) return;
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // bf16 plan: two stages of K, then two of V
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = smem + 2 * STAGE;
  // q8 plan: converted K, V; int8 K, V (2 stages each); scales (2 stages)
  __nv_bfloat16* cK = smem;
  __nv_bfloat16* cV = smem + STAGE;
  int8_t* qK = reinterpret_cast<int8_t*>(smem + 2 * STAGE);
  int8_t* qV = qK + 2 * kBlockN * HD;
  float* sKs = reinterpret_cast<float*>(qV + 2 * kBlockN * HD);
  float* sVs = sKs + 2 * kBlockN;

  auto stage = [&](int s, int col0) {
    if constexpr (Q8) {
      stage_block_q8<HD>(qK + s * kBlockN * HD, qV + s * kBlockN * HD,
                         sKs + s * kBlockN, sVs + s * kBlockN,
                         static_cast<const int8_t*>(k),
                         static_cast<const int8_t*>(v), ks, vs, col0, limit);
    } else {
      stage_block<HD>(sK + s * STAGE, sV + s * STAGE,
                      static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v), col0, limit);
    }
  };

  // decode arm: the warp's rows read only their samples' slot range
  int wcol_lo = 0, wcol_hi = col_end;
  if (DECODE) {
    wcol_lo = (wrow0 / pn) * c_d;
    wcol_hi = ((wrow0 + 15) / pn + 1) * c_d;
  }

  stage(0, col_begin);
  cp_async_commit();
  for (int blk = 0; blk < nblk; ++blk) {
    const int cur = blk & 1;
    const int col0 = col_begin + blk * kBlockN;
    if (blk + 1 < nblk) stage(cur ^ 1, col0 + kBlockN);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest is done: block blk
    __syncthreads();

    const __nv_bfloat16* Ks;
    const __nv_bfloat16* Vs;
    const float* kss = nullptr;
    const float* vss = nullptr;
    if constexpr (Q8) {
      convert_block<HD>(cK, cV, qK + cur * kBlockN * HD,
                        qV + cur * kBlockN * HD);
      __syncthreads();
      Ks = cK;
      Vs = cV;
      kss = sKs + cur * kBlockN;
      vss = sVs + cur * kBlockN;
    } else {
      Ks = sK + cur * STAGE;
      Vs = sV + cur * STAGE;
    }

    const bool active =
        !DECODE || (col0 < wcol_hi && col0 + kBlockN > wcol_lo);
    if (active) {
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
            const int j = nt * 8 + 2 * tq + e;
            const int col = col0 + j;
            float x = s[nt][2 * i + e] * (Q8 ? kss[j] : scale);
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
            sum += p;
            // the weights of the value product carry v_scale; l does not
            s[nt][2 * i + e] = Q8 ? p * vss[nt * 8 + 2 * tq + e] : p;
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
    __syncthreads();  // the stage and the converted block are refilled next
  }
}

// Everything one launch of a decode kernel reads and writes. Element
// pointers are untyped: bf16 or int8 by kernel.
struct Params {
  const void* q;          // (g, rows, HD) bf16
  const void* k_ctx;      // (G, g, m_c, HD) bf16 | int8 (G = 1 unless grouped)
  const void* v_ctx;
  const float* k_scale;   // (G, g, m_c) f32, logit scale folded (Q8)
  const float* v_scale;   // (G, g, m_c) f32 (Q8)
  const int* row_group;   // (rows,) i32 row -> segment (grouped)
  const int* ctx_lens;    // (G,) i32 live segment lengths (grouped)
  const void* k_dec;      // (g, ld, HD) bf16
  const void* v_dec;
  const float* dec_bias;  // (ld,) f32, 0 or kNegInf
  void* out;              // (g, rows, HD) bf16 (fused)
  float* acc;             // (g, rows, HD) f32 (partials)
  float* m;               // (g, rows) f32 (partials)
  float* l;
  int n_groups, g, rows, m_c, ld, c_d, pn;
  float scale;
};

// One CTA per (row tile, kv head, segment). FUSED: context arm, then the
// decode arm of the tile's samples, normalised output; else the context
// arm's unnormalised partials. GROUPED: the CTA of segment grp walks only
// ctx_lens[grp] keys of its segment and writes only the rows assigned to
// grp (each row is written by exactly one CTA); a CTA whose tile holds no
// row of grp exits at once. Rows whose segment id lies outside [0, G) are
// written as NaN by the CTA of segment 0, so a caller's non-finite check
// sees them.
template <int HD, bool FUSED, bool Q8, bool GROUPED>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  static_assert(FUSED || !(Q8 || GROUPED), "partials: bf16, one segment");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gi = blockIdx.y;
  const int grp = GROUPED ? blockIdx.z : 0;
  const int row0 = blockIdx.x * kRowTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + gr, rb = ra + 8;
  const int rows = p.rows;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  int ctx_len = p.m_c;
  if (GROUPED) {
    int owned = 0;
    const int row = row0 + threadIdx.x;
    if (threadIdx.x < kRowTile && row < rows) {
      const int id = p.row_group[row];
      owned = id == grp;
      if (grp == 0 && (id < 0 || id >= p.n_groups)) {
        __nv_bfloat16* o = out + (static_cast<size_t>(gi) * rows + row) * HD;
        for (int d = 0; d < HD; ++d) o[d] = __ushort_as_bfloat16(0x7fc0);
      }
    }
    if (!__syncthreads_or(owned)) return;
    ctx_len = min(max(p.ctx_lens[grp], 0), p.m_c);
  }

  WarpState<HD> st;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(gi) * rows * HD;
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

  // this (segment, kv head)'s context: positions start at seg_off
  const size_t seg_off = (static_cast<size_t>(grp) * p.g + gi) * p.m_c;
  const size_t elt = Q8 ? 1 : 2;
  const unsigned char* kc = static_cast<const unsigned char*>(p.k_ctx);
  const unsigned char* vc = static_cast<const unsigned char*>(p.v_ctx);
  stream_arm<HD, false, Q8>(
      st, smem_raw, kc + seg_off * HD * elt, vc + seg_off * HD * elt,
      Q8 ? p.k_scale + seg_off : nullptr, Q8 ? p.v_scale + seg_off : nullptr,
      0, ctx_len, ctx_len, p.scale, nullptr, 1, 1, wrow0);

  if (FUSED) {
    // decode slots of the samples in this CTA's row tile
    const int last_row = min(row0 + kRowTile, rows) - 1;
    const int col_begin = (row0 / p.pn) * p.c_d;
    const int col_end = min(p.ld, (last_row / p.pn + 1) * p.c_d);
    const size_t dec_off = static_cast<size_t>(gi) * p.ld * HD;
    stream_arm<HD, true, false>(
        st, smem_raw, static_cast<const __nv_bfloat16*>(p.k_dec) + dec_off,
        static_cast<const __nv_bfloat16*>(p.v_dec) + dec_off, nullptr,
        nullptr, col_begin, col_end, p.ld, p.scale, p.dec_bias, p.c_d, p.pn,
        wrow0);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    if (GROUPED && p.row_group[row] != grp) continue;
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
        *reinterpret_cast<float2*>(p.acc + base + c) =
            make_float2(st.o[nt][2 * i], st.o[nt][2 * i + 1]);
      }
      if (tq == 0) {
        const size_t r = static_cast<size_t>(gi) * rows + row;
        p.m[r] = st.m[i];
        p.l[r] = st.l[i];
      }
    }
  }
}

template <int HD, bool FUSED, bool Q8, bool GROUPED>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  constexpr int smem = Smem<HD>::bytes(Q8);
  auto kern = decode_kernel<HD, FUSED, Q8, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.rows + kRowTile - 1) / kRowTile, a.g,
            GROUPED ? a.n_groups : 1);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Head dims 16, 64, 80 and 128.
template <bool FUSED, bool Q8, bool GROUPED>
cudaError_t dispatch_hd(const Params& a, int hd, cudaStream_t stream) {
  if (a.g <= 0 || a.rows <= 0 || a.m_c <= 0 || a.pn <= 0 || a.c_d <= 0 ||
      a.n_groups <= 0 || a.n_groups > 65535)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16, FUSED, Q8, GROUPED>(a, stream);
    case 64: return launch<64, FUSED, Q8, GROUPED>(a, stream);
    case 80: return launch<80, FUSED, Q8, GROUPED>(a, stream);
    case 128: return launch<128, FUSED, Q8, GROUPED>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bifurcated
