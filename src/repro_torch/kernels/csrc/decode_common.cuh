// Shared device code of the bifurcated flash-decode kernels for Hopper
// (sm_90a): the tensor-core online-softmax stream over one arm, and one
// kernel template that every decode kernel of the port instantiates
// (bifurcated_decode.cu: the single-prefix bf16 kernels;
// forest_q8_decode.cu: the int8-context and multi-prefix kernels;
// tree_decode.cu: the prefix-trie kernels; paged_decode.cu: the paged-pool
// kernels; packed_decode.cu: the packed heterogeneous-step kernels). All
// take bf16 queries.
//
// One CTA of kThreads threads serves a tile of kRowTile query rows of one
// kv head (and, in the grouped kernels, one context segment; in the tree
// and paged kernels, every trie node or segment on its rows' paths). In
// the paged kernels each key row is addressed through its segment's page
// table (PageMap). Each warp
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

// How a kernel's rows find their context: one shared context (kSingle),
// one segment per row (kGrouped), every node on a row's trie path (kTree),
// every segment on a row's path, stored in pool pages (kPaged), or kPaged
// plus a prefill chunk's KV envelope for the rows whose path holds the
// pseudo-segment id N (kPacked).
enum : int { kSingle = 0, kGrouped = 1, kTree = 2, kPaged = 3, kPacked = 4 };
// What stream_arm reads of a row besides its query: nothing (kRowNone), a
// position for a causal mask (kRowCausal: key col sits at pos0 + col), or
// its decode slot, -1 for none (kRowSlot: the decode arm).
enum : int { kRowNone = 0, kRowCausal = 1, kRowSlot = 2 };
constexpr int kMaxDepth = 32;           // tree, paged: path-table height
constexpr int kMaxNodes = 65536;        // tree, paged: node-set bitmap, 8 KB

// Where the keys of one paged segment lie: its page-table row (ppn pool
// page ids, -1 = unallocated) over a (P, g, pm, HD) pool of one layer.
// Key `col` of kv head gi is row col % pm of page row[col / pm]. With no
// table row (row == nullptr) the keys lie in a dense sequence-major
// (m, g, HD) slab, key `col` at row col * g + gi (the packed kernels'
// fresh envelope). krow is shared memory for the row indices of the two
// staged blocks (2 x kBlockN ints), filled once per block by stream_arm.
struct PageMap {
  const int* row;
  int pm, g, gi, n_pages;
  int* krow;
  // The key's row index in the pool's P * g * pm rows (and in the
  // (P, g, pm) scale pages; the wrapper keeps that count below 2^31), or
  // -1 for a hole (-1) or an id outside [0, P): such a key is never read
  // and its logit is masked.
  __device__ __forceinline__ int key_row(int col) const {
    if (row == nullptr) return col * g + gi;
    const int pid = row[col / pm];
    return (pid < 0 || pid >= n_pages) ? -1 : (pid * g + gi) * pm + col % pm;
  }
};

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
  __host__ __device__ static constexpr int bytes(bool q8) {
    return q8 && Q8 > BF16 ? Q8 : BF16;
  }
};

// Memory row of the block's key r: col0 + r in a dense slab, valid below
// `limit`; paged, the stage's row table krow (-1: not read).
template <bool PAGED>
__device__ __forceinline__ size_t key_row(const int* krow, int col0, int r,
                                          int limit, bool& valid) {
  if constexpr (PAGED) {
    const int kr = krow[r];
    valid = kr >= 0;
    return valid ? static_cast<size_t>(kr) : 0;
  } else {
    const int col = col0 + r;
    valid = col < limit;
    return valid ? static_cast<size_t>(col) : 0;
  }
}

// Stage kBlockN rows [col0, col0 + kBlockN) of bf16 K and V (row length
// HD, rows at or past `limit`, and paged holes, zero-filled) into shared
// memory. Paged rows are addressed one by one through the block's row
// table `krow`: a block may straddle pages.
template <int HD, bool PAGED>
__device__ __forceinline__ void stage_block(__nv_bfloat16* sK,
                                            __nv_bfloat16* sV,
                                            const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, int col0,
                                            int limit, const int* krow) {
  constexpr int SROW = HD + kPad;
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockN * CHUNKS; c += kThreads) {
    int r = c / CHUNKS, ch = c % CHUNKS;
    bool valid;
    const size_t row = key_row<PAGED>(krow, col0, r, limit, valid);
    size_t off = valid ? row * HD + ch * 8 : 0;
    cp_async16(sK + r * SROW + ch * 8, k + off, valid);
    cp_async16(sV + r * SROW + ch * 8, v + off, valid);
  }
}

// The same for an int8 block and its scale vectors (unpadded rows).
template <int HD, bool PAGED>
__device__ __forceinline__ void stage_block_q8(
    int8_t* qK, int8_t* qV, float* sKs, float* sVs, const int8_t* k,
    const int8_t* v, const float* ks, const float* vs, int col0, int limit,
    const int* krow) {
  constexpr int CHUNKS = HD / 16;
  for (int c = threadIdx.x; c < kBlockN * CHUNKS; c += kThreads) {
    int r = c / CHUNKS, ch = c % CHUNKS;
    bool valid;
    const size_t row = key_row<PAGED>(krow, col0, r, limit, valid);
    size_t off = valid ? row * HD + ch * 16 : 0;
    cp_async16(qK + r * HD + ch * 16, k + off, valid);
    cp_async16(qV + r * HD + ch * 16, v + off, valid);
  }
  for (int r = threadIdx.x; r < kBlockN; r += kThreads) {
    bool valid;
    const size_t row = key_row<PAGED>(krow, col0, r, limit, valid);
    cp_async4(sKs + r, ks + row, valid);
    cp_async4(sVs + r, vs + row, valid);
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
// past `limit` are never read. row_on: bit 0 (row gr) and bit 1 (row gr+8)
// say whether this thread's rows attend the arm at all; a row that does not
// gets every logit at kNegInf (the tree kernels' node membership), and a
// warp none of whose rows does skips the products but takes the barriers.
// PAGED: keys are addressed through ``pg`` (k, v, ks, vs are one layer's
// pools): each block's row table is computed once into pg.krow (one
// division per key, then a barrier) before its copies are issued, and a
// key on a hole or an id outside the pool is masked like a key past
// col_end. ROWV: rv0 / rv1 are this thread's rows' values (gr, gr + 8):
// kRowCausal masks key col unless pos0 + col <= rv; kRowSlot (the decode
// arm) replaces the sample test row / pn == col / c_d by rv == col / c_d.
template <int HD, bool DECODE, bool Q8, bool PAGED = false,
          int ROWV = kRowNone>
__device__ __forceinline__ void stream_arm(
    WarpState<HD>& st, unsigned char* smem_raw, const void* k, const void* v,
    const float* ks, const float* vs, int col_begin, int col_end, int limit,
    float scale, const float* bias, int c_d, int pn, int wrow0,
    unsigned row_on = 3u, const PageMap& pg = PageMap{}, int rv0 = 0,
    int rv1 = 0, int pos0 = 0) {
  static_assert(!(DECODE && Q8), "the decode arm is bf16");
  static_assert(!(DECODE && PAGED), "the decode arm is dense");
  static_assert(ROWV != kRowSlot || DECODE, "row slots key the decode arm");
  static_assert(ROWV != kRowCausal || !DECODE, "the decode arm is not causal");
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
    int* krow = nullptr;
    if constexpr (PAGED) {
      // the block's row table: stage s's slot was last read by the block
      // before, whose iteration ended at a barrier
      krow = pg.krow + s * kBlockN;
      for (int r = threadIdx.x; r < kBlockN; r += kThreads) {
        const int col = col0 + r;
        krow[r] = col < limit ? pg.key_row(col) : -1;
      }
      __syncthreads();
    }
    if constexpr (Q8) {
      stage_block_q8<HD, PAGED>(qK + s * kBlockN * HD, qV + s * kBlockN * HD,
                                sKs + s * kBlockN, sVs + s * kBlockN,
                                static_cast<const int8_t*>(k),
                                static_cast<const int8_t*>(v), ks, vs, col0,
                                limit, krow);
    } else {
      stage_block<HD, PAGED>(sK + s * STAGE, sV + s * STAGE,
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v), col0,
                             limit, krow);
    }
  };

  const bool warp_on = __any_sync(0xffffffffu, row_on != 0u);
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
        warp_on && (!DECODE || (col0 < wcol_hi && col0 + kBlockN > wcol_lo));
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
      // paged: which of this thread's 16 columns hold a readable key
      unsigned col_ok = 0xffffu;
      if constexpr (PAGED) {
        const int* krow = pg.krow + cur * kBlockN;
        col_ok = 0u;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (krow[nt * 8 + 2 * tq + e] >= 0) col_ok |= 1u << (2 * nt + e);
          }
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
            bool valid = col < col_end && ((row_on >> i) & 1u) &&
                         ((col_ok >> (2 * nt + e)) & 1u);
            if (ROWV == kRowCausal) valid = valid && pos0 + col <= (i ? rv1 : rv0);
            if (DECODE && valid) {
              x += bias[col];
              valid = (ROWV == kRowSlot ? (i ? rv1 : rv0) : row / pn) ==
                      (col / c_d);
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
  const int* ctx_lens;    // (G,) i32 live segment / node lengths
  const int* paths;       // (depth, rows) i32 row -> node per level (tree,
                          // paged: row -> segment)
  const int* page_tables; // (N, ppn) i32 pool page per segment page (paged)
  const void* k_dec;      // (g, ld, HD) bf16
  const void* v_dec;
  const float* dec_bias;  // (ld,) f32, 0 or kNegInf
  void* out;              // (g, rows, HD) bf16 (fused)
  float* acc;             // (g, rows, HD) f32 (partials)
  float* m;               // (g, rows) f32 (partials)
  float* l;
  const void* k_fresh;    // (F * pm, g, HD) bf16 chunk KV envelope (packed)
  const void* v_fresh;
  const int* row_pos;     // (rows,) i32 chunk rows' positions (packed)
  const int* row_slot;    // (rows,) i32 decode slot per row, -1 (packed)
  int n_groups, g, rows, m_c, ld, c_d, pn;  // n_groups: G or N
  int depth;              // path-table height (tree, paged; packed: the
                          // trie's depth + 1)
  int ppn, page_m, n_pages;  // paged: table width, page size, pool pages;
                             // m_c = ppn * page_m
  int n_dec;              // packed: decode rows (b * pn), first in q
  int fresh_len, fresh_start;  // packed: live envelope rows, position of
                               // envelope row 0
  float scale;
};

// Stream the first `len` keys of context segment (or trie node) `seg` of
// kv head gi through the online softmax; positions start at
// (seg * g + gi) * m_c in the (G, g, m_c, HD) slabs and their scales.
template <int HD, bool Q8>
__device__ __forceinline__ void stream_segment(WarpState<HD>& st,
                                               unsigned char* smem_raw,
                                               const Params& p, int seg,
                                               int gi, int len, int wrow0,
                                               unsigned row_on) {
  const size_t off = (static_cast<size_t>(seg) * p.g + gi) * p.m_c;
  const size_t elt = Q8 ? 1 : 2;
  const unsigned char* kc = static_cast<const unsigned char*>(p.k_ctx);
  const unsigned char* vc = static_cast<const unsigned char*>(p.v_ctx);
  stream_arm<HD, false, Q8>(
      st, smem_raw, kc + off * HD * elt, vc + off * HD * elt,
      Q8 ? p.k_scale + off : nullptr, Q8 ? p.v_scale + off : nullptr, 0, len,
      len, p.scale, nullptr, 1, 1, wrow0, row_on);
}

// The paged twin: the first `len` keys of segment `seg`, kv head gi, each
// read from the pool page its page-table entry names (k_ctx/v_ctx and the
// scales are one layer's (P, g, pm, HD) and (P, g, pm) pools).
template <int HD, bool Q8>
__device__ __forceinline__ void stream_paged(WarpState<HD>& st,
                                             unsigned char* smem_raw,
                                             const Params& p, int seg,
                                             int gi, int len, int wrow0,
                                             unsigned row_on, int* krow) {
  const PageMap pg{p.page_tables + static_cast<size_t>(seg) * p.ppn,
                   p.page_m, p.g, gi, p.n_pages, krow};
  stream_arm<HD, false, Q8, true>(st, smem_raw, p.k_ctx, p.v_ctx, p.k_scale,
                                  p.v_scale, 0, len, len, p.scale, nullptr,
                                  1, 1, wrow0, row_on, pg);
}

// The operands of a fused launch over one context (the C entry points set
// the rest).
inline Params fused_params(const void* q, const void* k_ctx,
                           const void* v_ctx, const void* k_dec,
                           const void* v_dec, const void* dec_bias, void* out,
                           int g, int rows, int m_c, int ld, int c_d, int pn,
                           float scale) {
  Params a{};
  a.q = q;
  a.k_ctx = k_ctx;
  a.v_ctx = v_ctx;
  a.k_dec = k_dec;
  a.v_dec = v_dec;
  a.dec_bias = static_cast<const float*>(dec_bias);
  a.out = out;
  a.n_groups = 1;
  a.g = g;
  a.rows = rows;
  a.m_c = m_c;
  a.ld = ld;
  a.c_d = c_d;
  a.pn = pn;
  a.scale = scale;
  return a;
}

// Dynamic shared memory of one CTA: the stream's plan, then in the tree,
// paged and packed kernels the tile's bad-row mask (2 words), path table
// (depth x kRowTile ids) and node-set bitmap (one bit per node or
// segment), then in the paged and packed kernels the two staged blocks'
// row tables (2 x kBlockN ints), then in the packed kernels one word: does
// a row of the tile read the fresh envelope.
template <int HD, bool Q8, int MODE>
int smem_bytes(const Params& a) {
  int bytes = Smem<HD>::bytes(Q8);
  if (MODE == kTree || MODE == kPaged || MODE == kPacked)
    bytes += 4 * (2 + a.depth * kRowTile + (a.n_groups + 31) / 32);
  if (MODE == kPaged || MODE == kPacked) bytes += 4 * 2 * kBlockN;
  if (MODE == kPacked) bytes += 4;
  return bytes;
}

// One CTA per (row tile, kv head, segment). FUSED: context arm, then the
// decode arm of the tile's samples, normalised output; else the context
// arm's unnormalised partials. kGrouped: the CTA of segment grp walks only
// ctx_lens[grp] keys of its segment and writes only the rows assigned to
// grp (each row is written by exactly one CTA); a CTA whose tile holds no
// row of grp exits at once. Rows whose segment id lies outside [0, G) are
// written as NaN by the CTA of segment 0, so a caller's non-finite check
// sees them. kTree: the CTA first collects its rows' path table and the
// set of node ids on those paths (a bitmap: distinct by construction,
// which is the reference's set semantics), then streams each node of the
// set in ascending id order over its ctx_lens[node] live keys, a row
// taking part only where the node lies on its path; rows whose path holds
// an id outside [-1, N) are written as NaN. A row masked out of a node
// before its first node of its own accumulates finite garbage under
// m = kNegInf, and that first real block wipes it exactly (corr =
// exp(kNegInf - m_new) = 0): the state is then bit-equal to a fresh one,
// so at depth 1 the tree kernel computes the grouped kernel's bits.
// kPaged: kTree over segments whose keys lie in pool pages (stream_paged),
// each key row read from the page its segment's table names, so the same
// logical contents give kTree's bits at any page size. A table entry of -1
// inside a segment's live length is a hole: its keys are masked, never
// read. A live entry outside [-1, P) is never read either, and every row
// whose path holds its segment is written as NaN.
// kPacked: kPaged over a path table one level higher, whose id N (the
// pseudo-segment) marks the rows of a prefill chunk; ids outside [-1, N]
// give NaN rows. After the segment walk, if a row of the tile holds N and
// fresh_len > 0, the fresh arm: keys [0, fresh_len) of the chunk's dense
// (F * pm, g, HD) envelope, a row taking part only if its path holds N
// and only in the keys at positions fresh_start + col <= row_pos[row].
// Then the decode arm over the slots of the tile's decode rows (the first
// n_dec rows), each row keyed by row_slot (-1: none) instead of row / pn.
// With no chunk rows every step is kPaged's, so the bits are #8's / #9's.
template <int HD, bool FUSED, bool Q8, int MODE>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  static_assert(FUSED || (!Q8 && MODE == kSingle),
                "partials: bf16, one segment");
  constexpr bool GROUPED = MODE == kGrouped;
  constexpr bool PACKED = MODE == kPacked;
  constexpr bool PAGES = MODE == kPaged || PACKED;
  constexpr bool PATHS = MODE == kTree || PAGES;
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
  // tree, paged: the tile's bad-row mask, path table and node set
  unsigned* s_bad =
      reinterpret_cast<unsigned*>(smem_raw + Smem<HD>::bytes(Q8));
  int* s_path = reinterpret_cast<int*>(s_bad + 2);
  unsigned* s_nodes =
      reinterpret_cast<unsigned*>(s_path + p.depth * kRowTile);
  const int node_words = (p.n_groups + 31) / 32;
  int* s_krow = reinterpret_cast<int*>(s_nodes + node_words);   // paged
  int* s_fresh = s_krow + 2 * kBlockN;                           // packed
  if (PATHS) {
    for (int w = threadIdx.x; w < node_words; w += kThreads) s_nodes[w] = 0u;
    if (threadIdx.x < 2) s_bad[threadIdx.x] = 0u;
    if (PACKED && threadIdx.x == 0) *s_fresh = 0;
    __syncthreads();
    // the largest id a path may hold: N - 1, or packed the pseudo id N
    const int max_id = PACKED ? p.n_groups : p.n_groups - 1;
    for (int e = threadIdx.x; e < p.depth * kRowTile; e += kThreads) {
      const int r = e % kRowTile, row = row0 + r;
      int id = row < rows ? p.paths[(e / kRowTile) * rows + row] : -1;
      if (id < -1 || id > max_id) {
        atomicOr(&s_bad[r >> 5], 1u << (r & 31));
        id = -1;
      }
      s_path[e] = id;
      if (id >= 0 && id < p.n_groups)
        atomicOr(&s_nodes[id >> 5], 1u << (id & 31));
      else if (PACKED && id == p.n_groups)
        *s_fresh = 1;
    }
    __syncthreads();
  }
  if (PAGES) {
    // a segment whose live pages name an id outside [-1, P) poisons the
    // rows on it (the set is read by every thread alike: uniform loop)
    for (int w = 0; w < node_words; ++w) {
      for (unsigned bits = s_nodes[w]; bits; bits &= bits - 1u) {
        const int seg = w * 32 + __ffs(bits) - 1;
        const int len = min(max(p.ctx_lens[seg], 0), p.m_c);
        const int* row = p.page_tables + static_cast<size_t>(seg) * p.ppn;
        bool poison = false;
        for (int j = threadIdx.x; j * p.page_m < len; j += kThreads)
          poison |= row[j] < -1 || row[j] >= p.n_pages;
        if (__syncthreads_or(poison)) {
          for (int e = threadIdx.x; e < p.depth * kRowTile; e += kThreads) {
            if (s_path[e] == seg) {
              const int r = e % kRowTile;
              atomicOr(&s_bad[r >> 5], 1u << (r & 31));
            }
          }
        }
      }
    }
    __syncthreads();
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

  if (PATHS) {
    const int la = ra - row0, lb = rb - row0;   // tile-local rows
    for (int w = 0; w < node_words; ++w) {
      for (unsigned bits = s_nodes[w]; bits; bits &= bits - 1u) {
        const int node = w * 32 + __ffs(bits) - 1;
        unsigned on = 0u;
        for (int lvl = 0; lvl < p.depth; ++lvl) {
          on |= s_path[lvl * kRowTile + la] == node ? 1u : 0u;
          on |= s_path[lvl * kRowTile + lb] == node ? 2u : 0u;
        }
        const int len = min(max(p.ctx_lens[node], 0), p.m_c);
        if constexpr (PAGES)
          stream_paged<HD, Q8>(st, smem_raw, p, node, gi, len, wrow0, on,
                               s_krow);
        else
          stream_segment<HD, Q8>(st, smem_raw, p, node, gi, len, wrow0, on);
      }
    }
  } else {
    stream_segment<HD, Q8>(st, smem_raw, p, grp, gi, ctx_len, wrow0, 3u);
  }

  if constexpr (PACKED) {
    // the fresh arm: the chunk's envelope, causal per row; bf16 also in the
    // q8 kernel (its plan holds the bf16 one from offset 0)
    if (*s_fresh && p.fresh_len > 0) {
      const int la = ra - row0, lb = rb - row0;
      unsigned on = 0u;
      for (int lvl = 0; lvl < p.depth; ++lvl) {
        on |= s_path[lvl * kRowTile + la] == p.n_groups ? 1u : 0u;
        on |= s_path[lvl * kRowTile + lb] == p.n_groups ? 2u : 0u;
      }
      const PageMap fresh{nullptr, 1, p.g, gi, 0, s_krow};
      stream_arm<HD, false, false, true, kRowCausal>(
          st, smem_raw, p.k_fresh, p.v_fresh, nullptr, nullptr, 0,
          p.fresh_len, p.fresh_len, p.scale, nullptr, 1, 1, wrow0, on, fresh,
          ra < rows ? p.row_pos[ra] : -1, rb < rows ? p.row_pos[rb] : -1,
          p.fresh_start);
    }
  }

  if (FUSED) {
    // decode slots of the samples in this CTA's row tile (packed: of its
    // decode rows, the first n_dec; a tile of chunk rows only has none)
    const int last_row = min(row0 + kRowTile, PACKED ? p.n_dec : rows) - 1;
    if (!PACKED || last_row >= row0) {
      const int col_begin = (row0 / p.pn) * p.c_d;
      const int col_end = min(p.ld, (last_row / p.pn + 1) * p.c_d);
      const size_t dec_off = static_cast<size_t>(gi) * p.ld * HD;
      const __nv_bfloat16* kd =
          static_cast<const __nv_bfloat16*>(p.k_dec) + dec_off;
      const __nv_bfloat16* vd =
          static_cast<const __nv_bfloat16*>(p.v_dec) + dec_off;
      if constexpr (PACKED)
        stream_arm<HD, true, false, false, kRowSlot>(
            st, smem_raw, kd, vd, nullptr, nullptr, col_begin, col_end, p.ld,
            p.scale, p.dec_bias, p.c_d, p.pn, wrow0, 3u, PageMap{},
            ra < rows ? p.row_slot[ra] : -1, rb < rows ? p.row_slot[rb] : -1);
      else
        stream_arm<HD, true, false>(st, smem_raw, kd, vd, nullptr, nullptr,
                                    col_begin, col_end, p.ld, p.scale,
                                    p.dec_bias, p.c_d, p.pn, wrow0);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    if (GROUPED && p.row_group[row] != grp) continue;
    const size_t base = (static_cast<size_t>(gi) * rows + row) * HD;
    if (FUSED) {
      const int r = row - row0;
      const bool bad = PATHS && ((s_bad[r >> 5] >> (r & 31)) & 1u);
      const float inv = bad ? __int_as_float(0x7fc00000)
                            : 1.f / fmaxf(st.l[i], kMinL);
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

template <int HD, bool FUSED, bool Q8, int MODE>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  const int smem = smem_bytes<HD, Q8, MODE>(a);
  auto kern = decode_kernel<HD, FUSED, Q8, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.rows + kRowTile - 1) / kRowTile, a.g,
            MODE == kGrouped ? a.n_groups : 1);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Head dims 16, 64, 80, 112 and 128 (zamba2's 112: 7 k-steps of the
// m16n8k16 product, 14 n-tiles, 14 16-byte chunks per bf16 row and 7 per
// int8 row; nothing in the template needs a power of two).
template <bool FUSED, bool Q8, int MODE>
cudaError_t dispatch_hd(const Params& a, int hd, cudaStream_t stream) {
  if (a.g <= 0 || a.rows <= 0 || a.m_c <= 0 || a.pn <= 0 || a.c_d <= 0 ||
      a.n_groups <= 0 || (MODE == kGrouped && a.n_groups > 65535) ||
      ((MODE == kTree || MODE == kPaged || MODE == kPacked) &&
       (a.n_groups > kMaxNodes || a.depth < 1 || a.depth > kMaxDepth)) ||
      ((MODE == kPaged || MODE == kPacked) &&
       (a.page_m < 1 || a.ppn < 1 || a.n_pages < 1)) ||
      (MODE == kPacked && (a.n_dec < 0 || a.n_dec > a.rows ||
                           a.fresh_len < 0 || a.ld % a.c_d != 0 ||
                           a.ld / a.c_d * a.pn != a.n_dec)))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16, FUSED, Q8, MODE>(a, stream);
    case 64: return launch<64, FUSED, Q8, MODE>(a, stream);
    case 80: return launch<80, FUSED, Q8, MODE>(a, stream);
    case 112: return launch<112, FUSED, Q8, MODE>(a, stream);
    case 128: return launch<128, FUSED, Q8, MODE>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bifurcated
