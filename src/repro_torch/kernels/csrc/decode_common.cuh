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
//
// Split walk (#1-#11 with splits > 1, the default on the card;
// end of this file): the context's (the segment's, the node set's, the
// packed envelope's) blocks and the decode arm cut into pieces spread over
// S CTAs per (row tile, kv head), fp32 partials per piece and row, and an
// exact merge kernel; a row's bits depend on its own path only, so #3 and
// #9 give the same bits on one single prefix, #1 and #8 likewise, #5 gives
// #7's at depth 1, #4 #6's, and #11's decode rows #9's, #10's #8's.
#pragma once

#include <cuda_bf16.h>
#include <climits>
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

// Which of this thread's two rows (tile-local la: bit 0, lb: bit 1) hold
// `id` at some level of the tile's (depth, kRowTile) path table.
__device__ __forceinline__ unsigned rows_on(const int* s_path, int depth,
                                            int la, int lb, int id) {
  unsigned on = 0u;
  for (int lvl = 0; lvl < depth; ++lvl) {
    on |= s_path[lvl * kRowTile + la] == id ? 1u : 0u;
    on |= s_path[lvl * kRowTile + lb] == id ? 2u : 0u;
  }
  return on;
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
  float* part;            // split walk: f32 scratch, each row's slots of
                          // HD acc (slot_base), then their (m, l), then
                          // (g, rows) i32 piece counts
  int splits;             // split walk: S CTAs per (row tile, kv head)
  int max_pieces;         // split walk: pieces a row may read, at most
  int splits_chunk;       // packed split walk: S of the chunk rows' tiles
  int max_pieces_chunk;   // and the pieces a chunk row may read
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
  a.depth = 1;
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
        const unsigned on = rows_on(s_path, p.depth, la, lb, node);
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
      const unsigned on = rows_on(s_path, p.depth, la, lb, p.n_groups);
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
// int8 row; nothing in the template needs a power of two). kGrouped's G
// bound (the single walk's grid z) also keeps its split walk's node
// bitmap within kMaxNodes.
template <int MODE>
bool params_ok(const Params& a) {
  return !(a.g <= 0 || a.rows <= 0 || a.m_c <= 0 || a.pn <= 0 ||
           a.c_d <= 0 || a.n_groups <= 0 ||
           (MODE == kGrouped && a.n_groups > 65535) ||
           ((MODE == kTree || MODE == kPaged || MODE == kPacked) &&
            (a.n_groups > kMaxNodes || a.depth < 1 ||
             a.depth > kMaxDepth)) ||
           ((MODE == kPaged || MODE == kPacked) &&
            (a.page_m < 1 || a.ppn < 1 || a.n_pages < 1)) ||
           (MODE == kPacked && (a.n_dec < 0 || a.n_dec > a.rows ||
                                a.fresh_len < 0 || a.ld % a.c_d != 0 ||
                                a.ld / a.c_d * a.pn != a.n_dec)));
}

template <bool FUSED, bool Q8, int MODE>
cudaError_t dispatch_hd(const Params& a, int hd, cudaStream_t stream) {
  if (!params_ok<MODE>(a)) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16, FUSED, Q8, MODE>(a, stream);
    case 64: return launch<64, FUSED, Q8, MODE>(a, stream);
    case 80: return launch<80, FUSED, Q8, MODE>(a, stream);
    case 112: return launch<112, FUSED, Q8, MODE>(a, stream);
    case 128: return launch<128, FUSED, Q8, MODE>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The split walk: #1 (fused_bifurcated_decode, bf16 context), #2
// (context_flash_partials, #1's context arm alone) and #3
// (fused_bifurcated_decode_q8, int8 context) over one shared context
// (kSingle), #4 / #5 (grouped_fused_bifurcated_decode[_q8], kGrouped) over
// bf16 / int8 forest segments, #6 / #7 (tree_fused_bifurcated_decode[_q8]) and #8 / #9
// (paged_fused_bifurcated_decode[_q8]) over bf16 / int8 node sets, #10 /
// #11 (packed_fused_bifurcated_decode[_q8], kPacked) over #8's / #9's node
// set plus a prefill chunk's envelope, each with splits S > 1; S = 1 runs
// decode_kernel's single walk.
//
// What bounds them: bytes (#1 and #8 single 35.7 MB, #2 34.0 MB, #3 and
// #9 single 19.4 MB, the int8 forest 40.3 MB, the bf16 trie 48.3 MB and
// the int8 one 26.6 MB at the main shapes: 10.6 / 10.1 / 5.8 / 12.0 /
// 14.4 / 7.9 us at 3.35 TB/s; #10 / #11 operations, 29.84 GFLOP of their
// chunk rows: 30.2 us at 989 TFLOP/s), but the single walk is paced by
// latency: one CTA of 4 warps per (64-row tile, kv head[, segment]), 8 CTAs
// on 132 SMs at the main shapes (#4 / #5: 32, the longest segment's
// setting the pace; #10 / #11: 136, the decode tile walking every live node), each
// block ~2-3 us of serial copy, (convert) and product steps.
//
// What the design does about it:
//   * More CTAs. The work of a (tile, kv head) is cut into pieces: each
//     node's blocks in runs of kPieceBlocks from its first key (in
//     ascending node id; kSingle: the one context, a node of m_c keys read
//     by every row, with no path table, node bitmap or page table in
//     device memory), then the tile's decode arm in runs of as many blocks
//     from its first slot. S CTAs (blockIdx.z) take consecutive runs of
//     pieces, a context block weighing kCtxWeight (int8) or
//     kCtxWeightBf16 decode blocks, the heaviest run as light as S runs
//     allow (split_kernel). At the main shapes S = 33: two CTAs an SM, one
//     wave. kGrouped is kTree at depth 1 (the path table is row_group), so
//     a tile reads each of its rows' segments once, in pieces. kPacked:
//     the decode rows' tiles are #8's / #9's; the chunk rows' tiles
//     follow, each with S_chunk CTAs and pieces of kChunkPieceBlocks
//     (their ancestors, then the envelope after every real node), so the
//     chunk rows' partials are an eighth as many.
//   * Pieces, not an even cut of the list. A piece's bounds depend on its
//     own node's length alone, and each piece is summed from a fresh fp32
//     state; so a row's keys fall into the same pieces whatever else the
//     tile holds, and its bits do not move when another request is retired
//     and readmitted (the engines' guarantee), nor with S, nor with the page
//     size: #9 and #7 (#8 and #6) give the same bits on one logical
//     trie, #3 gives #9's bits (#1 #8's) on one single prefix, and #5
//     (#4) gives #7's (#6's) on a depth-1 trie.
//   * An exact merge. Each piece writes the fp32 (acc, m, l) of its rows
//     (the rows on its node; for a decode piece, the rows whose sample has
//     slots in it) to the row's own slot of the wrapper's scratch, slots in
//     the row's order: its nodes ascending, then its decode pieces.
//     merge_kernel folds a row's slots in that order: m = max m_s, l = sum
//     l_s exp(m_s - m), acc = sum acc_s exp(m_s - m), out = acc / max(l,
//     1e-30) in bf16 (#2: acc, m and l themselves, in fp32). Rows masked
//     out of a whole piece (a hole, a chunk row's later keys) carry
//     finite garbage under m = kNegInf there, weighed by exp(kNegInf - m)
//     = 0 once the row has a live key anywhere; share 0 runs the path and
//     page checks and marks a poisoned row's count -1: NaN.
//   * Fewer steps per block. int8 context blocks stream through two int8
//     cp.async stages and two converted bf16 stages with one barrier per
//     block: each thread converts the 16-byte chunks it copied itself, as
//     soon as its own copies of the next block landed, overlapping the
//     products of the current one; the products read bf16 by ldmatrix. A
//     bf16 context (#1, #2, #4, #6, #8, #10: stream_bf16_nodes, each stage
//     carrying its keys' read flags) and the decode arm (stream_bf16_split)
//     stream through three bf16 cp.async stages, one barrier a block,
//     nothing to convert; the decode arm stages its slot bias with the
//     block (the single walk reads it from device memory inside the mask)
//     and divides by multiply and shift: a decode block costs ~half an int8
//     context block there (~5x in the single walk).
//
// What holds them now (PERF.md): a fixed cost a call, ~25 of #1's ~37 us
// at the main shape by the weight sweep (the set-up before a CTA's first
// block, the merge's pass over the partials, the launch between the two
// kernels), then each block's chain of dependent steps (one barrier a
// block) over whole pieces (at the main shapes some CTA takes two); #10 /
// #11: their ~29,000 64-key block units a call (most of them the chunk
// tiles'), at ~1.3-1.5 us a unit per SM (#11) whatever the shares; and
// the wrappers' host work, which exceeds the kernels' time.
// ---------------------------------------------------------------------------

constexpr int kCtxWeight = 2;   // an int8 context block's CTA time in decode
                                // blocks (bf16, staged bias)
constexpr int kCtxWeightBf16 = 1;  // a bf16 context block's, likewise
                                   // (tools/split_weight.py measures it)
constexpr int kPieceBlocks = 4;  // blocks of a piece: 256 keys or slots
constexpr int kChunkPieceBlocks = 32;  // a chunk row's (#10, #11): 2048 keys
// int8 stages of the context stream: 2 keep two CTAs an SM in shared memory
constexpr int kQStages = 2;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory plan of the split walk: two int8 stages (K and V blocks
// in unpadded rows, their f32 scales, one key flag each) that cp.async
// fills, and two converted stages (the same block in bf16, rows padded by
// kPad, and the scales and flags) that the products read.
template <int HD>
struct Ring {
  static constexpr int SROW = HD + kPad;
  static constexpr int CONV = kBlockN * SROW * 2;               // bytes
  static constexpr int TAIL = 3 * kBlockN * 4;   // k scales, v scales, flags
  static constexpr int CSTAGE = 2 * CONV + TAIL;
  static constexpr int QSTAGE = 2 * kBlockN * HD + TAIL;
  static constexpr int CHUNKS = HD / 16;        // 16-byte chunks per int8 row
  static constexpr int PER_THREAD = (kBlockN * CHUNKS + kThreads - 1) / kThreads;
  static constexpr int BYTES = 2 * CSTAGE + kQStages * QSTAGE;
  // a bf16 context or the decode arm: three stages of bf16 K, V and 64
  // words (the decode arm's slot bias, a context's key flags)
  static constexpr int DSTAGE = 2 * CONV + kBlockN * 4;
  static constexpr int PLAN = BYTES > 3 * DSTAGE ? BYTES : 3 * DSTAGE;
};

// n / d and n % d for 0 <= n < 2^31 by a multiply and a shift (d >= 1
// fixed per launch: the page size): q = (umulhi(n, m) + n) >> s with
// s = ceil(log2 d), m = floor(2^32 (2^s - d) / d) + 1.
struct FastDiv {
  unsigned d, m, s;
  __device__ explicit FastDiv(int d_) : d(static_cast<unsigned>(d_)), s(0) {
    while ((1u << s) < d) ++s;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) + n) >> s);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Two int8 bytes of w as an exact bf16x2 (sel 0x4140: bytes 0 and 1,
// 0x4342: bytes 2 and 3). With m the low 7 bits and s the sign bit of a byte b: the bf16
// 0x4300 | m is 128 + m and 0xC300 | s << 7 is -128 - 128 s, and their sum
// is b, exact (|b| <= 128 has 8 significant bits).
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, unsigned sel) {
  const uint32_t p = __byte_perm(w, 0x43434343u, sel);
  const uint32_t x = p & 0xFF7FFF7Fu;
  const uint32_t y = (p & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(x), "r"(0x3F803F80u), "r"(y));
  return d;
}

// s = q K^T of one staged bf16 block (rows of SROW elements), the B
// fragments by ldmatrix: x4 covers two k-steps, x2 an odd last one.
template <int HD>
__device__ __forceinline__ void qk_block(const WarpState<HD>& st,
                                         const __nv_bfloat16* Ks,
                                         float (&s)[kBlockN / 8][4]) {
  constexpr int SROW = HD + kPad;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = Ks + (nt * 8 + (lane & 7)) * SROW;
#pragma unroll
    for (int kt = 0; kt < HD / 16; kt += 2) {
      if (kt + 1 < HD / 16) {
        uint32_t b[4];
        ldmatrix_x4(b, kr + (kt + (lane >> 4)) * 16 + (lane & 8));
        mma_bf16(s[nt], st.q[kt], b[0], b[1]);
        mma_bf16(s[nt], st.q[kt + 1], b[2], b[3]);
      } else {
        uint32_t b[2];
        ldmatrix_x2(b, kr + kt * 16 + (lane & 8));
        mma_bf16(s[nt], st.q[kt], b[0], b[1]);
      }
    }
  }
}

// The online update of row h (gr, gr + 8) over one block of masked logits
// s: running max, correction, weights exp(s - m) (times vss[col] for the
// value product when given; l unscaled) left in s.
template <int HD>
__device__ __forceinline__ void update_row(WarpState<HD>& st,
                                           float (&s)[kBlockN / 8][4], int h,
                                           const float* vss) {
  const int tq = threadIdx.x & 3;
  float mx = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt)
    mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(st.m[h], mx);
  const float corr = expf(st.m[h] - m_new);
  float sum = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    const float p0 = expf(s[nt][2 * h] - m_new);
    const float p1 = expf(s[nt][2 * h + 1] - m_new);
    sum += p0;
    sum += p1;
    if (vss != nullptr) {
      const float2 vs2 =
          *reinterpret_cast<const float2*>(vss + nt * 8 + 2 * tq);
      s[nt][2 * h] = p0 * vs2.x;
      s[nt][2 * h + 1] = p1 * vs2.y;
    } else {
      s[nt][2 * h] = p0;
      s[nt][2 * h + 1] = p1;
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  st.l[h] = st.l[h] * corr + sum;
  st.m[h] = m_new;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    st.o[nt][2 * h] *= corr;
    st.o[nt][2 * h + 1] *= corr;
  }
}

// acc += P V over one staged bf16 block, P cast to bf16 as the A operand
// straight from registers, V's B fragments by ldmatrix.trans.
template <int HD>
__device__ __forceinline__ void pv_block(WarpState<HD>& st,
                                         const __nv_bfloat16* Vs,
                                         const float (&s)[kBlockN / 8][4]) {
  constexpr int SROW = HD + kPad;
  const int lane = threadIdx.x & 31;
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

// Blocks [b0, b1) of a bf16 arm, 64 keys each from key `lo` of k and v
// (key col at row col of `stride` elements; keys at or past `limit` are
// not read), through a ring of three cp.async stages, one barrier a block;
// `flush(j)` after the last block of piece j (pb blocks each, from lo).
// DECODE: the decode arm with the single walk's semantics (stream_arm's
// DECODE arm): logit s * scale + bias[col] where the row's sample owns the
// slot and col < hi, kNegInf elsewhere; the slot bias is staged with the
// block and the sample tests use a multiply-shift divider, so no mask step
// waits on device memory; a warp skips the blocks outside its samples'
// slots. A row's sample is row / pn, or with ROWV kRowSlot its slot rv0 /
// rv1 (-1: none). Else a bf16 context arm (the packed kernels' envelope,
// ROWV kRowCausal): logit s * scale for the keys below hi on the rows `on`
// names (bit 0: gr, bit 1: gr + 8) at pos0 + col <= rv0 / rv1, kNegInf
// elsewhere; a warp skips the blocks none of its rows sees.
template <int HD, bool DECODE, int ROWV, typename Flush>
__device__ __forceinline__ void stream_bf16_split(
    WarpState<HD>& st, unsigned char* smem_raw, const Params& p,
    const __nv_bfloat16* k, const __nv_bfloat16* v, int stride, int lo,
    int hi, int limit, int b0, int b1, int pb, int wrow0, unsigned on,
    int rv0, int rv1, int pos0, Flush flush) {
  static_assert(ROWV != kRowSlot || DECODE, "row slots key the decode arm");
  static_assert(ROWV != kRowCausal || !DECODE, "the decode arm is not causal");
  using R = Ring<HD>;
  constexpr int SROW = R::SROW;
  constexpr int CH = HD / 8;         // 16-byte chunks per bf16 row
  const int nblk = b1 - b0;
  if (nblk <= 0) return;
  const int col_begin = lo + b0 * kBlockN;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const FastDiv by_slot(DECODE ? p.c_d : 1);
  int sample[2] = {0, 0};
  int wcol_lo = 0, wcol_hi = limit;
  if constexpr (DECODE && ROWV == kRowSlot) {
    // the warp's slots: the least and the largest of its rows' (none: -1)
    sample[0] = rv0;
    sample[1] = rv1;
    const int lo_s = __reduce_min_sync(
        0xffffffffu, min(rv0 < 0 ? INT_MAX : rv0, rv1 < 0 ? INT_MAX : rv1));
    const int hi_s = __reduce_max_sync(0xffffffffu, max(rv0, rv1));
    wcol_lo = hi_s < 0 ? 0 : lo_s * p.c_d;
    wcol_hi = hi_s < 0 ? 0 : (hi_s + 1) * p.c_d;
  } else if constexpr (DECODE) {
    sample[0] = (wrow0 + gr) / p.pn;
    sample[1] = (wrow0 + gr + 8) / p.pn;
    wcol_lo = (wrow0 / p.pn) * p.c_d;
    wcol_hi = ((wrow0 + 15) / p.pn + 1) * p.c_d;
  } else if constexpr (ROWV == kRowCausal) {
    // past the last key a row of the warp sees, no row sees a key
    auto seen = [&](unsigned bit, int rv) {   // keys [0, seen) visible
      const long long n = static_cast<long long>(rv) - pos0 + 1;
      return (on & bit) ? static_cast<int>(n < 0 ? 0 : n < limit ? n : limit)
                        : 0;
    };
    wcol_hi = __reduce_max_sync(0xffffffffu, max(seen(1u, rv0), seen(2u, rv1)));
  }
  const bool warp_on = DECODE || __any_sync(0xffffffffu, on != 0u);

  auto stage = [&](int blk, int slot) {
    unsigned char* base = smem_raw + slot * R::DSTAGE;
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(base + R::CONV);
    const int col0 = col_begin + blk * kBlockN;
    for (int c = threadIdx.x; c < kBlockN * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      const bool ok = col0 + r < limit;
      const size_t off =
          ok ? static_cast<size_t>(col0 + r) * stride + ch * 8 : 0;
      cp_async16(sK + r * SROW + ch * 8, k + off, ok);
      cp_async16(sV + r * SROW + ch * 8, v + off, ok);
    }
    if constexpr (DECODE) {
      float* sBias = reinterpret_cast<float*>(base + 2 * R::CONV);
      for (int r = threadIdx.x; r < kBlockN; r += kThreads) {
        const bool ok = col0 + r < limit;
        cp_async4(sBias + r, p.dec_bias + (ok ? col0 + r : 0), ok);
      }
    }
  };

  stage(0, 0);
  cp_async_commit();
  if (nblk > 1) stage(1, 1);
  cp_async_commit();
  for (int blk = 0; blk < nblk; ++blk) {
    cp_async_wait_1();    // this thread's copies of block blk
    __syncthreads();      // everyone's; and block blk - 1 is done
    if (blk + 2 < nblk) stage(blk + 2, (blk + 2) % 3);
    cp_async_commit();
    const int col0 = col_begin + blk * kBlockN;
    // the piece of block b0 + blk ends here: its partials
    const bool piece_end = (b0 + blk + 1) % pb == 0 || blk + 1 == nblk;
    if (!warp_on || col0 >= wcol_hi || col0 + kBlockN <= wcol_lo) {
      if (piece_end) flush((b0 + blk) / pb);
      continue;
    }
    const unsigned char* base = smem_raw + (blk % 3) * R::DSTAGE;
    const float* sBias = reinterpret_cast<const float*>(base + 2 * R::CONV);
    float s[kBlockN / 8][4];
    qk_block<HD>(st, reinterpret_cast<const __nv_bfloat16*>(base), s);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;
        const int col = col0 + j;
        const int col_sample = DECODE ? by_slot.div(col) : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = s[nt][2 * h + e] * p.scale;
          bool valid = col < hi;
          if (DECODE && valid) {
            x += sBias[j];
            valid = sample[h] == col_sample;
          }
          if (!DECODE) valid = valid && ((on >> h) & 1u);
          if (ROWV == kRowCausal) valid = valid && pos0 + col <= (h ? rv1 : rv0);
          s[nt][2 * h + e] = valid ? x : kNegInf;
        }
      }
    }
    update_row<HD>(st, s, 0, nullptr);
    update_row<HD>(st, s, 1, nullptr);
    pv_block<HD>(st, reinterpret_cast<const __nv_bfloat16*>(base + R::CONV),
                 s);
    if (piece_end) flush((b0 + blk) / pb);
  }
}

// The node of a split walk's block i in the tile's list: first[k] <= i <
// first[k + 1] (i only grows).
struct NodeCursor {
  int k = 0;
  __device__ void seek(const int* first, int i) {
    while (first[k + 1] <= i) ++k;
  }
};

// Stream context blocks [i0, i1) of the tile's list (node k's blocks are
// [first[k], first[k + 1]), its live length lens[k]) through the two
// stages. Each thread converts exactly the 16-byte chunks it copied, so a
// block is converted as soon as this thread's copies landed, with no
// barrier of its own; the one barrier per block publishes the converted
// block and frees the stages. Iteration i: barrier; the products of block
// i; wait for this thread's copies of block i + 1; copies of block i + 2
// into block i's int8 stage (paged: each key's page id read from its
// node's table, the page divided out by multiply and shift); conversion
// of block i + 1. `flush(k, j, on)` after the last block of node k's piece
// j (pb blocks each; `on`: which of this thread's two rows are on node k).
template <int HD, bool PAGES, typename Flush>
__device__ __forceinline__ void stream_split(
    WarpState<HD>& st, unsigned char* smem_raw, const Params& p, int gi,
    const int* s_ids, const int* s_lens, const int* s_first,
    const int* s_path, int i0, int i1, int la, int lb, int pb, Flush flush) {
  using R = Ring<HD>;
  constexpr int SROW = R::SROW;
  constexpr int CHUNKS = R::CHUNKS;
  const int tq = threadIdx.x & 3;
  const int8_t* kq = static_cast<const int8_t*>(p.k_ctx);
  const int8_t* vq = static_cast<const int8_t*>(p.v_ctx);
  unsigned char* conv = smem_raw;
  unsigned char* raw = smem_raw + 2 * R::CSTAGE;

  NodeCursor stage_at, comp_at;
  const FastDiv by_page(PAGES ? p.page_m : 1);

  auto stage = [&](int i, int slot) {
    stage_at.seek(s_first, i);
    const int k = stage_at.k;
    const int node = s_ids[k], len = s_lens[k];
    const int col0 = (i - s_first[k]) * kBlockN;
    unsigned char* base = raw + slot * R::QSTAGE;
    int8_t* sK = reinterpret_cast<int8_t*>(base);
    int8_t* sV = sK + kBlockN * HD;
    float* sKs = reinterpret_cast<float*>(sV + kBlockN * HD);
    float* sVs = sKs + kBlockN;
    int* sOk = reinterpret_cast<int*>(sVs + kBlockN);
    const long long slab = (static_cast<long long>(node) * p.g + gi) * p.m_c;
    const int* prow = PAGES ? p.page_tables + static_cast<size_t>(node) * p.ppn
                            : nullptr;
#pragma unroll
    for (int t = 0; t < R::PER_THREAD; ++t) {
      const int c = threadIdx.x + kThreads * t;
      if (c >= kBlockN * CHUNKS) break;
      const int r = c / CHUNKS, ch = c % CHUNKS;
      const int col = col0 + r;
      long long kr = -1;   // the key's row in the slab or pool; -1: not read
      if constexpr (PAGES) {
        // the page id of the key: a hole (-1) or an id outside [0, P) is
        // not read; pool rows stay below 2^31 (the wrapper checks P g pm)
        const int q = by_page.div(col);
        const int pid = col < len ? prow[q] : -1;
        if (pid >= 0 && pid < p.n_pages)
          kr = (pid * p.g + gi) * p.page_m + col - q * p.page_m;
      } else {
        if (col < len) kr = slab + col;
      }
      const bool ok = kr >= 0;
      const size_t row = ok ? static_cast<size_t>(kr) : 0;
      cp_async16(sK + r * HD + ch * 16, kq + row * HD + ch * 16, ok);
      cp_async16(sV + r * HD + ch * 16, vq + row * HD + ch * 16, ok);
      if (ch == 0) {
        cp_async4(sKs + r, p.k_scale + row, ok);
        cp_async4(sVs + r, p.v_scale + row, ok);
        sOk[r] = ok;
      }
    }
  };
  // this thread's chunks of the int8 stage `from` into converted stage `to`
  auto convert = [&](int from, int to) {
    const unsigned char* qb = raw + from * R::QSTAGE;
    unsigned char* cb = conv + to * R::CSTAGE;
#pragma unroll
    for (int t = 0; t < R::PER_THREAD; ++t) {
      const int c = threadIdx.x + kThreads * t;
      if (c >= kBlockN * CHUNKS) break;
      const int r = c / CHUNKS, ch = c % CHUNKS;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const int4 w = *reinterpret_cast<const int4*>(
            qb + kv * kBlockN * HD + r * HD + ch * 16);
        const uint32_t ws[4] = {static_cast<uint32_t>(w.x),
                                static_cast<uint32_t>(w.y),
                                static_cast<uint32_t>(w.z),
                                static_cast<uint32_t>(w.w)};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[2 * j] = i8x2_bf16(ws[j], 0x4140);
          o[2 * j + 1] = i8x2_bf16(ws[j], 0x4342);
        }
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
                                 cb + kv * R::CONV) + r * SROW + ch * 16;
        *reinterpret_cast<int4*>(dst) = make_int4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<int4*>(dst + 8) = make_int4(o[4], o[5], o[6], o[7]);
      }
      if (ch == 0) {
        const float* qs = reinterpret_cast<const float*>(
            qb + 2 * kBlockN * HD);
        float* cs = reinterpret_cast<float*>(cb + 2 * R::CONV);
        cs[r] = qs[r];
        cs[kBlockN + r] = qs[kBlockN + r];
        reinterpret_cast<int*>(cs + 2 * kBlockN)[r] =
            reinterpret_cast<const int*>(qs + 2 * kBlockN)[r];
      }
    }
  };

  if (i0 >= i1) return;
  for (int t = 0; t < kQStages; ++t) {
    if (i0 + t < i1) stage(i0 + t, t);
    cp_async_commit();
  }
  cp_async_wait<kQStages - 1>();      // this thread's copies of block i0
  convert(0, 0);
  int kc = -1;
  unsigned on = 0u;
  bool warp_on = false;
  for (int i = i0; i < i1; ++i) {
    const int cur = (i - i0) & 1;
    __syncthreads();      // block i converted; block i - 1's stages free
    comp_at.seek(s_first, i);
    if (comp_at.k != kc) {    // a new node: which of this thread's rows are on
      kc = comp_at.k;
      on = rows_on(s_path, p.depth, la, lb, s_ids[kc]);
      warp_on = __any_sync(0xffffffffu, on != 0u);
    }
    if (warp_on) {
      const unsigned char* cb = conv + cur * R::CSTAGE;
      const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(cb);
      const __nv_bfloat16* Vs =
          reinterpret_cast<const __nv_bfloat16*>(cb + R::CONV);
      const float* kss = reinterpret_cast<const float*>(cb + 2 * R::CONV);
      const float* vss = kss + kBlockN;
      const int* sOk = reinterpret_cast<const int*>(vss + kBlockN);

      float s[kBlockN / 8][4];
      qk_block<HD>(st, Ks, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool row_on = (on >> h) & 1u;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
          const int j = nt * 8 + 2 * tq;
          const float2 ks2 = *reinterpret_cast<const float2*>(kss + j);
          const int2 ok2 = *reinterpret_cast<const int2*>(sOk + j);
          const float x0 = s[nt][2 * h] * ks2.x, x1 = s[nt][2 * h + 1] * ks2.y;
          s[nt][2 * h] = row_on && ok2.x ? x0 : kNegInf;
          s[nt][2 * h + 1] = row_on && ok2.y ? x1 : kNegInf;
        }
        update_row<HD>(st, s, h, vss);
      }
      pv_block<HD>(st, Vs, s);
    }
    // the piece of node kc's block i ends here: its partials
    const int b = i - s_first[kc];
    if ((b + 1) % pb == 0 || i + 1 == s_first[kc + 1]) flush(kc, b / pb, on);
    if (i + 1 < i1) {
      cp_async_wait<kQStages - 2>();     // this thread's copies of block i + 1
      if (i + kQStages < i1) stage(i + kQStages, (i - i0) % kQStages);
      cp_async_commit();
      convert((i + 1 - i0) % kQStages, cur ^ 1);
    }
  }
}

// The bf16 twin of stream_split: context blocks [i0, i1) of the tile's
// node list through the three bf16 cp.async stages of stream_bf16_split,
// one barrier a block and nothing to convert. Key col of node k, kv head
// gi, lies at slab row (node * g + gi) * m_c + col, or PAGES at its pool
// row, the page id read from the node's table as the block is staged and
// the page divided out by multiply and shift; a key at or past the node's
// length, on a hole (-1) or on an id outside [0, P) is not read, and each
// stage carries its keys' flags where the decode arm stages its slot
// bias. The logits are stream_bf16_split's: s * scale on the rows on the
// block's node (the path table's `on` bits) for the keys that were read,
// kNegInf elsewhere, then update_row and pv_block; a warp none of whose
// rows is on the node skips the products. kSingle is the one-node case
// (#1, #2), so #8 on a single prefix computes #1's bits. `flush(k, j, on)`
// after the last block of node k's piece j (pb blocks each).
template <int HD, bool PAGES, typename Flush>
__device__ __forceinline__ void stream_bf16_nodes(
    WarpState<HD>& st, unsigned char* smem_raw, const Params& p, int gi,
    const int* s_ids, const int* s_lens, const int* s_first,
    const int* s_path, int i0, int i1, int la, int lb, int pb, Flush flush) {
  using R = Ring<HD>;
  constexpr int SROW = R::SROW;
  constexpr int CH = HD / 8;         // 16-byte chunks per bf16 row
  const int tq = threadIdx.x & 3;
  const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(p.k_ctx);
  const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(p.v_ctx);
  NodeCursor stage_at, comp_at;
  const FastDiv by_page(PAGES ? p.page_m : 1);

  auto stage = [&](int i, int slot) {
    stage_at.seek(s_first, i);
    const int k = stage_at.k;
    const int node = s_ids[k], len = s_lens[k];
    const int col0 = (i - s_first[k]) * kBlockN;
    unsigned char* base = smem_raw + slot * R::DSTAGE;
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(base + R::CONV);
    int* sOk = reinterpret_cast<int*>(base + 2 * R::CONV);
    const long long slab = (static_cast<long long>(node) * p.g + gi) * p.m_c;
    const int* prow = PAGES ? p.page_tables + static_cast<size_t>(node) * p.ppn
                            : nullptr;
    for (int c = threadIdx.x; c < kBlockN * CH; c += kThreads) {
      const int r = c / CH, ch = c % CH;
      const int col = col0 + r;
      long long kr = -1;   // the key's row in the slab or pool; -1: not read
      if constexpr (PAGES) {
        const int q = by_page.div(col);
        const int pid = col < len ? prow[q] : -1;
        if (pid >= 0 && pid < p.n_pages)
          kr = (pid * p.g + gi) * p.page_m + col - q * p.page_m;
      } else {
        if (col < len) kr = slab + col;
      }
      const bool ok = kr >= 0;
      const size_t off = ok ? static_cast<size_t>(kr) * HD + ch * 8 : 0;
      cp_async16(sK + r * SROW + ch * 8, kc + off, ok);
      cp_async16(sV + r * SROW + ch * 8, vc + off, ok);
      if (ch == 0) sOk[r] = ok;
    }
  };

  if (i0 >= i1) return;
  stage(i0, 0);
  cp_async_commit();
  if (i0 + 1 < i1) stage(i0 + 1, 1);
  cp_async_commit();
  int kn = -1;
  unsigned on = 0u;
  bool warp_on = false;
  for (int i = i0; i < i1; ++i) {
    const int blk = i - i0;
    cp_async_wait_1();    // this thread's copies of block i
    __syncthreads();      // everyone's (and their flags); block i - 1 is done
    if (i + 2 < i1) stage(i + 2, (blk + 2) % 3);
    cp_async_commit();
    comp_at.seek(s_first, i);
    if (comp_at.k != kn) {    // a new node: which of this thread's rows are on
      kn = comp_at.k;
      on = rows_on(s_path, p.depth, la, lb, s_ids[kn]);
      warp_on = __any_sync(0xffffffffu, on != 0u);
    }
    if (warp_on) {
      const unsigned char* base = smem_raw + (blk % 3) * R::DSTAGE;
      const int* sOk = reinterpret_cast<const int*>(base + 2 * R::CONV);
      float s[kBlockN / 8][4];
      qk_block<HD>(st, reinterpret_cast<const __nv_bfloat16*>(base), s);
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const int2 ok2 = *reinterpret_cast<const int2*>(sOk + nt * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = e ? ok2.y : ok2.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = s[nt][2 * h + e] * p.scale;
            s[nt][2 * h + e] = ok && ((on >> h) & 1u) ? x : kNegInf;
          }
        }
      }
      update_row<HD>(st, s, 0, nullptr);
      update_row<HD>(st, s, 1, nullptr);
      pv_block<HD>(st, reinterpret_cast<const __nv_bfloat16*>(base + R::CONV),
                   s);
    }
    // the piece of node kn's block i ends here: its partials
    const int b = i - s_first[kn];
    if ((b + 1) % pb == 0 || i + 1 == s_first[kn + 1]) flush(kn, b / pb, on);
  }
}

// The first slot of (kv head gi, row) in a split walk's scratch: each kv
// head's first n_dec rows hold max_pieces slots each, its other rows (the
// packed kernels' chunk rows) max_pieces_chunk each; launch_split sets
// n_dec = rows in the other modes.
__host__ __device__ __forceinline__ size_t slot_plane(const Params& p) {
  return static_cast<size_t>(p.n_dec) * p.max_pieces +
         static_cast<size_t>(p.rows - p.n_dec) * p.max_pieces_chunk;
}

__device__ __forceinline__ size_t slot_base(const Params& p, int gi,
                                            int row) {
  const size_t first =
      row < p.n_dec ? static_cast<size_t>(row) * p.max_pieces
                    : static_cast<size_t>(p.n_dec) * p.max_pieces +
                          static_cast<size_t>(row - p.n_dec) *
                              p.max_pieces_chunk;
  return gi * slot_plane(p) + first;
}

// The pieces of a row, in its merge order: for each distinct node on its
// path, ascending, the node's pieces (pb blocks each, from the node's
// first key; PACKED: the pseudo-segment N, the envelope's env_pieces,
// after every real node), then the decode pieces that hold slots of its
// sample (row / pn; PACKED: row_slot[row], -1 for none) inside the tile's
// decode window [dec_lo, dec_hi). Thread r < kRowTile fills row r's
// entries: the slot of the first piece of the node at each path level
// (s_rbase, -1 for none), the slot of decode piece 0 (s_rdec; a decode
// piece jd is the row's iff s_rdlo <= jd < s_rdhi) and the row's piece
// count (s_rcnt).
template <bool PACKED>
__device__ __forceinline__ void row_pieces(
    const Params& p, int row0, int row_hi, int dec_lo, int dec_hi, int pb,
    int env_pieces, const int* s_path, const int* s_ids, const int* s_lens,
    int n_list, int* s_rbase, int* s_rdec, int* s_rdlo, int* s_rdhi,
    int* s_rcnt) {
  const int r = threadIdx.x;
  if (r >= kRowTile) return;
  const int row = row0 + r;
  // the pieces of node id (found in the tile's sorted list)
  auto pieces = [&](int id) {
    if (PACKED && id == p.n_groups) return env_pieces;
    int lo = 0, hi = n_list - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s_ids[mid] < id) lo = mid + 1; else hi = mid;
    }
    const int nb = (s_lens[lo] + kBlockN - 1) / kBlockN;
    return (nb + pb - 1) / pb;
  };
  unsigned firsts = 0u;    // the levels that first hold their (valid) id
  for (int lvl = 0; lvl < p.depth; ++lvl) {
    const int id = s_path[lvl * kRowTile + r];
    bool first = id >= 0;
    for (int l = 0; l < lvl && first; ++l)
      first = s_path[l * kRowTile + r] != id;
    firsts |= first ? 1u << lvl : 0u;
  }
  int total = 0;
  for (int lvl = 0; lvl < p.depth; ++lvl) {
    const int id = s_path[lvl * kRowTile + r];
    int base = -1;
    if (id >= 0) {    // the pieces of the row's distinct nodes below id
      base = 0;
      for (int l2 = 0; l2 < p.depth; ++l2) {
        const int id2 = s_path[l2 * kRowTile + r];
        if (((firsts >> l2) & 1u) && id2 < id) base += pieces(id2);
      }
      if ((firsts >> lvl) & 1u) total += pieces(id);
    }
    s_rbase[lvl * kRowTile + r] = base;
  }
  // decode pieces: the blocks (from dec_lo) holding the sample's slots
  int dlo = 0, dhi = 0;
  if (row < row_hi && dec_hi > dec_lo) {
    const int smp = PACKED ? p.row_slot[row] : row / p.pn;
    if (smp >= 0 && smp < p.ld / p.c_d) {
      const int c0 = max(smp * p.c_d, dec_lo) - dec_lo;
      const int c1 = min((smp + 1) * p.c_d, dec_hi) - dec_lo;
      if (c1 > c0) {
        dlo = c0 / kBlockN / pb;
        dhi = ((c1 + kBlockN - 1) / kBlockN + pb - 1) / pb;
      }
    }
  }
  s_rdec[r] = total - dlo;
  s_rdlo[r] = dlo;
  s_rdhi[r] = dhi;
  s_rcnt[r] = total + dhi - dlo;
}

// One CTA per (row tile, kv head, share s of S). The tile's work is cut
// into pieces: each node's blocks in runs of pb (kPieceBlocks) from its
// first key, then the decode arm's blocks likewise from the tile's first
// slot. A piece's bounds depend on its own node's length alone, so a row's
// keys fall into the same pieces whatever other requests hold; each piece
// is summed from a fresh state and its rows' fp32 partial (acc, m, l) goes
// to the row's own slot for it, so a row's bits never depend on another
// request, on S or on the page size. The CTAs take consecutive runs of
// pieces, weighted kCtxWeight (Q8) or kCtxWeightBf16 per context block and
// 1 per decode block, the heaviest run as light as S runs allow: one
// contiguous run of context blocks and one of decode blocks each. Share 0
// also runs the path and page checks and writes each row's piece count, -1
// for a poisoned row. kSingle: the one context is node 0 of m_c keys, on
// every row's path (the path table is made in shared memory, not read),
// so its blocks stream as a node's do: #3 computes #9's bits (stream_split)
// and #1 #8's (stream_bf16_nodes; #2 is #1 with no decode arm, ld 0).
// kGrouped (#4 / #5): kTree at depth 1, the path table row_group itself;
// an id of -1 is out of range there (a NaN row, as the single walk
// writes), so on the rows of ids in [0, G) #5 computes #7's bits (int8
// segments, stream_split) and #4 #6's (bf16, stream_bf16_nodes).
// kPacked (#10 / #11): the tiles of the n_dec decode rows come first, then
// those of the chunk rows from row n_dec, so no tile mixes the two; a
// decode tile is #8's / #9's (its pieces, its S = splits: their bits), its
// rows' decode slots keyed by row_slot; a chunk tile takes S = splits_chunk
// shares and
// pieces of kChunkPieceBlocks blocks, and has no decode arm. After the
// real nodes, if a row of the tile holds the pseudo-segment N and
// fresh_len > 0, the envelope: keys [0, fresh_len) of the dense (F * pm,
// g, HD) bf16 slab (key col of kv head gi at row col * g + gi), in the
// tile's pieces, a row seeing key col only if its path holds N and
// fresh_start + col <= row_pos[row] (the single walk's fresh arm).
template <int HD, int MODE, bool Q8>
__global__ void __launch_bounds__(kThreads) split_kernel(const Params p) {
  constexpr bool GROUPED = MODE == kGrouped;
  constexpr bool PACKED = MODE == kPacked;
  constexpr bool PAGES = MODE == kPaged || PACKED;
  constexpr bool SINGLE = MODE == kSingle;
  constexpr int kW = Q8 ? kCtxWeight : kCtxWeightBf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_count, s_fresh;
  const int gi = blockIdx.y, split = blockIdx.z;
  // the tile: kPacked's chunk tiles follow its decode tiles
  const int n_first = PACKED ? p.n_dec : p.rows;
  const int t_first = (n_first + kRowTile - 1) / kRowTile;
  const bool chunk = PACKED && static_cast<int>(blockIdx.x) >= t_first;
  const int splits = chunk ? p.splits_chunk : p.splits;
  if (split >= splits) return;    // the grid has max(S, S_chunk) shares
  const int row0 = chunk ? n_first + (blockIdx.x - t_first) * kRowTile
                         : blockIdx.x * kRowTile;
  const int row_hi = min(row0 + kRowTile, chunk ? p.rows : n_first);
  const int pb = chunk ? kChunkPieceBlocks : kPieceBlocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + gr, rb = ra + 8;
  const int la = ra - row0, lb = rb - row0;
  const int rows = p.rows;
  const int list_cap = p.depth * kRowTile;   // distinct ids of a tile
  unsigned* s_bad = reinterpret_cast<unsigned*>(smem_raw + Ring<HD>::PLAN);
  int* s_path = reinterpret_cast<int*>(s_bad + 2);
  unsigned* s_nodes = reinterpret_cast<unsigned*>(s_path + list_cap);
  const int node_words = (p.n_groups + 31) / 32;
  int* s_ids = reinterpret_cast<int*>(s_nodes + node_words);
  int* s_lens = s_ids + list_cap;
  int* s_first = s_lens + list_cap;          // list_cap + 1 entries
  int* s_rbase = s_first + list_cap + 1;     // list_cap entries
  int* s_rdec = s_rbase + list_cap;          // kRowTile entries each
  int* s_rdlo = s_rdec + kRowTile;
  int* s_rdhi = s_rdlo + kRowTile;
  int* s_rcnt = s_rdhi + kRowTile;

  // the query fragments first: their loads fly while the paths are read
  WarpState<HD> st;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            static_cast<size_t>(gi) * rows * HD;
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) {
    const int c = kt * 16 + 2 * tq;
    st.q[kt][0] = load_pair(qg + static_cast<size_t>(ra) * HD + c, ra < row_hi);
    st.q[kt][1] = load_pair(qg + static_cast<size_t>(rb) * HD + c, rb < row_hi);
    st.q[kt][2] = load_pair(qg + static_cast<size_t>(ra) * HD + c + 8, ra < row_hi);
    st.q[kt][3] = load_pair(qg + static_cast<size_t>(rb) * HD + c + 8, rb < row_hi);
  }
  auto reset = [&]() {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      st.o[nt][0] = st.o[nt][1] = st.o[nt][2] = st.o[nt][3] = 0.f;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
  };
  reset();

  for (int w = threadIdx.x; w < node_words; w += kThreads) s_nodes[w] = 0u;
  if (threadIdx.x < 2) s_bad[threadIdx.x] = 0u;
  if (threadIdx.x == 0) s_fresh = 0;
  __syncthreads();
  // the ids a path may hold: from -1 (grouped: 0) to N - 1, or packed the
  // pseudo id N
  const int min_id = GROUPED ? 0 : -1;
  const int max_id = PACKED ? p.n_groups : p.n_groups - 1;
  for (int e = threadIdx.x; e < list_cap; e += kThreads) {
    const int r = e % kRowTile, row = row0 + r;
    int id = -1;
    bool bad = false;
    if (row < row_hi) {
      id = SINGLE ? 0 : p.paths[(e / kRowTile) * rows + row];
      bad = id < min_id || id > max_id;
    }
    if (bad) {
      atomicOr(&s_bad[r >> 5], 1u << (r & 31));
      id = -1;
    }
    s_path[e] = id;
    if (id >= 0 && id < p.n_groups)
      atomicOr(&s_nodes[id >> 5], 1u << (id & 31));
    else if (PACKED && id == p.n_groups)
      s_fresh = 1;
  }
  __syncthreads();
  // the node list in ascending id, then each node's live length and first
  // block (the lengths read in parallel)
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < node_words; ++w)
      for (unsigned bits = s_nodes[w]; bits; bits &= bits - 1u)
        s_ids[n++] = w * 32 + __ffs(bits) - 1;
    s_count = n;
  }
  __syncthreads();
  const int n_list = s_count;
  for (int k = threadIdx.x; k < n_list; k += kThreads) {
    const int len = SINGLE ? p.m_c : min(max(p.ctx_lens[s_ids[k]], 0), p.m_c);
    s_lens[k] = len;
    s_first[k + 1] = (len + kBlockN - 1) / kBlockN;
  }
  __syncthreads();
  // the decode window (none for a chunk tile) and the envelope's blocks
  const int dec_lo = (row0 / p.pn) * p.c_d;
  const int dec_hi = chunk ? dec_lo : min(p.ld, ((row_hi - 1) / p.pn + 1) * p.c_d);
  const int E = PACKED && s_fresh && p.fresh_len > 0
                    ? (p.fresh_len + kBlockN - 1) / kBlockN : 0;
  if (threadIdx.x == 0) {
    s_first[0] = 0;
    for (int k = 0; k < n_list; ++k) s_first[k + 1] += s_first[k];
  }
  row_pieces<PACKED>(p, row0, row_hi, dec_lo, dec_hi, pb, (E + pb - 1) / pb,
                     s_path, s_ids, s_lens, n_list, s_rbase, s_rdec, s_rdlo,
                     s_rdhi, s_rcnt);
  __syncthreads();
  if (PAGES && split == 0) {
    // a segment whose live pages name an id outside [-1, P) poisons the
    // rows on it; one warp per segment of the list
    for (int k = warp; k < n_list; k += kWarps) {
      const int seg = s_ids[k], len = s_lens[k];
      const int* row = p.page_tables + static_cast<size_t>(seg) * p.ppn;
      bool poison = false;
      for (int j = lane; j * p.page_m < len; j += 32)
        poison |= row[j] < -1 || row[j] >= p.n_pages;
      if (__any_sync(0xffffffffu, poison)) {
        for (int e = lane; e < list_cap; e += 32) {
          if (s_path[e] == seg) {
            const int r = e % kRowTile;
            atomicOr(&s_bad[r >> 5], 1u << (r & 31));
          }
        }
      }
    }
    __syncthreads();
  }

  // where the partials go: each row's slots (slot_base), acc then (m, l)
  const size_t n_slots = p.g * slot_plane(p);
  float* acc = p.part;
  float* ml = p.part + n_slots * HD;
  int* cnt = reinterpret_cast<int*>(ml + n_slots * 2);
  if (split == 0 && threadIdx.x < kRowTile && row0 + threadIdx.x < row_hi) {
    const int r = threadIdx.x;
    cnt[static_cast<size_t>(gi) * rows + row0 + r] =
        ((s_bad[r >> 5] >> (r & 31)) & 1u) ? -1 : s_rcnt[r];
  }
  auto write_partial = [&](int h, int slot) {
    const size_t at = slot_base(p, gi, h ? rb : ra) + slot;
    float* o = acc + at * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<float2*>(o + nt * 8 + 2 * tq) =
          make_float2(st.o[nt][2 * h], st.o[nt][2 * h + 1]);
    if (tq == 0)
      *reinterpret_cast<float2*>(ml + 2 * at) = make_float2(st.m[h], st.l[h]);
  };
  // a piece of node `node` (kPacked: N, the envelope) ends: the rows on
  // the node write their partial
  auto node_flush = [&](int node, int j, unsigned on) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((on >> h) & 1u)) continue;
      const int lr = h ? lb : la;
      int base = -1;
      for (int lvl = 0; lvl < p.depth && base < 0; ++lvl)
        if (s_path[lvl * kRowTile + lr] == node)
          base = s_rbase[lvl * kRowTile + lr];
      write_partial(h, base + j);
    }
    reset();
  };
  auto ctx_flush = [&](int k, int j, unsigned on) {
    node_flush(s_ids[k], j, on);
  };
  // a decode piece ends: the rows whose sample has slots in it
  auto dec_flush = [&](int jd) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = h ? lb : la;
      if ((h ? rb : ra) < row_hi && jd >= s_rdlo[lr] && jd < s_rdhi[lr])
        write_partial(h, s_rdec[lr] + jd);
    }
    reset();
  };

  // this CTA's pieces: the S CTAs take consecutive runs of the tile's
  // pieces, each run at most `cap` in weight, with the least cap for which
  // S runs hold them all (a greedy packing checks a cap; 128 caps are
  // checked at once, one per thread, in two rounds)
  constexpr int kWe = kCtxWeightBf16;      // an envelope block's weight
  const int C = s_first[n_list];
  const int D = dec_hi > dec_lo ? (dec_hi - dec_lo + kBlockN - 1) / kBlockN : 0;
  auto walk = [&](auto&& f) {   // (weight, arm: 0 context 1 envelope 2 decode, first block)
    for (int k = 0; k < n_list; ++k)
      for (int b = s_first[k]; b < s_first[k + 1]; b += pb)
        f(kW * min(pb, s_first[k + 1] - b), 0, b);
    for (int b = 0; b < E; b += pb) f(kWe * min(pb, E - b), 1, b);
    for (int b = 0; b < D; b += pb) f(min(pb, D - b), 2, b);
  };
  auto runs = [&](int cap) {
    int n = 0, cur = cap;
    walk([&](int w, int, int) {
      if (cur + w > cap) { ++n; cur = w; } else { cur += w; }
    });
    return n;
  };
  const int U = kW * C + kWe * E + D;
  const int w_max = max(max(C > 0 ? kW * min(pb, C) : 0, kWe * min(pb, E)),
                        min(pb, D));
  const int cap0 = max(w_max, (U + splits - 1) / splits);
  if (threadIdx.x == 0) s_count = max(U, 1);
  __syncthreads();
  const int step = max(1, (U - cap0 + kThreads - 2) / (kThreads - 1));
  if (U > 0 && runs(cap0 + threadIdx.x * step) <= splits)
    atomicMin(&s_count, cap0 + threadIdx.x * step);
  __syncthreads();
  const int coarse = s_count;
  const int fine = max(cap0, coarse - step + 1) + threadIdx.x;
  if (step > 1 && fine < coarse && runs(fine) <= splits)
    atomicMin(&s_count, fine);
  __syncthreads();
  const int cap = s_count;
  int i0 = C, i1 = C, e0 = E, e1 = E, b0 = D, b1 = D;
  {
    int n = 0, cur = cap;
    walk([&](int w, int arm, int b) {
      if (cur + w > cap) { ++n; cur = w; } else { cur += w; }
      if (n - 1 != split) return;
      if (arm == 0) {
        i0 = min(i0, b);
        i1 = b + w / kW;
      } else if (arm == 1) {
        e0 = min(e0, b);
        e1 = b + w / kWe;
      } else {
        b0 = min(b0, b);
        b1 = b + w;
      }
    });
    if (i0 == C) i1 = C;
    if (e0 == E) e1 = E;
    if (b0 == D) b1 = D;
  }

  if constexpr (Q8)
    stream_split<HD, PAGES>(st, smem_raw, p, gi, s_ids, s_lens, s_first,
                            s_path, i0, i1, la, lb, pb, ctx_flush);
  else
    stream_bf16_nodes<HD, PAGES>(st, smem_raw, p, gi, s_ids, s_lens, s_first,
                                 s_path, i0, i1, la, lb, pb, ctx_flush);
  if constexpr (PACKED) {
    if (e1 > e0) {
      __syncthreads();    // the context stages are read no more
      // which of this thread's rows hold N
      const unsigned on = rows_on(s_path, p.depth, la, lb, p.n_groups);
      const size_t off = static_cast<size_t>(gi) * HD;
      stream_bf16_split<HD, false, kRowCausal>(
          st, smem_raw, p, static_cast<const __nv_bfloat16*>(p.k_fresh) + off,
          static_cast<const __nv_bfloat16*>(p.v_fresh) + off, p.g * HD, 0,
          p.fresh_len, p.fresh_len, e0, e1, pb, wrow0, on,
          ra < row_hi ? p.row_pos[ra] : -1, rb < row_hi ? p.row_pos[rb] : -1,
          p.fresh_start,
          [&](int j) { node_flush(p.n_groups, j, on); });
    }
  }
  if (b1 > b0) {
    __syncthreads();    // the context (envelope) stages are read no more
    const size_t off = static_cast<size_t>(gi) * p.ld * HD;
    const __nv_bfloat16* kd =
        static_cast<const __nv_bfloat16*>(p.k_dec) + off;
    const __nv_bfloat16* vd =
        static_cast<const __nv_bfloat16*>(p.v_dec) + off;
    if constexpr (PACKED) {
      // each row's slot, -1 for none or one outside the arm
      const int n_smp = p.ld / p.c_d;
      int sa = ra < row_hi ? p.row_slot[ra] : -1;
      int sb = rb < row_hi ? p.row_slot[rb] : -1;
      sa = sa < n_smp ? sa : -1;
      sb = sb < n_smp ? sb : -1;
      stream_bf16_split<HD, true, kRowSlot>(
          st, smem_raw, p, kd, vd, HD, dec_lo, dec_hi, p.ld, b0, b1, pb,
          wrow0, 3u, sa, sb, 0, dec_flush);
    } else {
      stream_bf16_split<HD, true, kRowNone>(
          st, smem_raw, p, kd, vd, HD, dec_lo, dec_hi, p.ld, b0, b1, pb,
          wrow0, 3u, 0, 0, 0, dec_flush);
    }
  }
}

// The exact merge of a split walk's partials: one warp per (kv head, row),
// over the row's pieces in its merge order. Lane t reads piece t's (m, l)
// (32 a pass) and the warp takes the max m; then the pieces are summed in
// order, each lane over 4 head dims: w = exp(m_piece - m), l = sum l w,
// acc = sum acc w, all loads predicated so that several pieces fly at
// once. FUSED: out = acc / max(l, 1e-30) in bf16, NaN for a poisoned row;
// else (#2) the unnormalised fp32 acc, m and l.
template <int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads) merge_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(p.g) * p.rows;
  const size_t gr_row =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gr_row >= plane) return;    // uniform per warp
  const size_t n_slots = p.g * slot_plane(p);
  const size_t base = slot_base(p, static_cast<int>(gr_row / p.rows),
                                static_cast<int>(gr_row % p.rows));
  const float* acc = p.part + base * HD;
  const float* ml = p.part + n_slots * HD + base * 2;
  const int n = reinterpret_cast<const int*>(p.part + n_slots * (HD + 2))[gr_row];
  const int d0 = 4 * lane;
  if (n < 0) {
    if (FUSED && d0 < HD) {
      const uint32_t q_nan = 0x7fc07fc0u;
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) +
                                gr_row * HD + d0) = make_uint2(q_nan, q_nan);
    } else if (!FUSED) {
      const float f_nan = __int_as_float(0x7fc00000);
      if (d0 < HD)
        *reinterpret_cast<float4*>(p.acc + gr_row * HD + d0) =
            make_float4(f_nan, f_nan, f_nan, f_nan);
      if (lane == 0) p.m[gr_row] = p.l[gr_row] = f_nan;
    }
    return;
  }
  float m = kNegInf;
  for (int t = lane; t < n; t += 32) m = fmaxf(m, ml[2 * t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const bool has_d = d0 < HD;
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = 0; t0 < n; t0 += 32) {
    float w_lane = 0.f, l_lane = 0.f;
    if (t0 + lane < n) {
      const float2 ms = *reinterpret_cast<const float2*>(ml + 2 * (t0 + lane));
      w_lane = expf(ms.x - m);
      l_lane = ms.y;
    }
    const int cnt = n - t0 < 32 ? n - t0 : 32;
    for (int j0 = 0; j0 < cnt; j0 += 16) {
      // 16 pieces' loads in flight, then their sums in order
      float4 x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has_d && j0 + j < cnt)
          x[j] = *reinterpret_cast<const float4*>(acc + (t0 + j0 + j) * HD + d0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float w = __shfl_sync(0xffffffffu, w_lane, j0 + j);
        if (j0 + j < cnt) {
          l += __shfl_sync(0xffffffffu, l_lane, j0 + j) * w;
          a.x += x[j].x * w;
          a.y += x[j].y * w;
          a.z += x[j].z * w;
          a.w += x[j].w * w;
        }
      }
    }
  }
  if constexpr (FUSED) {
    if (!has_d) return;
    const float inv = 1.f / fmaxf(l, kMinL);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) +
                              gr_row * HD + d0) = make_uint2(
        pack_bf16(a.x * inv, a.y * inv), pack_bf16(a.z * inv, a.w * inv));
  } else {
    if (has_d) *reinterpret_cast<float4*>(p.acc + gr_row * HD + d0) = a;
    if (lane == 0) {
      p.m[gr_row] = m;
      p.l[gr_row] = l;
    }
  }
}

// The grid's row tiles: kPacked's decode rows' tiles, then its chunk
// rows' (split_kernel).
inline int split_tiles(const Params& a, bool packed) {
  const int first = packed ? a.n_dec : a.rows;
  return (first + kRowTile - 1) / kRowTile +
         (a.rows - first + kRowTile - 1) / kRowTile;
}

template <int HD, int MODE, bool Q8, bool FUSED>
cudaError_t launch_split(const Params& in, cudaStream_t stream) {
  Params a = in;
  if (MODE != kPacked) {    // one kind of row
    a.n_dec = a.rows;
    a.splits_chunk = a.splits;
    a.max_pieces_chunk = a.max_pieces;
  }
  const int list_cap = a.depth * kRowTile;
  const int smem = Ring<HD>::PLAN +
                   4 * (2 + list_cap + (a.n_groups + 31) / 32 +
                        4 * list_cap + 1 + 4 * kRowTile);
  auto kern = split_kernel<HD, MODE, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(split_tiles(a, MODE == kPacked), a.g,
            a.splits > a.splits_chunk ? a.splits : a.splits_chunk);
  kern<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps = static_cast<long long>(a.g) * a.rows;
  merge_kernel<HD, FUSED><<<static_cast<unsigned>((warps + kWarps - 1) / kWarps),
                            kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// #1-#11: the single walk (decode_kernel) at splits 1
// (kPacked: and splits_chunk 1), else the split walk and its merge.
// FUSED: the normalised bf16 output; else (#2) the fp32 partials.
template <int MODE, bool Q8, bool FUSED = true>
cudaError_t dispatch_split(const Params& a, int hd, cudaStream_t stream) {
  const bool packed = MODE == kPacked;
  if (a.splits == 1 && (!packed || a.splits_chunk == 1))
    return dispatch_hd<FUSED, Q8, MODE>(a, hd, stream);
  if (!params_ok<MODE>(a) || a.splits < 1 || a.splits > 65535 ||
      a.part == nullptr || a.max_pieces < 1 ||
      (packed && (a.splits_chunk < 1 || a.splits_chunk > 65535 ||
                  a.max_pieces_chunk < 1)))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_split<16, MODE, Q8, FUSED>(a, stream);
    case 64: return launch_split<64, MODE, Q8, FUSED>(a, stream);
    case 80: return launch_split<80, MODE, Q8, FUSED>(a, stream);
    case 112: return launch_split<112, MODE, Q8, FUSED>(a, stream);
    case 128: return launch_split<128, MODE, Q8, FUSED>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bifurcated
