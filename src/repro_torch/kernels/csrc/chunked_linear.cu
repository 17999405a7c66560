// Chunked scalar-decay linear attention for Hopper (sm_90a), with a plain C
// interface for ctypes (kernels/_build.py builds this file with nvcc,
// kernels/chunked_linear.py binds and launches it).
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunked_linear.py:
// chunked_linear_attention_kernel (_chunk_kernel), the Mamba2-SSD / mLSTM
// substrate. For every (batch, head), over the sequence cut into chunks of
// C rows (the last zero-padded: q, k, v and the log-decay 0 there), with
// A_i the inclusive cumulative log-decay of row i within its chunk:
//
//   out_i = sum_{j <= i} (q_i . k_j) e^{min(A_i - A_j, 0)} v_j
//           + e^{A_i} q_i . S
//   S    <- e^{A_last} S + sum_j e^{A_last - A_j} k_j v_j^T
//
// with S the fp32 (dk, dv) state carried from chunk to chunk (zero, or the
// caller's initial state, at the start), out in bf16 and the final S in
// fp32. One generalisation: the initial state (the Pallas kernel starts
// from zero; the reference's chunked_linear_attention takes one).
//
// What bounds it on an H100: bytes. Mamba2 in zamba2-7b hands it q and k as
// head-broadcast views of (b, n, 64) (2 MB at n 8192), v and out (b, n,
// 112, 64) bf16 (235 MB), the log-decay (3.7 MB) and the state (1.8 MB):
// 242.5 MB, 72.4 us at 3.35 TB/s, against ~45 GFLOP (the causal half of
// the in-chunk products), ~46 us at 989 TFLOP/s.
//
// What the design does about it: only the state carries anything from one
// chunk to the next, so the chunks run in parallel and the state crosses
// them in one short chain (a first design walked each (batch, head)'s
// chunks in order in one CTA: 112 CTAs on 132 SMs, one CTA an SM, 1.31 ms
// at the slice's shape).
//   * One CTA of 4 warps per (batch, head, chunk): 3,584 CTAs at the slice's
//     shape, up to four an SM (the launch bounds; 56 KB of shared memory at
//     d 64). The CTAs take their (chunk, head) from an atomic ticket, chunk
//     by chunk across all heads: the heads of one chunk run together and
//     share the head-broadcast q/k rows in L2, and a CTA only ever waits on
//     a ticket taken before its own, so the chain makes progress whatever
//     order the CTAs are scheduled in. The last ticket resets the counter.
//   * Each CTA computes its chunk's inclusive cumulative log-decay A, then
//     its own state contribution dS = sum_j e^{A_last - A_j} k_j v_j^T from
//     zero (key tiles streamed through the ring below), then takes S_c from
//     the chunk before it: it spins on that head's flag (ld.acquire at gpu
//     scope, one thread) until the flag names its chunk, reads S_c from the
//     final-state buffer (through L2), writes S_{c+1} = e^{A_last} S_c + dS
//     there, fences and sets the flag to c + 1 (the last chunk: back to 0,
//     so the next call starts from zero flags with no host work). S_{c+1}
//     is the final state once the last chunk has written it. The hand-off
//     is one 16 KB read and write through L2 a chunk (at d 64), elementwise
//     on the product's register fragments; only then do its rows' products
//     run: each 64-row query tile against the 64-key tiles j <= i of its
//     chunk, plus e^{A_i} q_i . S_c, written once in bf16. The (C x C)
//     score block is never formed, only one (64 x 64) tile per warp quad.
//     Below the diagonal the decay factors into a row's and a key's
//     exponential (e^{A_i - A_r} e^{A_r - A_j}, A_r the tile's last key's,
//     both <= 1): 2 + 16 exponentials a thread a tile, not 32; on the
//     diagonal a warp skips the 8- and 16-key groups past its last row.
//   * Key tiles (K and V, zero-filled past the chunk or n) are staged by
//     cp.async into a two-stage ring, one step ahead of the tile computed,
//     across the hand-off; q fragments are read straight from device memory
//     into registers; q, k and v are read through their strides (last dim
//     contiguous), so the model's head-broadcast q/k (stride 0 over heads)
//     are never materialised.
// The four products, all on mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// every operand that is not an input is an fp32 value x split into
// x_hi = bf16(x) and x_lo = bf16(x - x_hi), two products, ~16 bits of x:
//   (1) q . k^T: bf16 operands, exact products, fp32 sums;
//   (2) (scores x decay) . v: P = the decay-weighted scores, split. Flash
//       attention rounds its P to bf16 once, but its weights are >= 0;
//       these scores are signed and cancel, so one rounding (2^-9 of each
//       term) can be a large share of a small row (measured: a
//       normalised row off by more than 2e-2 of its max);
//   (3) q . S_c: S_c split; e^{A_i} applied to the fp32 result;
//   (4) (e^{A_last - A_j} k_j)^T . v: the decay-weighted keys split, summed
//       from zero into dS, added to e^{A_last} S_c in fp32.
// Heads past 128 wide take the wide path below (two launches: the state
// as 64 x 64 blocks of the same chain, one flag a block). Later work
// (ROADMAP): wgmma and TMA.
//
// bf16 only: the wrapper raises TypeError for any other dtype on the card
// (float32 runs the plain version on the CPU).

#include "decode_common.cuh"

namespace chunked_linear {

using bifurcated::cp_async16;
using bifurcated::cp_async_commit;
using bifurcated::cp_async_wait_1;
using bifurcated::kPad;
using bifurcated::kThreads;
using bifurcated::kWarps;
using bifurcated::ldmatrix_x4_trans;
using bifurcated::load_pair;
using bifurcated::mma_bf16;
using bifurcated::pack_bf16;

constexpr int kTile = 64;   // rows per query tile and per key tile
constexpr int kSmemPerSm = 233472;   // an SM's shared memory, bytes
constexpr int kSmemReserved = 1024;  // the system's share of each CTA

struct Params {
  const __nv_bfloat16* q;   // (b, n, H, dk) through strides
  const __nv_bfloat16* k;   // (b, n, H, dk) through strides
  const __nv_bfloat16* v;   // (b, n, H, dv) through strides
  const float* a;           // (b, n, H) log-decay, contiguous
  const float* s0;          // (b, H, dk, dv) initial state or nullptr
  __nv_bfloat16* out;       // (b, n, H, dv) contiguous
  float* s_out;             // (b, H, dk, dv) contiguous: the chain's slot
  int* sync;                // [0] the ticket counter, [1 + bh] head bh's
                            // flag: zero between calls
  long long qs[3], ks[3], vs[3];   // element strides of b, n, H
  int b, n, H, dk, dv, chunk, nc;
};

// Shared-memory plan (bytes) at padded size D: the K and V ring (two
// stages each of kTile rows of D + kPad bf16), S_c's bf16 hi and lo (D rows
// of D + kPad), the chunk's cumulative log-decay (C floats) and the scan's
// warp totals.
template <int D>
struct Smem {
  static constexpr int SROW = D + kPad;
  static constexpr int STAGE = kTile * SROW;   // bf16 elements
  static constexpr int RING = 4 * STAGE * 2;
  static constexpr int SPLIT = 2 * D * SROW * 2;
  __host__ __device__ static constexpr long long bytes(int chunk) {
    return RING + SPLIT + 4LL * chunk + 4 * kWarps;
  }
};

// One step of a CTA's walk over its chunk: (st) the state contribution of
// key tile kt to state rows [64 part, 64 part + 64), all of them first;
// then the intra product of query tile qt with key tile kt (kt <= qt).
struct Step {
  int qt, kt, part;
  bool st;
};

__device__ __forceinline__ bool next_step(Step& s, int T, int NP) {
  if (s.st) {
    if (s.kt + 1 < T) { ++s.kt; return true; }
    if (s.part + 1 < NP) { ++s.part; s.kt = 0; return true; }
    s = Step{0, 0, 0, false};
    return true;
  }
  if (s.kt < s.qt) { ++s.kt; return true; }
  if (s.qt + 1 < T) { ++s.qt; s.kt = 0; return true; }
  return false;
}

// bf16 value with the low / high half of a packed pair
__device__ __forceinline__ float lo_f(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_f(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// x ~ hi + lo, both bf16: the pair's hi and lo halves packed
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - lo_f(hi), x1 - hi_f(hi));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// sA[j] = the inclusive cumulative log-decay of row j of the chunk of C
// rows from position c0 (rows past n: zero decay), for an NT-thread CTA:
// each thread sums a run of rows, the runs' totals are scanned across the
// CTA (sTot: one float a warp). Ends with a barrier.
template <int NT>
__device__ __forceinline__ void chunk_cumsum(float* sA, float* sTot,
                                             const float* a, int bi, int h,
                                             long long c0, int C, int n,
                                             int H) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (C + NT - 1) / NT;
  const int lo = tid * per, hi = min(lo + per, C);
  float run = 0.f;
  for (int j = lo; j < hi; ++j) {
    const long long t = c0 + j;
    run += t < n ? a[(static_cast<long long>(bi) * n + t) * H + h] : 0.f;
    sA[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sTot[warp] = incl;
  __syncthreads();
  float base = incl - run;
  for (int w = 0; w < warp; ++w) base += sTot[w];
  for (int j = lo; j < hi; ++j) sA[j] += base;
  __syncthreads();
}

// The register budget is cut for four CTAs an SM at d <= 64, whose
// shared-memory plan fits four; one at d 128.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1)
    chunked_linear_kernel(const Params p) {
  using SM = Smem<D>;
  constexpr int SROW = SM::SROW;
  constexpr int STAGE = SM::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 2 * STAGE;
  __nv_bfloat16* sHi = sK + 4 * STAGE;
  __nv_bfloat16* sLo = sHi + D * SROW;
  float* sA = reinterpret_cast<float*>(sLo + D * SROW);
  float* sTot = sA + p.chunk;
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  if (tid == 0) {
    const int t = atomicAdd(p.sync, 1);
    // every other CTA has taken its ticket: reset for the next call
    if (t == static_cast<int>(gridDim.x) - 1) atomicExch(p.sync, 0);
    s_ticket = t;
  }
  __syncthreads();
  const int BH = p.b * p.H;
  const int ci = s_ticket / BH, bh = s_ticket % BH;   // chunk, (batch, head)
  const int bi = bh / p.H, h = bh % p.H;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int C = p.chunk;
  const int T = (C + kTile - 1) / kTile;
  const int NP = (D + 63) / 64;
  const int dk = p.dk, dv = p.dv;
  const long long c0 = static_cast<long long>(ci) * C;
  int* flag = p.sync + 1 + bh;

  const __nv_bfloat16* qb = p.q + bi * p.qs[0] + h * p.qs[2];
  const __nv_bfloat16* kb = p.k + bi * p.ks[0] + h * p.ks[2];
  const __nv_bfloat16* vb = p.v + bi * p.vs[0] + h * p.vs[2];
  const size_t sbase = static_cast<size_t>(bh) * dk * dv;

  // stage key tile kt of the chunk (K and V rows, zero past the chunk and n)
  auto stage = [&](int slot, const Step& s) {
    constexpr int CH = D / 8;   // 16-byte chunks per row
    __nv_bfloat16* dK = sK + slot * STAGE;
    __nv_bfloat16* dV = sV + slot * STAGE;
    for (int e = tid; e < kTile * CH; e += kThreads) {
      const int r = e / CH, ch = e % CH;
      const int j = s.kt * kTile + r;
      const long long t = c0 + j;
      const bool row_ok = j < C && t < p.n;
      const bool k_ok = row_ok && ch * 8 < dk, v_ok = row_ok && ch * 8 < dv;
      cp_async16(dK + r * SROW + ch * 8,
                 k_ok ? kb + t * p.ks[1] + ch * 8 : kb, k_ok);
      cp_async16(dV + r * SROW + ch * 8,
                 v_ok ? vb + t * p.vs[1] + ch * 8 : vb, v_ok);
    }
  };

  Step cur{0, 0, 0, true};
  stage(0, cur);
  cp_async_commit();

  chunk_cumsum<kThreads>(sA, sTot, p.a, bi, h, c0, C, p.n, p.H);
  const float a_last = sA[C - 1];

  uint32_t qf[D / 16][4];   // A fragments of the warp's 16 query rows
  float o[D / 8][4];        // fp32 output rows, or the warp's dS rows
  float ai[2];              // A of this thread's query rows gr, gr + 8

  for (int slot = 0;; slot ^= 1) {
    Step nxt = cur;
    const bool more = next_step(nxt, T, NP);
    if (more) stage(slot ^ 1, nxt);
    cp_async_commit();

    cp_async_wait_1();   // every group but the newest is done: this step's
    __syncthreads();
    const __nv_bfloat16* Ks = sK + slot * STAGE;
    const __nv_bfloat16* Vs = sV + slot * STAGE;
    const int mi = lane >> 3, rr = lane & 7;

    if (!cur.st) {
      // ---- intra: query tile qt against key tile kt ----
      const int i0 = cur.qt * kTile + warp * 16 + gr;   // chunk-local rows
      const int irow[2] = {i0, i0 + 8};
      if (cur.kt == 0) {
        // the tile's q fragments, then o = e^{A_i} q_i . (S_hi + S_lo)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ai[i] = irow[i] < C ? sA[irow[i]] : 0.f;
        }
        const bool va = i0 < C && c0 + i0 < p.n;
        const bool vb8 = i0 + 8 < C && c0 + i0 + 8 < p.n;
        const __nv_bfloat16* qa = qb + (c0 + i0) * p.qs[1];
        const __nv_bfloat16* qc = qb + (c0 + i0 + 8) * p.qs[1];
#pragma unroll
        for (int kt = 0; kt < D / 16; ++kt) {
          const int c = kt * 16 + 2 * tq;
          qf[kt][0] = load_pair(qa + c, va && c < dk);
          qf[kt][1] = load_pair(qc + c, vb8 && c < dk);
          qf[kt][2] = load_pair(qa + c + 8, va && c + 8 < dk);
          qf[kt][3] = load_pair(qc + c + 8, vb8 && c + 8 < dk);
        }
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < D / 16; ++kt) {
          const int key = kt * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
          for (int nt = 0; nt < D / 8; nt += 2) {
            const int col = nt * 8 + ((mi & 2) ? 8 : 0);
            uint32_t bh4[4], bl4[4];
            ldmatrix_x4_trans(bh4, sHi + key * SROW + col);
            ldmatrix_x4_trans(bl4, sLo + key * SROW + col);
            mma_bf16(o[nt], qf[kt], bh4[0], bh4[1]);
            mma_bf16(o[nt + 1], qf[kt], bh4[2], bh4[3]);
            mma_bf16(o[nt], qf[kt], bl4[0], bl4[1]);
            mma_bf16(o[nt + 1], qf[kt], bl4[2], bl4[3]);
          }
        }
        const float ea = expf(ai[0]), eb = expf(ai[1]);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[nt][0] *= ea;
          o[nt][1] *= ea;
          o[nt][2] *= eb;
          o[nt][3] *= eb;
        }
      }
      // scores of the warp's 16 rows against the tile's 64 keys; on the
      // diagonal tile, only the 8-key groups that hold a key j <= i
      const int j0 = cur.kt * kTile;
      const int i_last = cur.qt * kTile + warp * 16 + 15;   // warp's last row
      if (j0 <= i_last) {   // a key j <= i exists
        float s[kTile / 8][4];
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          if (j0 + nt * 8 > i_last) continue;
#pragma unroll
          for (int kt = 0; kt < D / 16; ++kt) {
            const __nv_bfloat16* kp = Ks + (nt * 8 + gr) * SROW + kt * 16 + 2 * tq;
            mma_bf16(s[nt], qf[kt], *reinterpret_cast<const uint32_t*>(kp),
                     *reinterpret_cast<const uint32_t*>(kp + 8));
          }
        }
        if (cur.kt < cur.qt) {
          // below the diagonal every key j (all < C) precedes every row i:
          // x e^{A_i - A_j} = e^{A_i - A_r} e^{A_r - A_j}, A_r the tile's
          // last key's. Both factors are <= 1, so neither underflows where
          // their product does not: an exponential a row and one a key,
          // not one an element (rows past C are never written)
          const float ar = sA[j0 + kTile - 1];
          const float r0 = expf(ai[0] - ar), r1 = expf(ai[1] - ar);
#pragma unroll
          for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float cj = expf(ar - sA[j0 + nt * 8 + 2 * tq + e]);
              s[nt][e] *= r0 * cj;
              s[nt][2 + e] *= r1 * cj;
            }
          }
        } else {
          // the diagonal tile: x e^{min(A_i - A_j, 0)}, 0 unless j <= i
#pragma unroll
          for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + nt * 8 + 2 * tq + e;
              const float aj = j < C ? sA[j] : 0.f;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float d =
                    j <= irow[i] ? expf(fminf(ai[i] - aj, 0.f)) : 0.f;
                s[nt][2 * i + e] *= d;
              }
            }
          }
        }
        // o += P V, P split into bf16 hi and lo as A operands from
        // registers: the scores are signed, so a P rounded once to bf16
        // would lose to cancellation what softmax weights keep
#pragma unroll
        for (int kt = 0; kt < kTile / 16; ++kt) {
          if (j0 + kt * 16 > i_last) continue;   // its scores are all 0
          uint32_t ahi[4], alo[4];
          split_pair(s[2 * kt][0], s[2 * kt][1], ahi[0], alo[0]);
          split_pair(s[2 * kt][2], s[2 * kt][3], ahi[1], alo[1]);
          split_pair(s[2 * kt + 1][0], s[2 * kt + 1][1], ahi[2], alo[2]);
          split_pair(s[2 * kt + 1][2], s[2 * kt + 1][3], ahi[3], alo[3]);
          const int key = kt * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
          for (int nt = 0; nt < D / 8; nt += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Vs + key * SROW + nt * 8 + ((mi & 2) ? 8 : 0));
            mma_bf16(o[nt], ahi, b[0], b[1]);
            mma_bf16(o[nt + 1], ahi, b[2], b[3]);
            mma_bf16(o[nt], alo, b[0], b[1]);
            mma_bf16(o[nt + 1], alo, b[2], b[3]);
          }
        }
      }
      if (cur.kt == cur.qt) {   // the tile's last key tile: write its rows
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const long long t = c0 + irow[i];
          if (irow[i] >= C || t >= p.n) continue;
          __nv_bfloat16* orow =
              p.out + ((static_cast<long long>(bi) * p.n + t) * p.H + h) * dv;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const int c = nt * 8 + 2 * tq;
            if (c < dv)
              *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                  __floats2bfloat162_rn(o[nt][2 * i], o[nt][2 * i + 1]);
          }
        }
      }
    } else {
      // ---- dS: rows m0..m0+15 += (w_j k_j)^T v_j over key tile kt ----
      const int m0 = cur.part * 64 + warp * 16;
      if (m0 < D) {
        if (cur.kt == 0) {
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt)
            o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
        }
        const int j0 = cur.kt * kTile;
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks) {
          // A = (w K)^T: K rows are keys, so the transposing load gives the
          // (state row, key) fragment; keys 2tq, 2tq + 1 (+8) per register
          uint32_t ar[4];
          ldmatrix_x4_trans(ar, Ks + (ks * 16 + rr + ((mi & 2) ? 8 : 0)) * SROW +
                                    m0 + ((mi & 1) ? 8 : 0));
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + ks * 16 + 2 * tq + (e & 1) + ((e & 2) ? 8 : 0);
            w[e] = j < C ? expf(a_last - sA[j]) : 0.f;
          }
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = (r & 2) ? 2 : 0;   // registers 2, 3: keys + 8
            split_pair(lo_f(ar[r]) * w[e], hi_f(ar[r]) * w[e + 1], ahi[r],
                       alo[r]);
          }
          const int key = ks * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
          for (int nt = 0; nt < D / 8; nt += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Vs + key * SROW + nt * 8 + ((mi & 2) ? 8 : 0));
            mma_bf16(o[nt], ahi, b[0], b[1]);
            mma_bf16(o[nt + 1], ahi, b[2], b[3]);
            mma_bf16(o[nt], alo, b[0], b[1]);
            mma_bf16(o[nt + 1], alo, b[2], b[3]);
          }
        }
      }
      if (cur.kt == T - 1) {   // the part's dS is whole: the hand-off
        if (cur.part == 0 && ci > 0) {
          // S_c is the chunk before's to write: wait for its flag
          if (tid == 0) {
            while (ld_acquire(flag) != ci) __nanosleep(64);
          }
          __syncthreads();
        }
        if (m0 < D) {
          // this thread's fragment of S_c (the caller's state, or zero, at
          // chunk 0): split into S_hi / S_lo for the inter term, and
          // S_{c+1} = e^{A_last} S_c + dS written over it (read and written
          // through L2: other SMs' CTAs hand it on)
          const float dec = expf(a_last);
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const int col = nt * 8 + 2 * tq;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = m0 + gr + 8 * i;
              const bool live = r < dk && col < dv;
              const size_t at = sbase + static_cast<size_t>(r) * dv + col;
              float2 sc = make_float2(0.f, 0.f);
              if (live && ci > 0)
                sc = __ldcg(reinterpret_cast<const float2*>(p.s_out + at));
              else if (live && p.s0 != nullptr)
                sc = *reinterpret_cast<const float2*>(p.s0 + at);
              uint32_t hi, lo;
              split_pair(sc.x, sc.y, hi, lo);
              *reinterpret_cast<uint32_t*>(sHi + r * SROW + col) = hi;
              *reinterpret_cast<uint32_t*>(sLo + r * SROW + col) = lo;
              if (live)
                __stcg(reinterpret_cast<float2*>(p.s_out + at),
                       make_float2(sc.x * dec + o[nt][2 * i],
                                   sc.y * dec + o[nt][2 * i + 1]));
            }
          }
        }
        if (cur.part == NP - 1) {
          // S_{c+1} is whole: publish it to the next chunk (the last chunk
          // resets the flag for the next call)
          __threadfence();
          __syncthreads();
          if (tid == 0) st_release(flag, ci + 1 < p.nc ? ci + 1 : 0);
        }
      }
    }
    __syncthreads();   // the slot is refilled next; S_hi / S_lo read next
    if (!more) break;
    cur = nxt;
  }
}

// The dynamic shared memory a launch asks for: the plan's, or, with
// ctas_per_sm > 0, enough more that at most that many CTAs share an SM.
template <int D>
long long smem_request(int chunk, int ctas_per_sm) {
  long long smem = Smem<D>::bytes(chunk);
  if (ctas_per_sm > 0) {
    const long long cap = kSmemPerSm / (ctas_per_sm + 1) - kSmemReserved + 16;
    if (cap > smem) smem = cap;
  }
  return smem;
}

template <int D>
cudaError_t prepare(long long smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = chunked_linear_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch(const Params& a, int ctas_per_sm, cudaStream_t stream) {
  const long long smem = smem_request<D>(a.chunk, ctas_per_sm);
  cudaError_t err = prepare<D>(smem);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(a.b) * a.H * a.nc;
  chunked_linear_kernel<D><<<static_cast<unsigned>(ctas), kThreads,
                             static_cast<int>(smem), stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int chunk, int ctas_per_sm, int* out) {
  const long long smem = smem_request<D>(chunk, ctas_per_sm);
  cudaError_t err = prepare<D>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, chunked_linear_kernel<D>, kThreads, static_cast<size_t>(smem));
}

// ---------------------------------------------------------------------------
// The wide path: heads past 128 wide (xLSTM's mLSTM: dk 1024, dv 1024 and
// the normaliser column, 1032 padded), chunks of up to 256 rows. A
// (dk, dv) fp32 state of 4.2 MB does not fit a CTA, but the chain
// S_{c+1} = e^{A_last} S_c + dS_c is elementwise in S: the state is cut
// into 64 x 64 blocks, each with its own chain and flag. Two launches a
// call:
//   * chunked_linear_scores_kernel: one CTA of 4 warps per (batch, head,
//     chunk, query tile i, key tile j <= i) of 64 x 64: the tile of
//     P = (q k^T) x e^{min(A_i - A_j, 0)} (0 unless j <= i) over all of dk
//     in 64-wide slabs (a two-stage cp.async ring), written in fp32 to a
//     scratch buffer (b H nc, C', C') (C' the chunk rounded up to 64): the
//     intra term's q . k^T once per (head, chunk), not once per dv block.
//   * chunked_linear_wide_kernel: one CTA of 8 warps per (batch, head,
//     chunk, 64-column block of dv), 2,176 at xLSTM's prefill (b 1, n 8192,
//     H 4, chunk 256, dv 1032), their order chunk-major from an atomic
//     ticket as in the narrow kernel. The CTA stages its chunk's 64 v
//     columns once, then walks the 16 64-row blocks of dk: stages that k
//     and q slab (the next ones in flight), computes the state block's
//     dS_c from zero, waits for the chunk before to hand that block on (its
//     flag),
//     reads S_c, writes S_{c+1} over it and sets the flag, and adds the
//     block's share of the inter term q_i . S_c to its rows' accumulators,
//     so the sum over dk is a loop in one CTA: no atomics, the same bits
//     every call. Then it scales its rows by e^{A_i}, adds P . v over the
//     keys j <= i, and writes its output columns once in bf16.
// Precision as in the narrow kernel: P, e^{A_last - A_j} k_j and S_c split
// into bf16 hi and lo, two products each; q, k and v exact.
// What bounds it: operations. At xLSTM's prefill shape the products are
// ~155 GFLOP (dS and the inter term 68.7 each, the causal halves of q k^T
// and P v 8.6 each), ~157 us at 989 TFLOP/s, against ~285 MB (85 us).
// This design runs them on mma.sync with bf16 splits (twice the products
// of the dS, inter and P v terms), eight warps a CTA and one CTA an SM;
// wgmma and TMA are later work.

constexpr int kBlk = 64;            // state block (dk and dv), dk slab
constexpr int kBRow = kBlk + kPad;  // a 64-wide slab's shared-memory row
constexpr int kWideMaxChunk = 256;  // the row accumulators' reach
constexpr int kWideMaxDk = 1024;    // the widest head it takes
constexpr int kWideMaxDv = 1032;    // 1024 and the normaliser, padded
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;

struct WideParams {
  const __nv_bfloat16* q;   // (b, n, H, dk) through strides
  const __nv_bfloat16* k;   // (b, n, H, dk) through strides
  const __nv_bfloat16* v;   // (b, n, H, dv) through strides
  const float* a;           // (b, n, H) log-decay, contiguous
  const float* s0;          // (b, H, dk, dv) initial state or nullptr
  float* scores;            // (b H nc, cp, cp): P, the lower tiles
  __nv_bfloat16* out;       // (b, n, H, dv) contiguous
  float* s_out;             // (b, H, dk, dv) contiguous: the chains' slot
  int* sync;                // [0] the ticket counter, then one flag per
                            // (batch, head, dk block, dv block)
  long long qs[3], ks[3], vs[3];   // element strides of b, n, H
  int b, n, H, dk, dv, chunk, nc, cp;
};

__global__ void __launch_bounds__(kThreads, 4)
    chunked_linear_scores_kernel(const WideParams p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[2][kTile * kBRow];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kTile * kBRow];
  __shared__ float sA[kWideMaxChunk];
  __shared__ float sTot[kWarps];

  const int T = p.cp / kTile;
  const int pairs = T * (T + 1) / 2;
  const int pr = blockIdx.x % pairs;
  const int ci = (blockIdx.x / pairs) % p.nc;
  const int bh = blockIdx.x / pairs / p.nc;
  int qt = 0, kt = pr;   // the pair's tiles, kt <= qt, row by row
  while (kt > qt) {
    kt -= qt + 1;
    ++qt;
  }
  const int bi = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int C = p.chunk;
  const long long c0 = static_cast<long long>(ci) * C;
  const __nv_bfloat16* qb = p.q + bi * p.qs[0] + h * p.qs[2];
  const __nv_bfloat16* kb = p.k + bi * p.ks[0] + h * p.ks[2];
  const int ND = (p.dk + kBlk - 1) / kBlk;

  // stage dk slab sl of the tile's q rows and k rows (zero past the chunk,
  // n and dk)
  auto stage = [&](int slot, int sl) {
    constexpr int CH = kBlk / 8;   // 16-byte chunks per row
    for (int e = tid; e < 2 * kTile * CH; e += kThreads) {
      const bool isk = e >= kTile * CH;
      const int e2 = isk ? e - kTile * CH : e;
      const int r = e2 / CH, ch = e2 % CH;
      const int row = (isk ? kt : qt) * kTile + r;   // chunk-local
      const long long t = c0 + row;
      const int col = sl * kBlk + ch * 8;
      const bool ok = row < C && t < p.n && col < p.dk;
      const __nv_bfloat16* src = isk ? kb + t * p.ks[1] : qb + t * p.qs[1];
      cp_async16((isk ? sK[slot] : sQ[slot]) + r * kBRow + ch * 8,
                 ok ? src + col : (isk ? kb : qb), ok);
    }
  };

  stage(0, 0);
  cp_async_commit();
  chunk_cumsum<kThreads>(sA, sTot, p.a, bi, h, c0, C, p.n, p.H);

  const int r0 = qt * kTile + warp * 16;   // the warp's first row
  const int i_last = r0 + 15;
  const int j0 = kt * kTile;
  float s[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int sl = 0; sl < ND; ++sl) {
    const int slot = sl & 1;
    if (sl + 1 < ND) stage(slot ^ 1, sl + 1);
    cp_async_commit();
    cp_async_wait_1();   // every group but the newest is done: this slab's
    __syncthreads();
    if (j0 <= i_last) {   // a key j <= i exists
      const __nv_bfloat16* Q = sQ[slot] + (warp * 16 + gr) * kBRow;
      const __nv_bfloat16* K = sK[slot];
#pragma unroll
      for (int kk = 0; kk < kBlk / 16; ++kk) {
        const int c = kk * 16 + 2 * tq;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(Q + c);
        af[1] = *reinterpret_cast<const uint32_t*>(Q + 8 * kBRow + c);
        af[2] = *reinterpret_cast<const uint32_t*>(Q + c + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(Q + 8 * kBRow + c + 8);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          if (j0 + nt * 8 > i_last) continue;
          const __nv_bfloat16* kp = K + (nt * 8 + gr) * kBRow + c;
          mma_bf16(s[nt], af, *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
    }
    __syncthreads();   // the slot is refilled next
  }

  // the decay, 0 unless j <= i < C; every element of the tile written
  float* P = p.scores +
             (static_cast<size_t>(bh) * p.nc + ci) * p.cp * p.cp + j0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + gr + 8 * i;
    const float ai = row < C ? sA[row] : 0.f;
    float* prow = P + static_cast<size_t>(row) * p.cp;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + nt * 8 + 2 * tq + e;
        x[e] = row < C && j <= row
                   ? s[nt][2 * i + e] * expf(fminf(ai - sA[j], 0.f))
                   : 0.f;
      }
      *reinterpret_cast<float2*>(prow + nt * 8 + 2 * tq) =
          make_float2(x[0], x[1]);
    }
  }
}

// The wide kernel's dynamic shared memory: the chunk's v block and two
// stages of the k and q slabs (cp rows each), S_c's block split into bf16
// hi and lo, the chunk's cumulative log-decay and dS weights, the scan's
// totals: 205 KB at chunk 256.
__host__ __device__ constexpr long long wide_smem(int cp) {
  return (5LL * cp * kBRow + 2LL * kBlk * kBRow) * 2 +
         (2LL * cp + kWideWarps) * 4;
}

__global__ void __launch_bounds__(kWideThreads, 1)
    chunked_linear_wide_kernel(const WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CP = p.cp;
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sV + CP * kBRow;   // two stages
  __nv_bfloat16* sQ = sK + 2 * CP * kBRow;   // two stages
  __nv_bfloat16* sHi = sQ + 2 * CP * kBRow;
  __nv_bfloat16* sLo = sHi + kBlk * kBRow;
  float* sA = reinterpret_cast<float*>(sLo + kBlk * kBRow);
  float* sW = sA + CP;
  float* sTot = sW + CP;
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  if (tid == 0) {
    const int t = atomicAdd(p.sync, 1);
    // every other CTA has taken its ticket: reset for the next call
    if (t == static_cast<int>(gridDim.x) - 1) atomicExch(p.sync, 0);
    s_ticket = t;
  }
  __syncthreads();
  const int NK = (p.dk + kBlk - 1) / kBlk, NV = (p.dv + kBlk - 1) / kBlk;
  const int BH = p.b * p.H;
  const int ci = s_ticket / (BH * NV);      // chunk
  const int bh = s_ticket % (BH * NV) / NV;  // (batch, head)
  const int vb = s_ticket % NV;              // dv block
  const int bi = bh / p.H, h = bh % p.H;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;
  const int C = p.chunk;
  const int KS = (C + 15) / 16;             // 16-key steps over the chunk
  const long long c0 = static_cast<long long>(ci) * C;
  const int v0 = vb * kBlk, nv = min(kBlk, p.dv - v0);   // live columns
  const __nv_bfloat16* qb = p.q + bi * p.qs[0] + h * p.qs[2];
  const __nv_bfloat16* kb = p.k + bi * p.ks[0] + h * p.ks[2];
  const __nv_bfloat16* vbase = p.v + bi * p.vs[0] + h * p.vs[2];
  int* flags = p.sync + 1 + static_cast<size_t>(bh) * NK * NV + vb;
  const size_t sbase = static_cast<size_t>(bh) * p.dk * p.dv;

  // stage 64 columns from col0 of the chunk's rows (zero past the chunk, n
  // and width)
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* base,
                   long long stride, int col0, int width) {
    constexpr int CH = kBlk / 8;
    for (int e = tid; e < CP * CH; e += kWideThreads) {
      const int r = e / CH, ch = e % CH;
      const long long t = c0 + r;
      const int col = col0 + ch * 8;
      const bool ok = r < C && t < p.n && col < width;
      cp_async16(dst + r * kBRow + ch * 8, ok ? base + t * stride + col : base,
                 ok);
    }
  };
  stage(sV, vbase, p.vs[1], v0, p.dv);
  stage(sK, kb, p.ks[1], 0, p.dk);
  stage(sQ, qb, p.qs[1], 0, p.dk);
  cp_async_commit();
  chunk_cumsum<kWideThreads>(sA, sTot, p.a, bi, h, c0, C, p.n, p.H);
  const float a_last = sA[C - 1];
  for (int j = tid; j < CP; j += kWideThreads)
    sW[j] = j < C ? expf(a_last - sA[j]) : 0.f;   // read after a barrier

  // rows: warp w owns chunk rows [32 w, 32 w + 32), two 16-row m-tiles;
  // dS: warp w owns the state block's rows [16 (w & 3), +16) and columns
  // [32 (w >> 2), +32)
  const int row0 = warp * 32;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float o[2][kBlk / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kBlk / 8; ++nt)
      o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.f;

  for (int kb_i = 0; kb_i < NK; ++kb_i) {
    const int slot = kb_i & 1;
    const int k0 = kb_i * kBlk, nk = min(kBlk, p.dk - k0);
    if (kb_i + 1 < NK) {   // the next slabs of k and q, in flight
      stage(sK + (slot ^ 1) * CP * kBRow, kb, p.ks[1], k0 + kBlk, p.dk);
      stage(sQ + (slot ^ 1) * CP * kBRow, qb, p.qs[1], k0 + kBlk, p.dk);
    }
    cp_async_commit();
    cp_async_wait_1();   // every group but the newest is done: this slab
    __syncthreads();
    const __nv_bfloat16* Ks = sK + slot * CP * kBRow;
    const __nv_bfloat16* Qs = sQ + slot * CP * kBRow;

    // ---- dS: state rows k0 + m0.., columns v0 + n0.., over the chunk's
    // keys: (w_j k_j)^T v_j, w_j = e^{A_last - A_j} split ----
    float ds[4][4], dl[4][4];   // the hi and lo products' sums apart:
                                // twice the independent mma chains
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
      dl[nt][0] = dl[nt][1] = dl[nt][2] = dl[nt][3] = 0.f;
    }
    if (m0 < nk && n0 < nv) {
      for (int ks = 0; ks < KS; ++ks) {
        // A = (w K)^T: the transposing load gives the (state row, key)
        // fragment; keys 2tq, 2tq + 1 (+8) per register
        uint32_t ar[4];
        ldmatrix_x4_trans(ar, Ks + (ks * 16 + rr + ((mi & 2) ? 8 : 0)) * kBRow +
                                  m0 + ((mi & 1) ? 8 : 0));
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = sW[ks * 16 + 2 * tq + (e & 1) + ((e & 2) ? 8 : 0)];
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = (r & 2) ? 2 : 0;   // registers 2, 3: keys + 8
          split_pair(lo_f(ar[r]) * w[e], hi_f(ar[r]) * w[e + 1], ahi[r],
                     alo[r]);
        }
        const int key = ks * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          if (n0 + nt * 8 >= nv) break;
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + key * kBRow + n0 + nt * 8 +
                                    ((mi & 2) ? 8 : 0));
          mma_bf16(ds[nt], ahi, bv[0], bv[1]);
          mma_bf16(ds[nt + 1], ahi, bv[2], bv[3]);
          mma_bf16(dl[nt], alo, bv[0], bv[1]);
          mma_bf16(dl[nt + 1], alo, bv[2], bv[3]);
        }
      }
    }

    // ---- the hand-off: S_c from the chunk before (the caller's state, or
    // zero, at chunk 0), split into S_hi / S_lo for the inter term, and
    // S_{c+1} = e^{A_last} S_c + dS written over it through L2 ----
    int* flag = flags + kb_i * NV;
    if (ci > 0) {
      if (tid == 0) {
        while (ld_acquire(flag) != ci) __nanosleep(64);
      }
      __syncthreads();
    }
    {
      const float dec = expf(a_last);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * tq;   // block-local
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + gr + 8 * i;        // block-local
          const bool live = r < nk && col < nv;
          const size_t at =
              sbase + static_cast<size_t>(k0 + r) * p.dv + v0 + col;
          float2 sc = make_float2(0.f, 0.f);
          if (live && ci > 0)
            sc = __ldcg(reinterpret_cast<const float2*>(p.s_out + at));
          else if (live && p.s0 != nullptr)
            sc = *reinterpret_cast<const float2*>(p.s0 + at);
          uint32_t hi, lo;
          split_pair(sc.x, sc.y, hi, lo);
          *reinterpret_cast<uint32_t*>(sHi + r * kBRow + col) = hi;
          *reinterpret_cast<uint32_t*>(sLo + r * kBRow + col) = lo;
          if (live)
            __stcg(reinterpret_cast<float2*>(p.s_out + at),
                   make_float2(sc.x * dec + (ds[nt][2 * i] + dl[nt][2 * i]),
                               sc.y * dec + (ds[nt][2 * i + 1] +
                                             dl[nt][2 * i + 1])));
        }
      }
    }
    // S_{c+1}'s block is whole: publish it to the next chunk (the last
    // chunk resets the flag for the next call)
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flag, ci + 1 < p.nc ? ci + 1 : 0);

    // ---- inter: the rows' q . S_c over this dk block ----
    if (row0 < C) {
#pragma unroll
      for (int kk = 0; kk < kBlk / 16; ++kk) {
        if (kk * 16 >= nk) break;
        uint32_t qf[2][4];   // A fragments of the warp's rows' q
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* Q =
              Qs + (row0 + mt * 16 + gr) * kBRow + kk * 16 + 2 * tq;
          qf[mt][0] = *reinterpret_cast<const uint32_t*>(Q);
          qf[mt][1] = *reinterpret_cast<const uint32_t*>(Q + 8 * kBRow);
          qf[mt][2] = *reinterpret_cast<const uint32_t*>(Q + 8);
          qf[mt][3] = *reinterpret_cast<const uint32_t*>(Q + 8 * kBRow + 8);
        }
        const int key = kk * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
        for (int nt = 0; nt < kBlk / 8; nt += 2) {
          if (nt * 8 >= nv) break;
          const int col = nt * 8 + ((mi & 2) ? 8 : 0);
          uint32_t bh4[4], bl4[4];
          ldmatrix_x4_trans(bh4, sHi + key * kBRow + col);
          ldmatrix_x4_trans(bl4, sLo + key * kBRow + col);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (row0 + mt * 16 >= C) continue;
            mma_bf16(o[mt][nt], qf[mt], bh4[0], bh4[1]);
            mma_bf16(o[mt][nt + 1], qf[mt], bh4[2], bh4[3]);
            mma_bf16(o[mt][nt], qf[mt], bl4[0], bl4[1]);
            mma_bf16(o[mt][nt + 1], qf[mt], bl4[2], bl4[3]);
          }
        }
      }
    }
    __syncthreads();   // S_hi / S_lo and the slot are rewritten next
  }

  // ---- e^{A_i} on the inter term, then the intra term P . v over the
  // keys j <= i (P split into hi and lo A operands), then the rows out ----
  const float* P = p.scores + (static_cast<size_t>(bh) * p.nc + ci) * CP * CP;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = row0 + mt * 16;   // the m-tile's first row
    if (ra >= C) continue;
    const float ea = expf(sA[min(ra + gr, C - 1)]);
    const float eb = expf(sA[min(ra + gr + 8, C - 1)]);
#pragma unroll
    for (int nt = 0; nt < kBlk / 8; ++nt) {
      o[mt][nt][0] *= ea;
      o[mt][nt][1] *= ea;
      o[mt][nt][2] *= eb;
      o[mt][nt][3] *= eb;
    }
    const float* pa = P + static_cast<size_t>(ra + gr) * CP;
    const float* pb = pa + 8 * CP;
    const int ks_end = min(ra / 16 + 1, KS);   // keys j <= i
    float2 x[4];   // this step's P fragment; the next one's is in flight
    x[0] = *reinterpret_cast<const float2*>(pa + 2 * tq);
    x[1] = *reinterpret_cast<const float2*>(pb + 2 * tq);
    x[2] = *reinterpret_cast<const float2*>(pa + 2 * tq + 8);
    x[3] = *reinterpret_cast<const float2*>(pb + 2 * tq + 8);
    for (int ks = 0; ks < ks_end; ++ks) {
      float2 xn[4];
      if (ks + 1 < ks_end) {
        const int c = (ks + 1) * 16 + 2 * tq;
        xn[0] = *reinterpret_cast<const float2*>(pa + c);
        xn[1] = *reinterpret_cast<const float2*>(pb + c);
        xn[2] = *reinterpret_cast<const float2*>(pa + c + 8);
        xn[3] = *reinterpret_cast<const float2*>(pb + c + 8);
      }
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_pair(x[r].x, x[r].y, ahi[r], alo[r]);
      const int key = ks * 16 + rr + ((mi & 1) ? 8 : 0);
#pragma unroll
      for (int nt = 0; nt < kBlk / 8; nt += 2) {
        if (nt * 8 >= nv) break;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + key * kBRow + nt * 8 + ((mi & 2) ? 8 : 0));
        mma_bf16(o[mt][nt], ahi, bv[0], bv[1]);
        mma_bf16(o[mt][nt + 1], ahi, bv[2], bv[3]);
        mma_bf16(o[mt][nt], alo, bv[0], bv[1]);
        mma_bf16(o[mt][nt + 1], alo, bv[2], bv[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = xn[r];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ra + gr + 8 * i;
      const long long t = c0 + row;
      if (row >= C || t >= p.n) continue;
      __nv_bfloat16* orow =
          p.out + ((static_cast<long long>(bi) * p.n + t) * p.H + h) * p.dv +
          v0;
#pragma unroll
      for (int nt = 0; nt < kBlk / 8; ++nt) {
        const int c = nt * 8 + 2 * tq;
        if (c < nv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[mt][nt][2 * i], o[mt][nt][2 * i + 1]);
      }
    }
  }
}

// Checks and fills the wide path's parameters; false when the C interface's
// contract is broken.
bool wide_params(WideParams& a, const void* q, const void* k, const void* v,
                 const void* log_decay, const void* s0, void* scores,
                 void* out, void* s_out, void* sync, const long long* qs,
                 const long long* ks, const long long* vs, int b, int n,
                 int H, int dk, int dv, int chunk) {
  if (b <= 0 || n <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk % 8 ||
      dv % 8 || dk > kWideMaxDk || dv > kWideMaxDv || chunk < 1 ||
      chunk > n || chunk > kWideMaxChunk || scores == nullptr)
    return false;
  a.nc = (n + chunk - 1) / chunk;
  a.cp = (chunk + kTile - 1) / kTile * kTile;
  const long long nv = (dv + kBlk - 1) / kBlk;
  if (static_cast<long long>(b) * H * a.nc * (nv > 10 ? nv : 10) >
      0x7fffffffLL)
    return false;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.a = static_cast<const float*>(log_decay);
  a.s0 = static_cast<const float*>(s0);
  a.scores = static_cast<float*>(scores);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.s_out = static_cast<float*>(s_out);
  a.sync = static_cast<int*>(sync);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = qs[i];
    a.ks[i] = ks[i];
    a.vs[i] = vs[i];
  }
  a.b = b;
  a.n = n;
  a.H = H;
  a.dk = dk;
  a.dv = dv;
  a.chunk = chunk;
  return true;
}

cudaError_t launch_scores(const WideParams& a, cudaStream_t stream) {
  const int T = a.cp / kTile;
  const long long ctas = static_cast<long long>(a.b) * a.H * a.nc * T * (T + 1) / 2;
  chunked_linear_scores_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                                 stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_wide(const WideParams& a, cudaStream_t stream) {
  const long long smem = wide_smem(a.cp);
  cudaError_t err = cudaFuncSetAttribute(
      chunked_linear_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long ctas =
      static_cast<long long>(a.b) * a.H * a.nc * ((a.dv + kBlk - 1) / kBlk);
  chunked_linear_wide_kernel<<<static_cast<unsigned>(ctas), kWideThreads,
                               static_cast<int>(smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace chunked_linear

extern "C" {

// q, k (b, n, H, dk) and v (b, n, H, dv) bf16, their last dim contiguous,
// read through the element strides (batch, position, head) q_s*, k_s*, v_s*
// (each a multiple of 8, rows 16-byte aligned); log_decay (b, n, H) f32
// contiguous; s0 (b, H, dk, dv) f32 contiguous or null; out (b, n, H, dv)
// bf16 and s_out (b, H, dk, dv) f32, contiguous; sync (1 + b H) int32, zero
// (each call leaves it zero again; calls that share it run one after the
// other). dk, dv multiples of 8 up to d, d in 16, 32, 64, 128; 1 <= chunk
// <= n. ctas_per_sm: 0, or at most that many CTAs an SM (a measurement
// knob). One launch. Returns the CUDA error of the launch (0 when it was
// accepted).
int chunked_linear_attention(const void* q, const void* k, const void* v,
                             const void* log_decay, const void* s0, void* out,
                             void* s_out, void* sync, long long q_sb,
                             long long q_sn, long long q_sh, long long k_sb,
                             long long k_sn, long long k_sh, long long v_sb,
                             long long v_sn, long long v_sh, int b, int n,
                             int H, int dk, int dv, int d, int chunk,
                             int ctas_per_sm, void* stream) {
  using chunked_linear::Params;
  if (b <= 0 || n <= 0 || H <= 0 || dk <= 0 || dv <= 0 || dk % 8 ||
      dv % 8 || dk > d || dv > d || chunk < 1 || chunk > n ||
      ctas_per_sm < 0 || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (n + chunk - 1) / chunk;
  if (static_cast<long long>(b) * H * nc > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.a = static_cast<const float*>(log_decay);
  a.s0 = static_cast<const float*>(s0);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.s_out = static_cast<float*>(s_out);
  a.sync = static_cast<int*>(sync);
  a.qs[0] = q_sb; a.qs[1] = q_sn; a.qs[2] = q_sh;
  a.ks[0] = k_sb; a.ks[1] = k_sn; a.ks[2] = k_sh;
  a.vs[0] = v_sb; a.vs[1] = v_sn; a.vs[2] = v_sh;
  a.b = b;
  a.n = n;
  a.H = H;
  a.dk = dk;
  a.dv = dv;
  a.chunk = chunk;
  a.nc = nc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return static_cast<int>(chunked_linear::launch<16>(a, ctas_per_sm, s));
    case 32: return static_cast<int>(chunked_linear::launch<32>(a, ctas_per_sm, s));
    case 64: return static_cast<int>(chunked_linear::launch<64>(a, ctas_per_sm, s));
    case 128: return static_cast<int>(chunked_linear::launch<128>(a, ctas_per_sm, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTAs an SM a launch at padded size d, chunk and ctas_per_sm (as in
// chunked_linear_attention) holds at once, into *out. Returns the CUDA
// error of the query.
int chunked_linear_occupancy(int d, int chunk, int ctas_per_sm, void* out) {
  int* o = static_cast<int*>(out);
  if (chunk < 1 || ctas_per_sm < 0 || o == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return static_cast<int>(chunked_linear::occupancy<16>(chunk, ctas_per_sm, o));
    case 32: return static_cast<int>(chunked_linear::occupancy<32>(chunk, ctas_per_sm, o));
    case 64: return static_cast<int>(chunked_linear::occupancy<64>(chunk, ctas_per_sm, o));
    case 128: return static_cast<int>(chunked_linear::occupancy<128>(chunk, ctas_per_sm, o));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide path (heads past 128), two launches a call with the same
// arguments, chunked_linear_scores first: q, k (b, n, H, dk) and v (b, n,
// H, dv) bf16 as above; log_decay, s0, out, s_out as above; scores fp32 of
// (b H nc, cp, cp) floats, nc = ceil(n / chunk), cp = chunk rounded up to
// 64 (scratch: the first launch writes it, the second reads it); sync (1 +
// b H ceil(dk / 64) ceil(dv / 64)) int32, zero (each call leaves it zero
// again). dk, dv multiples of 8, dk up to 1024, dv up to 1032; 1 <= chunk
// <= min(n, 256). Each returns the CUDA error of its launch.
#define WIDE_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *log_decay,       \
      const void *s0, void *scores, void *out, void *s_out, void *sync,     \
      long long q_sb, long long q_sn, long long q_sh, long long k_sb,       \
      long long k_sn, long long k_sh, long long v_sb, long long v_sn,       \
      long long v_sh, int b, int n, int H, int dk, int dv, int chunk,       \
      void *stream

#define WIDE_PARAMS(a)                                                      \
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},   \
                  vs[3] = {v_sb, v_sn, v_sh};                               \
  chunked_linear::WideParams a{};                                           \
  if (!chunked_linear::wide_params(a, q, k, v, log_decay, s0, scores, out,  \
                                   s_out, sync, qs, ks, vs, b, n, H, dk,    \
                                   dv, chunk))                              \
    return static_cast<int>(cudaErrorInvalidValue);

int chunked_linear_scores(WIDE_ARGS) {
  WIDE_PARAMS(a)
  return static_cast<int>(chunked_linear::launch_scores(
      a, static_cast<cudaStream_t>(stream)));
}

int chunked_linear_wide(WIDE_ARGS) {
  WIDE_PARAMS(a)
  if (sync == nullptr || out == nullptr || s_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(chunked_linear::launch_wide(
      a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
