// Flash prefill attention for Hopper (sm_90a), with a plain C interface for
// ctypes (kernels/_build.py builds this file with nvcc,
// kernels/flash_prefill.py binds and launches it).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py:108
// (flash_prefill_attention, _flash_kernel): causal or sliding-window GQA
// attention over a whole sequence, q (b, n, h, hd) against k, v (b, m, g,
// hd), h = g * p, with fp32 logits scaled by hd^-0.5, keys at or past m
// masked, the causal mask k_pos <= q_pos, the window k_pos > q_pos - window,
// masked logits at -1e30, an fp32 online softmax (max, sumexp, acc)
// corrected by the ratio of the old and new maxima, the softmax weights cast
// to bf16 before the value product (accumulated in fp32), and the output
// acc / max(l, 1e-30). One generalisation: query row i sits at position
// q_offset + i (the suffix prefill over cached keys, the reference's
// flash_chunked_attention(q_offset=)).
//
// What bounds it on an H100: operations. A causal prefill of n tokens does
// 2 * n^2 * hd * h multiply-adds' worth of operations (both products, half
// the (q, k) pairs): 274.9 GFLOP at n 8192, h 16, hd 128, about 278 us at
// 989 TFLOP/s, against ~101 MB of q, K, V and output, about 30 us at
// 3.35 TB/s. Only wgmma reaches that rate, and only if the tensor cores
// never wait for the softmax or for a load.
//
// What the design does about it:
//   * a CTA of three warpgroups works on (batch, kv head, tile of 128 query
//     rows) items: a producer warp issues TMA loads, two consumer
//     warpgroups of 64 rows each run both products on wgmma (setmaxnreg
//     moves the producer's registers to them). Row r of a kv head is
//     position r / p of query head gi * p + r % p, so each K/V tile serves
//     all p heads of the group; a tile holds 128 / p whole positions (126
//     rows at p 3);
//   * q and the output keep their (b, n, h, hd) layout: the Q tile is one
//     4-D TMA box (hd slab, p heads, 128 / p positions, 1 batch), the K and
//     V tiles (128 keys) boxes of a (hd, g, m, b) map; out-of-range rows
//     and keys arrive as zeros. hd 64 and 128 load 64-element slabs under
//     the 128-byte swizzle, hd 16, 80 and 112 16-element slabs under the
//     32-byte one; the wgmma descriptors read the same layouts (Q and K
//     K-major, V MN-major);
//   * K and V run through a ring of three stages with full (TMA bytes) and
//     empty (one arrival per consumer warp) mbarriers;
//   * S = Q K^T is wgmma m64n128k16 from shared memory; the fp32 softmax
//     stays in registers and P, rounded to bf16 there, is the register A
//     operand of O += P V (m64n{hd}k16); each warpgroup issues S(j) before
//     O += P(j-1) V(j-1) and runs softmax(j) under the latter, and the
//     tensor cores interleave the two warpgroups' products, so one's
//     softmax also runs under the other's wgmma (making them take turns on
//     named barriers ran slower). The softmax is what limits: its steps
//     run both rows and four chains a row at once;
//   * masks cost nothing on the blocks that do not cut the causal diagonal,
//     the window edge or the end of the keys; the key loop runs from the
//     block of the tile's first window edge to its causal limit, so no
//     block wholly outside is read (the Pallas kernel still copies them);
//   * the CTAs are persistent, one per SM: they take the items longest
//     first, in a snake order that evens out their work, and the producer
//     loads the next item's Q and K/V while the consumers finish the last;
//   * when the items cannot fill the SMs (a short suffix over a long
//     prefix, a single query), the wrapper asks for s key splits: each
//     item walks 1/s of its tile's key blocks and writes fp32 partials
//     (max, sum, acc) to scratch the wrapper allocates, and a second kernel
//     merges them: m = max m_i, l = sum l_i 2^(m_i - m), acc likewise, out
//     = acc / max(l, 1e-30).
// Blocks wholly masked for a row are exact to visit: before the row's first
// live key they leave finite garbage under m = -1e30 that the first live
// block wipes (its correction 2^(-1e30 - m_new) is 0); after, they add 0.
// The running max is kept in log2 units (logits times scale * log2 e), so
// every exponential is one exp2.
//
// bf16 only: the wrapper raises TypeError for any other dtype on the card
// (float32 runs the plain version on the CPU).

#include <cuda.h>   // CUtensorMap; the encoder is fetched from the driver at
                    // run time, so the library links nothing new

#include "decode_common.cuh"

namespace flash_prefill {

using bifurcated::kMinL;
using bifurcated::kNegInf;
using bifurcated::pack_bf16;

constexpr int kTileRows = 128;       // query rows per CTA
constexpr int kBlockN = 128;         // keys per K/V tile
constexpr int kStages = 3;           // K/V ring depth
constexpr int kConsumerWarps = 8;    // two consumer warpgroups
constexpr int kThreads = 384;        // producer warpgroup + two consumers
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* out;       // (b, n, h, HD)
  float* part;              // splits > 1: (splits, ctiles, 128, HD) acc, then
                            // (splits, ctiles, 128, 2) (max, sum)
  int b, n, m, h, g, p;
  int tile_pos;             // positions per tile: 128 / p
  int tiles;                // ceil(n / tile_pos)
  int splits;               // key splits per tile
  int q_offset, window, causal;
  float scale_log2;         // hd^-0.5 * log2 e
};

// the shared-memory tiles of one head dim
template <int HD>
struct Tile {
  static constexpr int SW = HD % 64 == 0 ? 64 : 16;   // elements per row
  static constexpr int SLABS = HD / SW;
  static constexpr int ROWB = SW * 2;                   // bytes per row
  static constexpr uint64_t LAYOUT = SW == 64 ? 1 : 3;  // 128 B / 32 B swizzle
  static constexpr int Q_SLAB = kTileRows * ROWB;
  static constexpr int KV_SLAB = kBlockN * ROWB;
  static constexpr int Q_BYTES = kTileRows * HD * 2;
  static constexpr int KV_BYTES = kBlockN * HD * 2;
  // alignment slack, Q, the K/V ring and its mbarriers (Q full and empty,
  // each stage's K and V full and empty)
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (2 + 4 * kStages);
  static_assert(SMEM <= 232448, "more than a block's 227 KB");
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of registers a wgmma owns across
// its issue and wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x, one MUFU.EX2 (2^-huge = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 3: 32 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// d (64 x 128 fp32, scale_d 0: overwritten) += A (64 x 16, shared, K-major)
// x B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16 fp32) += A (64 x 16 bf16, registers) x B (16 x 16,
// shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) x B (16 x 64,
// shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80 fp32) += A (64 x 16 bf16, registers) x B (16 x 80,
// shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 112 fp32) += A (64 x 16 bf16, registers) x B (16 x 112,
// shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) x B (16 x 128,
// shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (HD == 112) wgmma_rs_n112(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// one work item: a key split of a (batch, kv head, tile); items run
// longest first (the last tiles see the most keys), splits side by side
struct Work {
  int part, tile, gi, bi, pos0;
  int jb, je;   // its key blocks [jb, je)
};

__device__ __forceinline__ Work work(const Params& a, int item) {
  Work w;
  const int heads = a.b * a.g;
  w.part = item % a.splits;
  const int rest = item / a.splits;
  w.tile = a.tiles - 1 - rest / heads;
  w.gi = rest % heads % a.g;
  w.bi = rest % heads / a.g;
  w.pos0 = w.tile * a.tile_pos;
  // the tile's key blocks: [block of its first position's window edge, its
  // last position's causal limit); this split's share of them
  const int last_pos = min(w.pos0 + a.tile_pos, a.n) - 1;
  const int col_end = a.causal ? min(a.m, a.q_offset + last_pos + 1) : a.m;
  const int blk0 =
      a.window > 0 ? max(0, a.q_offset + w.pos0 - a.window + 1) / kBlockN : 0;
  const int nblk = max(0, (col_end + kBlockN - 1) / kBlockN - blk0);
  w.jb = blk0 + w.part * nblk / a.splits;
  w.je = blk0 + (w.part + 1) * nblk / a.splits;
  return w;
}

// the items of a persistent CTA: round r takes item r * G + k, or
// r * G + G - 1 - k in odd rounds (G CTAs, this one k), so the long and
// short items of the longest-first order even out across CTAs
__device__ __forceinline__ int item_of(int round) {
  const int G = static_cast<int>(gridDim.x), k = static_cast<int>(blockIdx.x);
  return round * G + (round % 2 ? G - 1 - k : k);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using T = Tile<HD>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;        // S K tiles
  const uint32_t sV = sK + S * T::KV_BYTES;   // S V tiles
  const uint32_t bars = sV + S * T::KV_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  // k full, k empty, v full, v empty of stage s
  auto bar = [&](int kind, int s) { return bars + 8 * (2 + kind * S + s); };
  const int items = a.tiles * a.b * a.g * a.splits;
  const int tile_rows = a.tile_pos * a.p;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), kConsumerWarps);
      mbar_init(bar(2, s), 1);
      mbar_init(bar(3, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load, the K/V ring running on from
    // one item to the next
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, qph = 0;
      for (int round = 0, item; (item = item_of(round)) < items; ++round) {
        const Work w = work(a, item);
        if (w.jb >= w.je) continue;
        mbar_wait(q_empty, qph ^ 1);   // the last item's S products are done
        qph ^= 1;
        mbar_expect_tx(q_full, T::SLABS * T::SW * tile_rows * 2);
#pragma unroll
        for (int s = 0; s < T::SLABS; ++s)
          tma_load_4d(sQ + s * T::Q_SLAB, &tm_q, q_full, s * T::SW,
                      w.gi * a.p, w.pos0, w.bi);
        for (int j = w.jb; j < w.je; ++j) {
          mbar_wait(bar(1, stage), phase ^ 1);
          mbar_expect_tx(bar(0, stage), T::KV_BYTES);
#pragma unroll
          for (int s = 0; s < T::SLABS; ++s)
            tma_load_4d(sK + stage * T::KV_BYTES + s * T::KV_SLAB, &tm_k,
                        bar(0, stage), s * T::SW, w.gi, j * kBlockN, w.bi);
          mbar_wait(bar(3, stage), phase ^ 1);
          mbar_expect_tx(bar(2, stage), T::KV_BYTES);
#pragma unroll
          for (int s = 0; s < T::SLABS; ++s)
            tma_load_4d(sV + stage * T::KV_BYTES + s * T::KV_SLAB, &tm_v,
                        bar(2, stage), s * T::SW, w.gi, j * kBlockN, w.bi);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes tile rows 64c .. 64c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int r0 = 64 * c + 16 * (t / 32) + gr;   // rows r0 (i 0), r0 + 8 (i 1)
  const float sl2 = a.scale_log2;
  const int ctiles = a.b * a.g * a.tiles;

  float o[HD / 2];
  float s[kBlockN / 2];
  uint32_t pf[kBlockN / 16][4];
  float mrow[2], lrow[2], corr[2];
  int qpos[2];
  int plo = 0, phi = 0;   // the warpgroup's live positions in the item

  // S = Q K^T of the K tile in stage ks, in s
  auto issue_s = [&](int ks) {
    const uint32_t qa = sQ + 64 * c * T::ROWB;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int sl = kk * 16 / T::SW, in = kk * 16 % T::SW;
      wgmma_ss_n128(
          s, smem_desc(qa + sl * T::Q_SLAB + in * 2, 16, 8 * T::ROWB, T::LAYOUT),
          smem_desc(sK + ks * T::KV_BYTES + sl * T::KV_SLAB + in * 2, 16,
                    8 * T::ROWB, T::LAYOUT),
          kk > 0);
    }
    wg_commit();
    pin(s);
  };
  // O = O * corr + P V of the V tile in stage vs
  auto issue_pv = [&](int vs) {
#pragma unroll
    for (int x = 0; x < HD / 8; ++x) {
      o[4 * x] *= corr[0];
      o[4 * x + 1] *= corr[0];
      o[4 * x + 2] *= corr[1];
      o[4 * x + 3] *= corr[1];
    }
    pin(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs<HD>(o, pf[kk],
                   smem_desc(sV + vs * T::KV_BYTES + kk * 16 * T::ROWB,
                             T::KV_SLAB, 8 * T::ROWB, T::LAYOUT));
    wg_commit();
    pin(o);
  };
  // the online softmax of rows r0 (i 0) and r0 + 8 (i 1) over key block j:
  // the thread's columns 8x + 2tq + e, in s[4x + 2i + e]; P stays in s.
  // Both rows go through each step together, and maxima and sums run in
  // four chains a row: the steps' latency, not their operations, is what
  // the softmax costs between two products
  auto softmax = [&](int j) {
    const int c0 = j * kBlockN;
    const bool masked = c0 + kBlockN > a.m ||
                        (a.causal && c0 + kBlockN - 1 > plo) ||
                        (a.window > 0 && c0 <= phi - a.window);
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = kNegInf;
    if (masked) {   // scaled logits, masked ones at -1e30
#pragma unroll
      for (int x = 0; x < kBlockN / 8; ++x)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c0 + 8 * x + 2 * tq + e;
            bool ok = key < a.m;
            if (a.causal) ok = ok && key <= qpos[i];
            if (a.window > 0) ok = ok && key > qpos[i] - a.window;
            const float v = ok ? s[4 * x + 2 * i + e] * sl2 : kNegInf;
            s[4 * x + 2 * i + e] = v;
            acc[i][(2 * x + e) % 4] = fmaxf(acc[i][(2 * x + e) % 4], v);
          }
    } else {        // raw logits: every key live for every row
#pragma unroll
      for (int x = 0; x < kBlockN / 8; ++x)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[i][(2 * x + e) % 4] =
                fmaxf(acc[i][(2 * x + e) % 4], s[4 * x + 2 * i + e]);
    }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m_new[i] = fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3]));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!masked) m_new[i] *= sl2;
      m_new[i] = fmaxf(mrow[i], m_new[i]);
      corr[i] = ex2(mrow[i] - m_new[i]);
      mrow[i] = m_new[i];
    }
    if (masked) {
#pragma unroll
      for (int x = 0; x < kBlockN / 8; ++x)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[4 * x + 2 * i + e] = ex2(s[4 * x + 2 * i + e] - m_new[i]);
    } else {        // the scale inside the exp2
#pragma unroll
      for (int x = 0; x < kBlockN / 8; ++x)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[4 * x + 2 * i + e] =
                ex2(fmaf(s[4 * x + 2 * i + e], sl2, -m_new[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll
    for (int x = 0; x < kBlockN / 8; ++x)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[i][(2 * x + e) % 4] += s[4 * x + 2 * i + e];
#pragma unroll
    for (int i = 0; i < 2; ++i)   // this thread's columns only
      lrow[i] = lrow[i] * corr[i] +
                ((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]));
  };
  // P to bf16: the accumulator's fragment is the A operand's
  auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // one arrival per warp on an empty barrier: the tile is consumed
  auto release = [&](uint32_t empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  int ks = 0, vs = 0;
  uint32_t kph = 0, vph = 0, qph = 0;
  for (int round = 0, item; (item = item_of(round)) < items; ++round) {
    const Work w = work(a, item);
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      live[i] = r < tile_rows && w.pos0 + r / a.p < a.n;
      qpos[i] = a.q_offset + w.pos0 + r / a.p;
    }
    const int wend = min(min(64 * c + 64, tile_rows), (a.n - w.pos0) * a.p);
    plo = a.q_offset + w.pos0 + 64 * c / a.p;
    phi = a.q_offset + w.pos0 + max(wend - 1, 64 * c) / a.p;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    mrow[0] = mrow[1] = kNegInf;
    lrow[0] = lrow[1] = 0.f;

    if (w.jb < w.je) {
      mbar_wait(q_full, qph);
      qph ^= 1;
      // block jb: S only
      mbar_wait(bar(0, ks), kph);
      issue_s(ks);
      wg_wait<0>();
      pin(s);
      release(bar(1, ks));
      if (++ks == S) {
        ks = 0;
        kph ^= 1;
      }
      softmax(w.jb);
      to_bf16();
      // block j: S(j) issued, then O += P(j-1) V(j-1) under softmax(j)
      for (int j = w.jb + 1; j < w.je; ++j) {
        mbar_wait(bar(0, ks), kph);
        issue_s(ks);
        mbar_wait(bar(2, vs), vph);
        issue_pv(vs);
        wg_wait<1>();
        pin(s);
        release(bar(1, ks));
        if (++ks == S) {
          ks = 0;
          kph ^= 1;
        }
        softmax(j);
        wg_wait<0>();
        pin(o);
        release(bar(3, vs));
        if (++vs == S) {
          vs = 0;
          vph ^= 1;
        }
        to_bf16();
      }
      release(q_empty);   // every S product of the item is done
      // the last block's P V
      mbar_wait(bar(2, vs), vph);
      issue_pv(vs);
      wg_wait<0>();
      pin(o);
      release(bar(3, vs));
      if (++vs == S) {
        vs = 0;
        vph ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    }
    const int ct = (w.bi * a.g + w.gi) * a.tiles + w.tile;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const int r = r0 + 8 * i;
      if (a.splits == 1) {
        const float inv = 1.f / fmaxf(lrow[i], kMinL);
        __nv_bfloat16* dst =
            a.out + ((static_cast<size_t>(w.bi) * a.n + w.pos0 + r / a.p) *
                         a.h + w.gi * a.p + r % a.p) * HD;
#pragma unroll
        for (int x = 0; x < HD / 8; ++x)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x + 2 * tq) =
              __floats2bfloat162_rn(o[4 * x + 2 * i] * inv,
                                    o[4 * x + 2 * i + 1] * inv);
      } else {
        const size_t row =
            (static_cast<size_t>(w.part) * ctiles + ct) * kTileRows + r;
        float* acc = a.part + row * HD;
#pragma unroll
        for (int x = 0; x < HD / 8; ++x)
          *reinterpret_cast<float2*>(acc + 8 * x + 2 * tq) =
              make_float2(o[4 * x + 2 * i], o[4 * x + 2 * i + 1]);
        if (tq == 0) {
          float* ml = a.part + static_cast<size_t>(a.splits) * ctiles *
                                   kTileRows * HD;
          *reinterpret_cast<float2*>(ml + 2 * row) =
              make_float2(mrow[i], lrow[i]);
        }
      }
    }
  }
}

// merges the key splits' partials of every live row: one thread per
// (tile row, column)
__global__ void merge_splits(const Params a, int hd) {
  const int ctiles = a.b * a.g * a.tiles;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(ctiles) * kTileRows * hd) return;
  const int col = static_cast<int>(idx % hd);
  const int r = static_cast<int>(idx / hd % kTileRows);
  const int ct = static_cast<int>(idx / hd / kTileRows);
  const int tile = ct % a.tiles, gi = ct / a.tiles % a.g,
            bi = ct / a.tiles / a.g;
  const int pos = tile * a.tile_pos + r / a.p;
  if (r >= a.tile_pos * a.p || pos >= a.n) return;
  const float* ml = a.part + static_cast<size_t>(a.splits) * ctiles *
                                 kTileRows * hd;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s)
    mx = fmaxf(mx, ml[2 * ((static_cast<size_t>(s) * ctiles + ct) *
                               kTileRows + r)]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const size_t row = (static_cast<size_t>(s) * ctiles + ct) * kTileRows + r;
    const float w = exp2f(ml[2 * row] - mx);
    l += ml[2 * row + 1] * w;
    acc += a.part[row * hd + col] * w;
  }
  a.out[((static_cast<size_t>(bi) * a.n + pos) * a.h + gi * a.p + r % a.p) *
            hd + col] = __float2bfloat16_rn(acc / fmaxf(l, kMinL));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over a (b, len, heads, hd) bf16 tensor, innermost first, with
// boxes of (sw, box_heads, box_len, 1)
bool encode(CUtensorMap* map, const void* ptr, int b, int len, int heads,
            int hd, int sw, int box_heads, int box_len) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(len) * heads * hd * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw),
                             static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_len), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Params& a, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, a.b, a.n, a.h, HD, T::SW, a.p, a.tile_pos) ||
      !encode(&tk, k, a.b, a.m, a.g, HD, T::SW, 1, kBlockN) ||
      !encode(&tv, v, a.b, a.m, a.g, HD, T::SW, 1, kBlockN))
    return cudaErrorInvalidValue;
  auto kern = flash_prefill_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  // persistent CTAs, one per SM, or one per item where there are fewer
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long items =
      static_cast<long long>(a.tiles) * a.g * a.b * a.splits;
  const unsigned ctas = static_cast<unsigned>(items < sms ? items : sms);
  kern<<<ctas, kThreads, T::SMEM, stream>>>(tq, tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long threads =
      static_cast<long long>(a.tiles) * a.g * a.b * kTileRows * HD;
  merge_splits<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                 stream>>>(a, HD);
  return cudaGetLastError();
}

}  // namespace flash_prefill

extern "C" {

// q (b, n, h, hd), k/v (b, m, g, hd), out (b, n, h, hd), all bf16,
// contiguous and 16-byte aligned; h a multiple of g with h / g <= 128;
// causal 0 or 1; window 0 (none) or > 0, and only with causal. splits >= 1
// key splits per tile; above 1, part is fp32 scratch of splits * ctiles *
// 128 * (hd + 2) floats, ctiles = b * g * ceil(n / (128 / (h / g))). Head
// dims 16, 64, 80, 112 and 128. Returns the CUDA error of the launches (0
// when they were accepted).
int flash_prefill_attention(const void* q, const void* k, const void* v,
                            void* out, void* part, int b, int n, int m, int h,
                            int g, int hd, int q_offset, int window,
                            int causal, int splits, float scale,
                            void* stream) {
  using flash_prefill::Params;
  if (b <= 0 || n <= 0 || m <= 0 || g <= 0 || h <= 0 || h % g != 0 ||
      h / g > flash_prefill::kTileRows || q_offset < 0 || window < 0 ||
      (window > 0 && !causal) || splits < 1 || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.b = b;
  a.n = n;
  a.m = m;
  a.h = h;
  a.g = g;
  a.p = h / g;
  a.tile_pos = flash_prefill::kTileRows / a.p;
  const long long tiles = (static_cast<long long>(n) + a.tile_pos - 1) /
                          a.tile_pos;
  if (static_cast<long long>(n) * a.p > (1LL << 30) ||
      tiles * g * b * splits > 0x7fffffffLL ||
      tiles * g * b * flash_prefill::kTileRows * hd > 0x7fffffffLL * 256LL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.splits = splits;
  a.q_offset = q_offset;
  a.window = window;
  a.causal = causal ? 1 : 0;
  a.scale_log2 = scale * flash_prefill::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(flash_prefill::launch<16>(q, k, v, a, s));
    case 64: return static_cast<int>(flash_prefill::launch<64>(q, k, v, a, s));
    case 80: return static_cast<int>(flash_prefill::launch<80>(q, k, v, a, s));
    case 112:
      return static_cast<int>(flash_prefill::launch<112>(q, k, v, a, s));
    case 128:
      return static_cast<int>(flash_prefill::launch<128>(q, k, v, a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
