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
// Both are instances of the template in decode_common.cuh, which the int8,
// multi-prefix and prefix-trie kernels (forest_q8_decode.cu,
// tree_decode.cu) share.
//
// What bounds them on an H100: bytes. A decode step has b*p*n query rows
// per kv head (64 at the main path), so each K_c/V_c element is used by
// only that many rows: about 64 operations per byte read, far below the
// ~295 operations per byte at which the tensor cores, not HBM, become the
// limit. The context must be read at least once per launch:
// 2 * g * m_c * hd * 2 bytes (33.5 MB at g=8, m_c=8192, hd=128).
//
// What the design does about it: each K_c/V_c block is read from device
// memory ONCE for all the rows of a (kv head, tile of 64 query rows),
// which is all rows of the kv head at the main path, so the context is
// read once per launch, not once per sample (the paper's point). Blocks of
// 64 keys are staged through shared memory with cp.async and both products
// run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate);
// the running state stays in registers. The decode arm of a row tile
// covers only the decode slots of the samples in that tile, not all b
// samples. One CTA per (kv head, row tile) walking the whole context (the
// single walk, splits=1) leaves most of the card idle: 8 CTAs on 132 SMs
// at the main path, ~313 us against a 10.6 us bound. So the fused kernel
// splits the walk (splits > 1, the default on the card; decode_common.cuh,
// split_kernel, mode kSingle): the context in pieces of 256 keys from key
// 0 and the tile's decode slots in pieces of as many, spread over S = 33
// CTAs per (tile, kv head) at the main path (8 at zamba2's hd 112 shape,
// 32 kv heads), each piece summed from a fresh fp32 state, its partials
// merged exactly per row by a second kernel; the bf16 context streams
// through three cp.async stages with one barrier a block and nothing to
// convert. A call is one launch, split or not. What holds it now: the
// per-block chain of steps, whole pieces, the merge's pass over the
// partials and the wrapper's host work (PERF.md).
//
// context_flash_partials (the two-pass escape hatch of
// ops.bifurcated_decode_attention; no engine calls it) splits the same way
// (splits > 1, the default on the card): #1's context pieces with no
// decode arm (ld 0), the same split_kernel instance, and a merge that
// writes the unnormalised fp32 (acc, m, l) the two-pass merge reads in
// place of a bf16 output.
//
// Both take bf16 queries only: the wrapper raises TypeError for any other
// dtype on the card (float32 runs the plain version on the CPU).

#include "decode_common.cuh"

using bifurcated::dispatch_split;
using bifurcated::fused_params;
using bifurcated::kSingle;
using bifurcated::Params;

extern "C" {

// q (g, rows, hd), k_ctx/v_ctx (g, m_c, hd), k_dec/v_dec (g, ld, hd), all
// bf16; dec_bias (ld,) f32; out (g, rows, hd) bf16; in `splits` shares per
// (row tile, kv head); part: the split walk's f32 scratch (g * rows *
// (max_pieces * (hd + 2) + 1) floats) when splits > 1.
// Returns the CUDA error of the launch (0 when it was accepted).
int fused_bifurcated_decode(const void* q, const void* k_ctx,
                            const void* v_ctx, const void* k_dec,
                            const void* v_dec, const void* dec_bias, void* out,
                            void* part, int g, int rows, int m_c, int ld,
                            int hd, int c_d, int pn, int splits,
                            int max_pieces, float scale, void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(dispatch_split<kSingle, false>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// q (g, rows, hd), k_ctx/v_ctx (g, m_c, hd) bf16; acc (g, rows, hd), m and
// l (g, rows), all f32; in `splits` shares per (row tile, kv head); part:
// the split walk's f32 scratch (g * rows * (max_pieces * (hd + 2) + 1)
// floats) when splits > 1.
int context_flash_partials(const void* q, const void* k_ctx, const void* v_ctx,
                           void* acc, void* m, void* l, void* part, int g,
                           int rows, int m_c, int hd, int splits,
                           int max_pieces, float scale, void* stream) {
  Params a{};
  a.q = q;
  a.k_ctx = k_ctx;
  a.v_ctx = v_ctx;
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.n_groups = 1;
  a.g = g;
  a.rows = rows;
  a.m_c = m_c;
  a.ld = 0;     // no decode arm
  a.c_d = 1;
  a.pn = 1;
  a.depth = 1;
  a.scale = scale;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(dispatch_split<kSingle, false, false>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
