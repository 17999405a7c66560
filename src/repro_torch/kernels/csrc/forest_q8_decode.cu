// Int8-context and multi-prefix (forest) bifurcated flash-decode kernels
// for Hopper (sm_90a), with a plain C interface for ctypes
// (kernels/_build.py builds this file with nvcc, in parallel with
// bifurcated_decode.cu; kernels/bifurcated_decode.py binds and launches it).
// All three are instances of the kernel template in decode_common.cuh,
// beside the bf16 single-prefix kernel, and share its online update.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bifurcated_decode.py:
//   * fused_bifurcated_decode_q8 (_fused_q8_kernel): the single-prefix
//     fused decode with an int8 context arm — int8 K_c/V_c (g, m_c, hd)
//     plus f32 per-(token, head) scales (g, m_c), k_scale carrying the
//     logit scale pre-folded; the decode arm stays bf16;
//   * grouped_fused_bifurcated_decode (_grouped_fused_kernel): the forest
//     decode over G context segments (G, g, m_c, hd) with ragged live
//     lengths ctx_lens (G,) and a row -> segment map (rows,);
//   * grouped_fused_bifurcated_decode_q8 (_grouped_fused_q8_kernel): the
//     forest decode over int8 segments and (G, g, m_c) scales.
//
// What bounds them on an H100: bytes, as for the bf16 kernel. The int8
// context arm reads 1 byte per element plus 8 bytes of scales per
// (token, head): at g=8, m_c=8192, hd=128 that is 17.3 MB against the
// bf16 arm's 33.5 MB. The forest reads each live segment once per kv head:
// sum over segments of ctx_lens, not the slab's capacity.
//
// What the designs do about it:
//   * q8: each int8 block is read once for all rows of a (kv head, 64-row
//     tile); cp.async stages the int8 block and both scale vectors, it is
//     converted to bf16 in shared memory (exact), and the tensor-core path
//     of the bf16 kernel computes both products (see decode_common.cuh for
//     the folds). The single walk (splits=1: one CTA per kv head and row
//     tile, 8 CTAs at the main path) took ~460 us against a 5.8 us bound,
//     paced by each block's serial copy, convert and product steps. So the
//     walk is split (splits > 1, the default on the card; decode_common.cuh,
//     split_kernel, mode kSingle): the context in pieces of 256 keys from
//     key 0, then the tile's decode slots in pieces of as many, over S = 33
//     CTAs per (tile, kv head) at the main path, each piece from a fresh
//     fp32 state, merged exactly per row by a second kernel. These are #9's
//     pieces on a single prefix, streamed by #9's int8 stages (each thread
//     converts the chunks it copied, one barrier a block), so #3 gives #9's
//     bits at any S > 1 and any page size. A call is one launch, split or
//     not.
//     What holds it now: as #9 (the per-block chain of steps, whole pieces,
//     the merge, the wrapper's host work; PERF.md).
//   * grouped, the single walk (splits=1): one CTA per (kv head, segment,
//     64-row tile). A row reads exactly one segment, group_ids of its
//     sample, so no merge across segments is needed: the CTA of segment gi
//     reads ctx_lens[gi] from device memory, walks only the blocks below
//     it (reading each live segment once per kv head and row tile), folds
//     in the decode arm of its tile's samples, and writes only the rows
//     assigned to gi. A CTA whose tile holds no row of gi exits at once.
//     Skipping blocks past ctx_lens is exact where the Pallas kernel
//     streams and masks them: every served row has a live decode slot, so
//     its running max is finite and masked keys contribute exactly 0. At
//     the main path (G = 4, g = 8, one row tile) that grid is 32 CTAs on
//     132 SMs, and the CTA of the longest segment (8192 keys) sets the
//     pace: #5 took ~600 us against a 12.0 us bound (40.3 MB), #4 ~470 us
//     against 22.4 us (75.0 MB).
//   * grouped, split (#4 and #5 at splits > 1, the default on the card;
//     decode_common.cuh, split_kernel mode kGrouped): the forest is the
//     trie at depth 1, its path table row_group itself (no copy), so #5 is
//     #7's split walk and #4 #6's: each segment on a tile's rows in
//     256-key pieces from its first key, the decode slots likewise, S = 33
//     CTAs per (tile, kv head) at the main path, merged exactly. #4
//     streams its bf16 segments as #6 its nodes (stream_bf16_nodes, three
//     bf16 stages, nothing to convert), #5 its int8 ones as #7
//     (stream_split). A tile reads each of its rows' segments once,
//     whatever the rows' order, and computes each row only against its own
//     segment's pieces. A piece's bounds depend on its own segment's
//     length alone, so a row's bits do not move when another group is
//     cancelled, retired or readmitted, nor with S; on rows of ids in
//     [0, G) they are #7's (#4: #6's) at depth 1. An id of -1 is out of
//     range here (a NaN row, as in the single walk), where the trie reads
//     no node at that level.
// Known limits: at splits=1 both keep the single walk above (the
// comparisons with it and its profiles call it so).

#include "decode_common.cuh"

using bifurcated::dispatch_split;
using bifurcated::fused_params;
using bifurcated::kGrouped;
using bifurcated::kSingle;
using bifurcated::Params;

extern "C" {

// q (g, rows, hd) bf16; k_ctx/v_ctx (g, m_c, hd) int8; k_scale/v_scale
// (g, m_c) f32; k_dec/v_dec (g, ld, hd) bf16; dec_bias (ld,) f32; out
// (g, rows, hd) bf16; `splits` and part as in fused_bifurcated_decode.
// Returns the CUDA error of the launch.
int fused_bifurcated_decode_q8(const void* q, const void* k_ctx,
                               const void* v_ctx, const void* k_scale,
                               const void* v_scale, const void* k_dec,
                               const void* v_dec, const void* dec_bias,
                               void* out, void* part, int g, int rows,
                               int m_c, int ld, int hd, int c_d, int pn,
                               int splits, int max_pieces, float scale,
                               void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(dispatch_split<kSingle, true>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// q (g, rows, hd) bf16; k_ctx/v_ctx (G, g, m_c, hd) bf16; row_group (rows,)
// i32; ctx_lens (G,) i32; k_dec/v_dec (g, ld, hd) bf16; dec_bias (ld,) f32;
// out (g, rows, hd) bf16; `splits` and part as in fused_bifurcated_decode
// (the split walk's path table: row_group, one level deep).
int grouped_fused_bifurcated_decode(const void* q, const void* k_ctx,
                                    const void* v_ctx, const void* row_group,
                                    const void* ctx_lens, const void* k_dec,
                                    const void* v_dec, const void* dec_bias,
                                    void* out, void* part, int n_groups,
                                    int g, int rows, int m_c, int ld, int hd,
                                    int c_d, int pn, int splits,
                                    int max_pieces, float scale,
                                    void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.row_group = static_cast<const int*>(row_group);
  a.paths = a.row_group;    // (1, rows) is (rows,)
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.n_groups = n_groups;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(dispatch_split<kGrouped, false>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// As grouped_fused_bifurcated_decode with int8 k_ctx/v_ctx (G, g, m_c, hd)
// and f32 k_scale/v_scale (G, g, m_c); `splits` and part as in
// fused_bifurcated_decode_q8 (the split walk's path table: row_group, one
// level deep).
int grouped_fused_bifurcated_decode_q8(
    const void* q, const void* k_ctx, const void* v_ctx, const void* k_scale,
    const void* v_scale, const void* row_group, const void* ctx_lens,
    const void* k_dec, const void* v_dec, const void* dec_bias, void* out,
    void* part, int n_groups, int g, int rows, int m_c, int ld, int hd,
    int c_d, int pn, int splits, int max_pieces, float scale, void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.row_group = static_cast<const int*>(row_group);
  a.paths = a.row_group;    // (1, rows) is (rows,)
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.n_groups = n_groups;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(dispatch_split<kGrouped, true>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
