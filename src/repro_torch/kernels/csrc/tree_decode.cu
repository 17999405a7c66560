// Prefix-trie (cascade) bifurcated flash-decode kernels for Hopper
// (sm_90a), with a plain C interface for ctypes (kernels/_build.py builds
// this file with nvcc, in parallel with the other sources;
// kernels/bifurcated_decode.py binds and launches it). Both are instances
// of the kernel template in decode_common.cuh (mode kTree), beside the
// single-prefix and grouped kernels, and share its stream, online update
// and int8 conversion.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bifurcated_decode.py:
//   * tree_fused_bifurcated_decode (_tree_fused_kernel): N trie-node
//     segments (N, g, m_c, hd) bf16 with ragged live lengths node_lens
//     (N,), and a (depth, rows) row -> node table (-1 = level unused):
//     each row attends over every node on its path (OR membership over
//     the levels, so a node repeated on one path counts once) and then
//     over its own sample's decode slots;
//   * tree_fused_bifurcated_decode_q8 (_tree_fused_q8_kernel): the same
//     over int8 nodes and (N, g, m_c) f32 scales, k_scale carrying the
//     logit scale pre-folded.
//
// What bounds them on an H100: bytes. Every node referenced by a path is
// read once per kv head per step, however many paths go through it (the
// reference's IO claim): the sum of the referenced nodes' live lengths,
// 2 * hd bytes per key and head in bf16, hd + 4 in int8, plus the live
// decode slots, q and the output.
//
// What the design does about it: one CTA per (64-row tile, kv head), as
// the single-prefix kernel. The CTA first reads its rows' path table into
// shared memory and marks the node ids on those paths in a bitmap, then
// streams each marked node in ascending id order (the order in which the
// Pallas grid walks nodes) over its live blocks only, ceil(node_lens[n] /
// 64) of them, read from device memory. A row whose path does not hold
// the node gets its logits at kNegInf: exact, since the first block of a
// row's own node wipes what came before (corr = exp(kNegInf - m) = 0), and
// after it the masked block adds exp(kNegInf - m) = 0. A warp none of
// whose 16 rows is on the node skips the products. Then the tile's decode
// arm and the normalised output; rows whose path holds an id outside
// [-1, N) are written as NaN. At the main path (64 rows) there is one tile
// per kv head, so each node is read once per kv head per step.
//
// Both kernels split that walk (splits > 1, the default on the card;
// decode_common.cuh, split_kernel), since 8 CTAs on 132 SMs, each walking
// every node one block at a time, take ~540 us (#6) and ~740 us (#7) at
// the main trie (splits=1 runs that single walk, whose bits equal #4's /
// #5's at depth 1). The nodes' blocks and the decode arm are cut into
// pieces of 256 keys (a piece's bounds set by its own node's length alone)
// spread over S = 33 CTAs per (tile, kv head), each piece's fp32 partials
// merged exactly per row by a second kernel: #7 ~60 us on an H100
// (PERF.md). #6's nodes stream through three bf16 cp.async stages with
// nothing to convert (stream_bf16_nodes), #7's through two int8 stages
// converted to bf16 in shared memory (stream_split). What holds them: each
// block's chain of dependent steps at two CTAs an SM, and the per-CTA
// set-up (paths, node list, lengths) before the first block.

#include "decode_common.cuh"

using bifurcated::dispatch_split;
using bifurcated::fused_params;
using bifurcated::kTree;
using bifurcated::Params;

extern "C" {

// q (g, rows, hd) bf16; k_ctx/v_ctx (N, g, m_c, hd) bf16; paths
// (depth, rows) i32; node_lens (N,) i32; k_dec/v_dec (g, ld, hd) bf16;
// dec_bias (ld,) f32; out (g, rows, hd) bf16; in `splits` shares per (row
// tile, kv head); part: the split walk's f32 scratch (g * rows *
// (max_pieces * (hd + 2) + 1) floats) when splits > 1. Returns the CUDA
// error of the launch (0 when it was accepted).
int tree_fused_bifurcated_decode(const void* q, const void* k_ctx,
                                 const void* v_ctx, const void* paths,
                                 const void* node_lens, const void* k_dec,
                                 const void* v_dec, const void* dec_bias,
                                 void* out, void* part, int n_nodes,
                                 int depth, int g, int rows, int m_c, int ld,
                                 int hd, int c_d, int pn, int splits,
                                 int max_pieces, float scale, void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.paths = static_cast<const int*>(paths);
  a.ctx_lens = static_cast<const int*>(node_lens);
  a.n_groups = n_nodes;
  a.depth = depth;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(
      dispatch_split<kTree, false>(a, hd, static_cast<cudaStream_t>(stream)));
}

// As tree_fused_bifurcated_decode with int8 k_ctx/v_ctx (N, g, m_c, hd) and
// f32 k_scale/v_scale (N, g, m_c).
int tree_fused_bifurcated_decode_q8(
    const void* q, const void* k_ctx, const void* v_ctx, const void* k_scale,
    const void* v_scale, const void* paths, const void* node_lens,
    const void* k_dec, const void* v_dec, const void* dec_bias, void* out,
    void* part, int n_nodes, int depth, int g, int rows, int m_c, int ld,
    int hd, int c_d, int pn, int splits, int max_pieces, float scale,
    void* stream) {
  Params a = fused_params(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, g,
                          rows, m_c, ld, c_d, pn, scale);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.paths = static_cast<const int*>(paths);
  a.ctx_lens = static_cast<const int*>(node_lens);
  a.n_groups = n_nodes;
  a.depth = depth;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(
      dispatch_split<kTree, true>(a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
