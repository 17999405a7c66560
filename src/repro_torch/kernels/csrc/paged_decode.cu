// Paged-pool bifurcated flash-decode kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (kernels/_build.py builds this file with
// nvcc, in parallel with the other sources; kernels/bifurcated_decode.py
// binds and launches it). Both are instances of the kernel template in
// decode_common.cuh (mode kPaged), beside the single-prefix, grouped and
// tree kernels, and share its stream, online update and int8 conversion.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bifurcated_decode.py:
//   * paged_fused_bifurcated_decode (:1139, _paged_fused_kernel): N context
//     segments whose keys lie in a shared head-major page pool
//     (P, g, pm, hd) bf16, addressed through per-segment page tables
//     (N, ppn) i32 (-1 = unallocated) with ragged live lengths seg_lens
//     (N,), and a (depth, rows) row -> segment table (-1 = level unused):
//     each row attends over every segment on its path and then over its
//     own sample's decode slots. One segment with every path 0 is the
//     single-prefix workload, depth 1 the forest, the full table the trie;
//   * paged_fused_bifurcated_decode_q8 (:1312, _paged_fused_q8_kernel): the
//     same over int8 pages and (P, g, pm) f32 scale pages, k_scale carrying
//     the logit scale pre-folded.
//
// What bounds them on an H100: bytes. The live pages of every segment on
// some path are read once per kv head per step (the live keys, 2 * hd
// bytes per key and head in bf16, hd + 8 in int8), plus the live decode
// slots, q, the output, the page tables and the path table. A retired
// segment (empty table row) and the pages past a segment's live length
// cost nothing.
//
// What the design does about it: the Pallas kernel walks a scalar-
// prefetched list of live pages along one sequential grid axis. Here,
// as in the tree kernels, one CTA per (64-row tile, kv head) builds its
// rows' path table and the set of segment ids on them in shared memory,
// then walks each segment of the set in ascending id over its live keys
// in 64-key blocks. Before a block is staged, its 64 keys' pool rows are
// computed once from the segment's page-table entries (page_tables[seg]
// [j / pm], row j % pm, kv head gi) into a row table in shared memory
// (2 x 64 ints, one per stage); the cp.async copies and the logit mask
// read that table, so a block may straddle pages of any size. Only live
// pages of segments on the tile's paths are read; page tables and lengths
// come from device memory (a step needs no host sync and no per-step
// list). The same logical contents give the tree kernel's bits at any
// page size. A -1 entry inside a live length is a hole: its keys are
// masked to kNegInf (a zero-filled key would carry a logit of 0) and never
// read. A live entry outside [-1, P) is never read and the rows on its
// segment are written as NaN, as are rows whose path holds an id outside
// [-1, N). That single walk (8 CTAs at the main path, one block at a
// time, plus a barrier and a row table per block) is what splits=1 runs:
// ~380 us (#8) and ~530 us (#9) single, ~650 and ~860 us on the trie, on
// an H100 (PERF.md); its bits equal #1's / #3's at splits=1 on a single
// prefix.
//
// Both kernels split the walk as #6 / #7 do (splits > 1, the default on
// the card; decode_common.cuh, split_kernel): 256-key pieces of each
// segment, cut by logical key position and never by page, over S = 33
// CTAs per (tile, kv head), fp32 partials merged exactly per row; each
// gives its tree kernel's bits on the same logical trie at any page size,
// and on a single prefix the split single-prefix kernel's (#8 #1's, #9
// #3's) at the same S. A staged key's page id is read from the segment's
// table as the block is staged (the page divided out by multiply and
// shift); a hole or an id outside the pool is masked and never read (#8
// flags each staged key, #9 stages its flag with its scales). #9: ~45 us
// single and ~61 us on the trie (PERF.md); what holds them is #7's.

#include "decode_common.cuh"

using bifurcated::dispatch_split;
using bifurcated::fused_params;
using bifurcated::kPaged;
using bifurcated::Params;

namespace {

Params paged_params(const void* q, const void* k_pages, const void* v_pages,
                    const void* page_tables, const void* seg_lens,
                    const void* paths, const void* k_dec, const void* v_dec,
                    const void* dec_bias, void* out, int n_pages, int n_segs,
                    int ppn, int page_m, int depth, int g, int rows, int ld,
                    int c_d, int pn, float scale) {
  Params a = fused_params(q, k_pages, v_pages, k_dec, v_dec, dec_bias, out,
                          g, rows, ppn * page_m, ld, c_d, pn, scale);
  a.page_tables = static_cast<const int*>(page_tables);
  a.ctx_lens = static_cast<const int*>(seg_lens);
  a.paths = static_cast<const int*>(paths);
  a.n_groups = n_segs;
  a.depth = depth;
  a.ppn = ppn;
  a.page_m = page_m;
  a.n_pages = n_pages;
  return a;
}

}  // namespace

extern "C" {

// q (g, rows, hd) bf16; k_pages/v_pages (P, g, pm, hd) bf16 (one layer's
// pool); page_tables (N, ppn) i32; seg_lens (N,) i32; paths (depth, rows)
// i32; k_dec/v_dec (g, ld, hd) bf16; dec_bias (ld,) f32; out (g, rows, hd)
// bf16; in `splits` shares per (row tile, kv head); part: the split walk's
// f32 scratch (g * rows * (max_pieces * (hd + 2) + 1) floats) when
// splits > 1. Returns the CUDA error of the launch (0 when it was
// accepted).
int paged_fused_bifurcated_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* seg_lens, const void* paths,
    const void* k_dec, const void* v_dec, const void* dec_bias, void* out,
    void* part, int n_pages, int n_segs, int ppn, int page_m, int depth,
    int g, int rows, int ld, int hd, int c_d, int pn, int splits,
    int max_pieces, float scale, void* stream) {
  Params a = paged_params(q, k_pages, v_pages, page_tables, seg_lens, paths,
                          k_dec, v_dec, dec_bias, out, n_pages, n_segs, ppn,
                          page_m, depth, g, rows, ld, c_d, pn, scale);
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(
      dispatch_split<kPaged, false>(a, hd, static_cast<cudaStream_t>(stream)));
}

// As paged_fused_bifurcated_decode with int8 k_pages/v_pages (P, g, pm, hd)
// and f32 k_scale_pages/v_scale_pages (P, g, pm).
int paged_fused_bifurcated_decode_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages,
    const void* page_tables, const void* seg_lens, const void* paths,
    const void* k_dec, const void* v_dec, const void* dec_bias, void* out,
    void* part, int n_pages, int n_segs, int ppn, int page_m, int depth,
    int g, int rows, int ld, int hd, int c_d, int pn, int splits,
    int max_pieces, float scale, void* stream) {
  Params a = paged_params(q, k_pages, v_pages, page_tables, seg_lens, paths,
                          k_dec, v_dec, dec_bias, out, n_pages, n_segs, ppn,
                          page_m, depth, g, rows, ld, c_d, pn, scale);
  a.k_scale = static_cast<const float*>(k_scale_pages);
  a.v_scale = static_cast<const float*>(v_scale_pages);
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.max_pieces = max_pieces;
  return static_cast<int>(
      dispatch_split<kPaged, true>(a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
