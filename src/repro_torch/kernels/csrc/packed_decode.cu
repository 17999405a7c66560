// Packed heterogeneous-step kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (kernels/_build.py builds this file with nvcc, in
// parallel with the other sources; kernels/bifurcated_decode.py binds and
// launches it). Both are instances of the kernel template in
// decode_common.cuh (mode kPacked), beside the single-prefix, grouped,
// tree and paged kernels, and share its stream, online update and int8
// conversion.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bifurcated_decode.py:
//   * packed_fused_bifurcated_decode (:1637, _packed_fused_kernel): one
//     step of the paged decode batch AND one request's suffix-prefill
//     chunk. q (g, rows, hd) holds the b * pn decode rows, then the chunk
//     rows. The path table (depth + 1, rows) gives each row the segments
//     it reads in the shared (P, g, pm, hd) bf16 page pool, through page
//     tables (N, ppn) i32 and live lengths seg_lens (N,); its extra level
//     holds the pseudo-segment id N on the chunk rows. Those rows also read
//     the chunk's KV envelope (F * pm, g, hd) bf16, rows [0, fresh_len),
//     envelope row j at position fresh_start + j, causally: a chunk row at
//     position row_pos[row] sees the rows at or before it. Then every row
//     reads its own decode slots (row_slot[row], -1 for none), and the
//     output is normalised once;
//   * packed_fused_bifurcated_decode_q8 (:1815, _packed_fused_q8_kernel):
//     the same over int8 pages and (P, g, pm) f32 scale pages, k_scale
//     carrying the logit scale pre-folded; the envelope stays bf16.
//
// What bounds them on an H100: bytes for the decode rows, operations once
// the chunk is long. The live pages of every segment on some path are read
// once per kv head, the envelope's live rows once, the decode slots, q, the
// output and the tables once; a chunk of cp rows adds cp * p query rows
// whose two products over [ancestors + the causal envelope] grow with
// cp * (ancestor keys + cp / 2): with a 512-token chunk over ~6000
// ancestor keys that is ~26 GFLOP against ~60 MB moved, which the tensor
// cores take about as long as the memory (chip_smoke.py phase 4 prints
// both bounds).
//
// What the design does about it: the reference walks a scalar-prefetched
// work queue (live pages, then fresh tiles) along one sequential grid axis,
// every row riding every entry. Here the grid is #8's: one CTA per (64-row
// tile, kv head). A CTA builds its rows' path table and the set of
// segment ids on it, walks each segment of the set in ascending id over
// its live pages (a pending node's table row is empty: it costs nothing),
// then, if a row of the tile holds N, the envelope in 64-key blocks
// addressed densely, masked per row by position, then the decode arm of
// its decode rows. So an ancestor page is read once per kv head and tile
// for the decode rows and the chunk rows of that tile together, and a
// decode-only call runs #8's / #9's instructions in #8's / #9's order: the
// same bits. A tile of chunk rows only skips the decode arm; a row whose
// keys are all masked (a padded chunk row with no ancestors and no
// envelope row before it) keeps the online state's finite garbage, as the
// reference's does, never NaN. That single walk (splits 1) is paced by
// its decode tile, which walks every live node (10,968 keys at the main
// packed shape) one block at a time: ~860 us for #11, ~660 us for #10.
//
// So both kernels split the walk (splits > 1, the default on the card;
// decode_common.cuh, split_kernel mode kPacked). The decode rows' tiles
// come first and are #8's / #9's split walk (their 256-key pieces, their
// S), so the decode rows carry #8's / #9's bits, with or without the
// chunk; the chunk rows' tiles follow from row n_dec (no tile mixes the
// two kinds), take their own S (splits_chunk) and 2048-key pieces of each
// ancestor, then of the envelope (node N after every real node, causal per
// row), and no decode arm: a chunk row's bits depend on its path and the
// piece size only. #10's ancestors stream through the bf16 node stream
// (stream_bf16_nodes, a read flag per key: holes and the pseudo-segment
// are never read), #11's through the int8 stages; the envelope is bf16 in
// both. The fp32 partials are merged exactly by a second kernel, one
// launch a call. The split spreads the decode tile over 16 CTAs per kv
// head and each of the 16 chunk tiles over 2 (packed_split_count), and
// what holds it then is the ~29,000 64-key block units the CTAs stream
// (PERF.md).

#include "decode_common.cuh"

using bifurcated::dispatch_split;
using bifurcated::fused_params;
using bifurcated::kPacked;
using bifurcated::Params;

namespace {

Params packed_params(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_fresh, const void* v_fresh,
                     const void* page_tables, const void* seg_lens,
                     const void* paths, const void* row_pos,
                     const void* row_slot, const void* k_dec,
                     const void* v_dec, const void* dec_bias, void* out,
                     void* part, int n_pages, int n_segs, int ppn,
                     int page_m, int depth, int g, int rows, int n_dec,
                     int ld, int c_d, int pn, int fresh_len, int fresh_start,
                     int splits, int splits_chunk, int max_pieces,
                     int max_pieces_chunk, float scale) {
  Params a = fused_params(q, k_pages, v_pages, k_dec, v_dec, dec_bias, out,
                          g, rows, ppn * page_m, ld, c_d, pn, scale);
  a.page_tables = static_cast<const int*>(page_tables);
  a.ctx_lens = static_cast<const int*>(seg_lens);
  a.paths = static_cast<const int*>(paths);
  a.k_fresh = k_fresh;
  a.v_fresh = v_fresh;
  a.row_pos = static_cast<const int*>(row_pos);
  a.row_slot = static_cast<const int*>(row_slot);
  a.n_groups = n_segs;
  a.depth = depth;
  a.ppn = ppn;
  a.page_m = page_m;
  a.n_pages = n_pages;
  a.n_dec = n_dec;
  a.fresh_len = fresh_len;
  a.fresh_start = fresh_start;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.splits_chunk = splits_chunk;
  a.max_pieces = max_pieces;
  a.max_pieces_chunk = max_pieces_chunk;
  return a;
}

}  // namespace

extern "C" {

// q (g, rows, hd) bf16; k_pages/v_pages (P, g, pm, hd) bf16 (one layer's
// pool); k_fresh/v_fresh (F * pm, g, hd) bf16; page_tables (N, ppn) i32;
// seg_lens (N,) i32; paths (depth, rows) i32 (depth: the trie's + 1);
// row_pos, row_slot (rows,) i32; k_dec/v_dec (g, ld, hd) bf16; dec_bias
// (ld,) f32; out (g, rows, hd) bf16; in `splits` shares per (row tile, kv
// head) of the decode rows and `splits_chunk` of the chunk rows (both 1:
// the single walk); part: the split walk's f32 scratch (g * (n_dec *
// max_pieces + (rows - n_dec) * max_pieces_chunk) * (hd + 2) + g * rows
// floats) otherwise. Returns the CUDA error of the launch (0 when it was
// accepted).
int packed_fused_bifurcated_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_fresh, const void* v_fresh, const void* page_tables,
    const void* seg_lens, const void* paths, const void* row_pos,
    const void* row_slot, const void* k_dec, const void* v_dec,
    const void* dec_bias, void* out, void* part, int n_pages, int n_segs,
    int ppn, int page_m, int depth, int g, int rows, int n_dec, int ld,
    int hd, int c_d, int pn, int fresh_len, int fresh_start, int splits,
    int splits_chunk, int max_pieces, int max_pieces_chunk, float scale,
    void* stream) {
  const Params a = packed_params(
      q, k_pages, v_pages, k_fresh, v_fresh, page_tables, seg_lens, paths,
      row_pos, row_slot, k_dec, v_dec, dec_bias, out, part, n_pages, n_segs,
      ppn, page_m, depth, g, rows, n_dec, ld, c_d, pn, fresh_len,
      fresh_start, splits, splits_chunk, max_pieces, max_pieces_chunk,
      scale);
  return static_cast<int>(dispatch_split<kPacked, false>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// As packed_fused_bifurcated_decode with int8 k_pages/v_pages (P, g, pm, hd)
// and f32 k_scale_pages/v_scale_pages (P, g, pm).
int packed_fused_bifurcated_decode_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages,
    const void* k_fresh, const void* v_fresh, const void* page_tables,
    const void* seg_lens, const void* paths, const void* row_pos,
    const void* row_slot, const void* k_dec, const void* v_dec,
    const void* dec_bias, void* out, void* part, int n_pages, int n_segs,
    int ppn, int page_m, int depth, int g, int rows, int n_dec, int ld,
    int hd, int c_d, int pn, int fresh_len, int fresh_start, int splits,
    int splits_chunk, int max_pieces, int max_pieces_chunk, float scale,
    void* stream) {
  Params a = packed_params(
      q, k_pages, v_pages, k_fresh, v_fresh, page_tables, seg_lens, paths,
      row_pos, row_slot, k_dec, v_dec, dec_bias, out, part, n_pages, n_segs,
      ppn, page_m, depth, g, rows, n_dec, ld, c_d, pn, fresh_len,
      fresh_start, splits, splits_chunk, max_pieces, max_pieces_chunk,
      scale);
  a.k_scale = static_cast<const float*>(k_scale_pages);
  a.v_scale = static_cast<const float*>(v_scale_pages);
  return static_cast<int>(dispatch_split<kPacked, true>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
