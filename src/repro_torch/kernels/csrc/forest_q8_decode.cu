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
//   * q8: the bf16 kernel's grid (one CTA per kv head and 64-row tile), so
//     each int8 block is read once for all rows; cp.async stages the int8
//     block and both scale vectors, one pass converts the block to bf16 in
//     shared memory (exact), and the tensor-core path of the bf16 kernel
//     computes both products (see decode_common.cuh for the folds).
//   * grouped: one CTA per (kv head, segment, 64-row tile). A row reads
//     exactly one segment, group_ids of its sample, so no merge across
//     segments is needed: the CTA of segment gi reads ctx_lens[gi] from
//     device memory, walks only the blocks below it (reading each live
//     segment once per kv head and row tile), folds in the decode arm of
//     its tile's samples, and writes only the rows assigned to gi. A CTA
//     whose tile holds no row of gi exits at once. Skipping blocks past
//     ctx_lens is exact where the Pallas kernel streams and masks them:
//     every served row has a live decode slot, so its running max is
//     finite and masked keys contribute exactly 0. At G = 1 the grouped
//     kernel runs the single-prefix kernel's arithmetic.
// Known limits: at the main path (G = 4, g = 8, one row tile) the grid is
// 32 CTAs on 132 SMs, and the CTA of the longest segment sets the pace; a
// row tile whose rows are scattered across segments computes every row
// against each of their segments and keeps only its own, so a slot table
// that mixes groups within a tile wastes tensor-core work. Gathering rows
// by segment is later work.

#include "decode_common.cuh"

using bifurcated::dispatch_hd;
using bifurcated::Params;

extern "C" {

// q (g, rows, hd) bf16; k_ctx/v_ctx (g, m_c, hd) int8; k_scale/v_scale
// (g, m_c) f32; k_dec/v_dec (g, ld, hd) bf16; dec_bias (ld,) f32; out
// (g, rows, hd) bf16. Returns the CUDA error of the launch.
int fused_bifurcated_decode_q8(const void* q, const void* k_ctx,
                               const void* v_ctx, const void* k_scale,
                               const void* v_scale, const void* k_dec,
                               const void* v_dec, const void* dec_bias,
                               void* out, int g, int rows, int m_c, int ld,
                               int hd, int c_d, int pn, float scale,
                               void* stream) {
  Params a{q, k_ctx, v_ctx, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale), nullptr, nullptr, k_dec, v_dec,
           static_cast<const float*>(dec_bias), out, nullptr, nullptr,
           nullptr, 1, g, rows, m_c, ld, c_d, pn, scale};
  return static_cast<int>(dispatch_hd<true, true, false>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// q (g, rows, hd) bf16; k_ctx/v_ctx (G, g, m_c, hd) bf16; row_group (rows,)
// i32; ctx_lens (G,) i32; k_dec/v_dec (g, ld, hd) bf16; dec_bias (ld,) f32;
// out (g, rows, hd) bf16.
int grouped_fused_bifurcated_decode(const void* q, const void* k_ctx,
                                    const void* v_ctx, const void* row_group,
                                    const void* ctx_lens, const void* k_dec,
                                    const void* v_dec, const void* dec_bias,
                                    void* out, int n_groups, int g, int rows,
                                    int m_c, int ld, int hd, int c_d, int pn,
                                    float scale, void* stream) {
  Params a{q, k_ctx, v_ctx, nullptr, nullptr,
           static_cast<const int*>(row_group),
           static_cast<const int*>(ctx_lens), k_dec, v_dec,
           static_cast<const float*>(dec_bias), out, nullptr, nullptr,
           nullptr, n_groups, g, rows, m_c, ld, c_d, pn, scale};
  return static_cast<int>(dispatch_hd<true, false, true>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

// As grouped_fused_bifurcated_decode with int8 k_ctx/v_ctx (G, g, m_c, hd)
// and f32 k_scale/v_scale (G, g, m_c).
int grouped_fused_bifurcated_decode_q8(
    const void* q, const void* k_ctx, const void* v_ctx, const void* k_scale,
    const void* v_scale, const void* row_group, const void* ctx_lens,
    const void* k_dec, const void* v_dec, const void* dec_bias, void* out,
    int n_groups, int g, int rows, int m_c, int ld, int hd, int c_d, int pn,
    float scale, void* stream) {
  Params a{q, k_ctx, v_ctx, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(row_group),
           static_cast<const int*>(ctx_lens), k_dec, v_dec,
           static_cast<const float*>(dec_bias), out, nullptr, nullptr,
           nullptr, n_groups, g, rows, m_c, ld, c_d, pn, scale};
  return static_cast<int>(dispatch_hd<true, true, true>(
      a, hd, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
