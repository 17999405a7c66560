"""Dispatch from the framework's decode layouts to the decode kernels.

``bifurcated_decode_attention`` is the deployable path. By default it runs
the SINGLE-pass fused kernel (``kernels.bifurcated_decode.
fused_bifurcated_decode``): one launch streams the K_c/V_c blocks, folds the
per-sample decode arm into the same fp32 running ``(max, sumexp, acc)``
state with the slot mask applied in-kernel, and writes the normalised
output — no fp32 partials and no logits reach device memory.

``two_pass=True`` is the escape hatch to the historical pipeline: the
context arm runs the partials kernel (fp32 ``acc/m/l`` in device memory),
the small decode arm stays on einsums, and the two halves merge with the
exact two-way online-softmax combine.

Both paths accept the framework's cache layouts ("mgk" ``(m_c, g, hd)`` or
head-major "gmk" ``(g, m_c, hd)`` — zero-copy for the kernel) and any
number ``n >= 1`` of fresh query positions per sample: ``n`` is folded into
the kernel's row dimension (``rows = b*p*n``) under a shared ``(b, C_d)``
decode mask, so attention WITHIN the fresh draft block is bidirectional,
as in the reference. On CPU tensors the kernels' plain versions run.

``bifurcated_decode_attention_q8`` is the int8-context twin: the context
arm is int8 K_c/V_c plus per-(token, head) scales (``k_scale`` pre-folded
with the logit scale), read by the fused q8 kernel.

``grouped_bifurcated_decode_attention`` / ``..._q8`` are the multi-prefix
FOREST dispatchers: G context segments in one batch with a ``(b,) -> group``
slot assignment and ragged per-group lengths, all device data, so any
admit/retire sequence of ``runtime/serve.ForestServeEngine`` runs the same
launches. The port passes the row -> group map to the kernels as a
(rows,) int32 tensor and the ragged lengths as ``ctx_lens`` (G,) int32,
where the reference builds a lane-replicated (rows, 128) table and a
(G, m_c) bias; the function computed is the same.

``tree_bifurcated_decode_attention`` / ``..._q8`` are the prefix-TRIE
dispatchers: N node segments, a (depth, b) slot -> node path table and
ragged node lengths, all device data. The port passes the kernels a
(depth, rows) int32 row -> node table and ``node_lens`` (N,) int32, where
the reference builds a lane-replicated (depth, rows, 128) table and an
(N, m_c) bias.

``paged_bifurcated_decode_attention`` / ``..._q8`` are the PAGED
dispatchers, the general form of the family: the segments' context lives
in a shared head-major page pool addressed through per-segment page tables,
and a (depth, b) slot -> segment path table says what each slot reads (one
segment with all-zero paths is the single-prefix workload, depth 1 the
forest, the full table the trie). ``_slot_operands`` builds their operands,
as the reference's ``_paged_operands`` does, with (depth, rows) int32 rows
in place of its lane-replicated (depth, rows, 128) table. The kernels read
the page tables and lengths themselves; ``live_page_list`` (the
reference's scalar-prefetched page list) is what their plain versions
walk.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bifurcated_decode import (
    context_flash_partials,
    fused_bifurcated_decode,
    fused_bifurcated_decode_q8,
    grouped_fused_bifurcated_decode,
    grouped_fused_bifurcated_decode_q8,
    paged_fused_bifurcated_decode,
    paged_fused_bifurcated_decode_q8,
    tree_fused_bifurcated_decode,
    tree_fused_bifurcated_decode_q8,
)

NEG_INF = -1e30


def _query_rows(q):
    """(b, g, p, n, hd) -> kernel-major (g, b*p*n, hd) rows,
    r = (b_idx*p + p_idx)*n + n_idx."""
    b, g, p, n, hd = q.shape
    return q.permute(1, 0, 2, 3, 4).reshape(g, b * p * n, hd).contiguous()


def _decode_operands(k_dec, v_dec, dec_mask):
    """(b, c_d, g, hd) decode arm -> group-major (g, b*c_d, hd) K/V and the
    (1, b*c_d) f32 slot bias."""
    b, c_d, g, hd = k_dec.shape
    kd = k_dec.permute(2, 0, 1, 3).reshape(g, b * c_d, hd).contiguous()
    vd = v_dec.permute(2, 0, 1, 3).reshape(g, b * c_d, hd).contiguous()
    bias = torch.where(dec_mask.reshape(1, b * c_d), 0.0, NEG_INF
                       ).to(torch.float32)
    return kd, vd, bias


def _from_rows(out, q):
    """Kernel-major (g, b*p*n, hd) output -> (b, g, p, n, hd) in q's dtype."""
    b, g, p, n, hd = q.shape
    return out.reshape(g, b, p, n, hd).permute(1, 0, 2, 3, 4).to(q.dtype)


def bifurcated_decode_attention(
    q: torch.Tensor,         # (b, g, p, n, hd) — framework decode layout
    k_ctx: torch.Tensor,     # (m_c, g, hd) "mgk" or (g, m_c, hd) "gmk"
    v_ctx: torch.Tensor,
    k_dec: torch.Tensor,     # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,  # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "mgk",
    two_pass: bool = False,
) -> torch.Tensor:
    """Single-prefix bifurcated decode dispatcher (the deployable path).

    Shapes/dtypes (framework layouts; fp32 or bf16, bf16 in serving):
      q:        (b, g, p, n, hd) — b samples, g kv heads, p query heads
                per kv head, n fresh positions (speculative drafts).
      k_ctx/v_ctx: shared context, NO batch axis — (m_c, g, hd) under
                ``ctx_layout="mgk"`` (sequence-major) or (g, m_c, hd)
                under "gmk" (head-major; zero-copy for the kernel).
      k_dec/v_dec: (b, c_d, g, hd) per-sample decode continuation.
      dec_mask: (b, c_d) bool — live decode slots.
    Returns (b, g, p, n, hd) in q's dtype, softmax-normalised over
    [context ⊕ live decode slots]."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale

    qk = _query_rows(q)
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx.contiguous(), v_ctx.contiguous()
    else:
        kc = k_ctx.transpose(0, 1).contiguous()  # (g, m_c, hd)
        vc = v_ctx.transpose(0, 1).contiguous()

    if not two_pass:
        # ---- single-pass fused kernel: decode arm + merge in-kernel ----
        kd, vd, bias = _decode_operands(k_dec, v_dec, dec_mask)
        out = fused_bifurcated_decode(
            qk, kc, vc, kd, vd, bias, scale=scale, c_d=c_d, pn=p * n)
        return _from_rows(out, q)

    # ---- two-pass escape hatch: partials kernel + einsum arm + merge ----
    acc_c, m_cx, l_c = context_flash_partials(qk, kc, vc, scale=scale)

    # decode arm: einsum partials (c_d is small)
    s_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_dec).float() * scale
    s_d = torch.where(dec_mask[:, None, None, None, :], s_d,
                      torch.full((), NEG_INF, device=q.device))
    m_d = torch.clamp(torch.amax(s_d, dim=-1), min=NEG_INF / 2)
    e_d = torch.exp(s_d - m_d[..., None])
    l_d = torch.sum(e_d, dim=-1)
    acc_d = torch.einsum("bgpnm,bmgv->bgpnv", e_d.to(v_dec.dtype), v_dec).float()

    # exact two-way merge
    acc_cb = acc_c.reshape(g, b, p, n, hd).permute(1, 0, 2, 3, 4)
    m_cb = m_cx.reshape(g, b, p, n).permute(1, 0, 2, 3)
    l_cb = l_c.reshape(g, b, p, n).permute(1, 0, 2, 3)
    m_star = torch.maximum(m_cb, m_d)
    corr_c = torch.exp(m_cb - m_star)
    corr_d = torch.exp(m_d - m_star)
    l_tot = l_cb * corr_c + l_d * corr_d
    out = (acc_cb * corr_c[..., None] + acc_d * corr_d[..., None]) / l_tot[..., None]
    return out.to(q.dtype)  # (b, g, p, n, hd)


def bifurcated_decode_attention_q8(
    q: torch.Tensor,         # (b, g, p, n, hd) — framework decode layout
    k_ctx_q: torch.Tensor,   # int8: (m_c, g, hd) "mgk" or (g, m_c, hd) "gmk"
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # f32: (m_c, g) "mgk" or (g, m_c) "gmk";
    v_scale: torch.Tensor,         #   MUST carry the logit scale pre-folded
    k_dec: torch.Tensor,     # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,  # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Int8-context twin of ``bifurcated_decode_attention``: one launch of
    the fused q8 kernel reads the int8 K_c/V_c blocks and their scales and
    merges the decode arm into the same fp32 running state. ``scale``
    applies to the decode arm only — the context logit scale must arrive
    pre-folded in ``k_scale_folded`` (``quantize_ctx(k, fold_scale=
    hd**-0.5)`` / ``QuantBifurcatedCache.from_prefill``)."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx_q.contiguous(), v_ctx_q.contiguous()
        ks, vs = k_scale_folded.contiguous(), v_scale.contiguous()
    else:
        kc = k_ctx_q.transpose(0, 1).contiguous()  # (g, m_c, hd)
        vc = v_ctx_q.transpose(0, 1).contiguous()
        ks = k_scale_folded.T.contiguous()         # (g, m_c)
        vs = v_scale.T.contiguous()
    kd, vd, bias = _decode_operands(k_dec, v_dec, dec_mask)
    out = fused_bifurcated_decode_q8(
        _query_rows(q), kc, vc, ks, vs, kd, vd, bias, scale=scale, c_d=c_d,
        pn=p * n)
    return _from_rows(out, q)


def _slot_operands(q, slot_table, k_dec, v_dec, dec_mask):
    """Shared slot-table dispatch plumbing (forest and trie): kernel-major
    q rows, the slot table ((b,) group ids or (depth, b) paths) widened to
    int32 rows (row r = (b_idx*p + p_idx)*n + n_idx inherits slot b_idx's
    entry), group-major decode arm and its slot bias."""
    b, g, p, n, hd = q.shape
    rows = slot_table.to(torch.int32).repeat_interleave(p * n, dim=-1)
    kd, vd, bias = _decode_operands(k_dec, v_dec, dec_mask)
    return _query_rows(q), rows.contiguous(), kd, vd, bias


def grouped_bifurcated_decode_attention(
    q: torch.Tensor,          # (b, g, p, n, hd) — framework decode layout
    k_ctx: torch.Tensor,      # (G, m_c, g, hd) "mgk" or (G, g, m_c, hd) "gmk"
    v_ctx: torch.Tensor,
    group_ids: torch.Tensor,  # (b,) int32 — slot -> prefix-group assignment
    ctx_lens: torch.Tensor,   # (G,) int32 — live (ragged) prefix lengths
    k_dec: torch.Tensor,      # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,   # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Multi-prefix (forest) fused decode dispatcher: G shared-context
    segments in ONE batch, each decode slot assigned to one group via
    ``group_ids``. One launch of the grouped kernel: each live segment is
    read once per kv head, ragged tails and the row assignment are handled
    in-kernel, and at G == 1 the computation equals
    ``bifurcated_decode_attention``'s."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx.contiguous(), v_ctx.contiguous()
    else:
        kc = k_ctx.transpose(1, 2).contiguous()  # (G, g, m_c, hd)
        vc = v_ctx.transpose(1, 2).contiguous()
    qk, row_group, kd, vd, bias = _slot_operands(q, group_ids, k_dec,
                                                 v_dec, dec_mask)
    out = grouped_fused_bifurcated_decode(
        qk, kc, vc, row_group, ctx_lens.to(torch.int32).contiguous(), kd, vd,
        bias, scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)


def grouped_bifurcated_decode_attention_q8(
    q: torch.Tensor,          # (b, g, p, n, hd) — framework decode layout
    k_ctx_q: torch.Tensor,    # int8: (G, m_c, g, hd) "mgk" | (G, g, m_c, hd)
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # f32: (G, m_c, g) | (G, g, m_c); MUST
    v_scale: torch.Tensor,         #   carry the logit scale pre-folded
    group_ids: torch.Tensor,  # (b,) int32
    ctx_lens: torch.Tensor,   # (G,) int32
    k_dec: torch.Tensor,      # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,   # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Int8-context twin of ``grouped_bifurcated_decode_attention``: int8
    segments + per-(token, head) scales (k pre-folded with the logit
    scale), read by the grouped q8 kernel."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx_q.contiguous(), v_ctx_q.contiguous()
        ks, vs = k_scale_folded.contiguous(), v_scale.contiguous()
    else:
        kc = k_ctx_q.transpose(1, 2).contiguous()   # (G, g, m_c, hd)
        vc = v_ctx_q.transpose(1, 2).contiguous()
        ks = k_scale_folded.transpose(1, 2).contiguous()  # (G, g, m_c)
        vs = v_scale.transpose(1, 2).contiguous()
    qk, row_group, kd, vd, bias = _slot_operands(q, group_ids, k_dec,
                                                 v_dec, dec_mask)
    out = grouped_fused_bifurcated_decode_q8(
        qk, kc, vc, ks, vs, row_group, ctx_lens.to(torch.int32).contiguous(),
        kd, vd, bias, scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)


def tree_bifurcated_decode_attention(
    q: torch.Tensor,          # (b, g, p, n, hd) — framework decode layout
    k_ctx: torch.Tensor,      # (N, m_c, g, hd) "mgk" or (N, g, m_c, hd) "gmk"
    v_ctx: torch.Tensor,
    paths: torch.Tensor,      # (depth, b) int32 — slot -> node id per trie
                              #   level, -1 = level unused by that slot
    node_lens: torch.Tensor,  # (N,) int32 — live (ragged) node lengths
    k_dec: torch.Tensor,      # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,   # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Prefix-trie (cascade) fused decode dispatcher: N node segments in
    ONE batch, each decode slot attending over the concatenation of the
    nodes on its ``paths`` column plus its own decode arm. One launch of
    the tree kernel: every node on a path is read once per kv head and row
    tile however many paths go through it. At depth == 1 the computation
    equals ``grouped_bifurcated_decode_attention``'s."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx.contiguous(), v_ctx.contiguous()
    else:
        kc = k_ctx.transpose(1, 2).contiguous()  # (N, g, m_c, hd)
        vc = v_ctx.transpose(1, 2).contiguous()
    qk, path_rows, kd, vd, bias = _slot_operands(q, paths, k_dec, v_dec,
                                                 dec_mask)
    out = tree_fused_bifurcated_decode(
        qk, kc, vc, path_rows, node_lens.to(torch.int32).contiguous(), kd,
        vd, bias, scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)


def tree_bifurcated_decode_attention_q8(
    q: torch.Tensor,          # (b, g, p, n, hd) — framework decode layout
    k_ctx_q: torch.Tensor,    # int8: (N, m_c, g, hd) "mgk" | (N, g, m_c, hd)
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # f32: (N, m_c, g) | (N, g, m_c); MUST
    v_scale: torch.Tensor,         #   carry the logit scale pre-folded
    paths: torch.Tensor,      # (depth, b) int32 — -1 = level unused
    node_lens: torch.Tensor,  # (N,) int32
    k_dec: torch.Tensor,      # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,   # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Int8-node twin of ``tree_bifurcated_decode_attention``: int8 node
    segments + per-(token, head) scales (k pre-folded with the logit
    scale), read by the tree q8 kernel. At depth == 1 the computation
    equals ``grouped_bifurcated_decode_attention_q8``'s."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx_q.contiguous(), v_ctx_q.contiguous()
        ks, vs = k_scale_folded.contiguous(), v_scale.contiguous()
    else:
        kc = k_ctx_q.transpose(1, 2).contiguous()   # (N, g, m_c, hd)
        vc = v_ctx_q.transpose(1, 2).contiguous()
        ks = k_scale_folded.transpose(1, 2).contiguous()  # (N, g, m_c)
        vs = v_scale.transpose(1, 2).contiguous()
    qk, path_rows, kd, vd, bias = _slot_operands(q, paths, k_dec, v_dec,
                                                 dec_mask)
    out = tree_fused_bifurcated_decode_q8(
        qk, kc, vc, ks, vs, path_rows, node_lens.to(torch.int32).contiguous(),
        kd, vd, bias, scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)


# ---------------------------------------------------------------------------
# Paged dispatchers: page-pool caches, only live pages read
# ---------------------------------------------------------------------------

def live_page_list(page_tables: torch.Tensor, seg_lens: torch.Tensor,
                   page_m: int):
    """Prefix-counted LIVE page list of a paged store — pure tensor data.

    page_tables: (N, ppn) int32 pool indices per segment (-1 =
    unallocated); seg_lens: (N,) int32 live token count per segment. A
    table entry is LIVE iff its segment needs it (slot j < ceil(seg_len /
    page_m)) and it is allocated (>= 0). Returns

      page_ids  (N*ppn,) int32 — live pool pages first, in (segment, page)
                order, the tail repeating the last live page;
      page_segs (N*ppn,) int32 — owning segment per entry (same padding);
      n_live    (1,) int32     — live page count;
      page_bias (N*ppn, page_m) f32 — 0 within the owning segment's live
                length, NEG_INF past it (the ragged-tail mask, per entry).
    """
    n_seg, ppn = page_tables.shape
    page_m = int(page_m)
    dev = page_tables.device
    needed = (seg_lens.long() + page_m - 1) // page_m             # ceil
    j = torch.arange(ppn, device=dev)
    live = (j[None, :] < needed[:, None]) & (page_tables >= 0)
    flat_live = live.reshape(-1)
    # stable compaction: live entries first, (segment, page) order kept
    order = torch.sort((~flat_live).to(torch.int8), stable=True).indices
    ids = torch.clamp(page_tables.long(), min=0).reshape(-1)[order]
    segs = torch.arange(n_seg, device=dev).repeat_interleave(ppn)[order]
    offs = (j * page_m).repeat(n_seg)[order]               # token offset
    n_live = flat_live.sum()
    last = torch.clamp(n_live - 1, min=0)
    tail = torch.arange(n_seg * ppn, device=dev) >= n_live
    ids = torch.where(tail, ids[last], ids)
    segs = torch.where(tail, segs[last], segs)
    offs = torch.where(tail, offs[last], offs)
    valid_to = seg_lens.long()[torch.clamp(segs, 0, n_seg - 1)]
    cols = offs[:, None] + torch.arange(page_m, device=dev)[None, :]
    page_bias = torch.where(cols < valid_to[:, None], 0.0, NEG_INF
                            ).to(torch.float32)
    return (ids.to(torch.int32), segs.to(torch.int32),
            n_live.to(torch.int32).reshape(1), page_bias)


def paged_bifurcated_decode_attention(
    q: torch.Tensor,           # (b, g, p, n, hd) — framework decode layout
    k_pages: torch.Tensor,     # (P, g, pm, hd) — head-major page pool
    v_pages: torch.Tensor,
    page_tables: torch.Tensor, # (N, ppn) int32 — pool pages per segment
    seg_lens: torch.Tensor,    # (N,) int32 — live (ragged) segment lengths
    paths: torch.Tensor,       # (depth, b) int32 — slot -> segment id per
                               #   level, -1 = level unused by that slot
    k_dec: torch.Tensor,       # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,    # (b, c_d) bool
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Paged fused decode dispatcher: one launch of the paged kernel, which
    reads only the live pages of the segments on the slots' paths, once per
    kv head and row tile. All paging state (pool contents, tables, lengths,
    paths) is device data. On fully populated pages the result equals the
    tree dispatcher's on the same logical contents."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    qk, path_rows, kd, vd, bias = _slot_operands(q, paths, k_dec, v_dec,
                                                 dec_mask)
    out = paged_fused_bifurcated_decode(
        qk, k_pages.contiguous(), v_pages.contiguous(),
        page_tables.to(torch.int32).contiguous(),
        seg_lens.to(torch.int32).contiguous(), path_rows, kd, vd, bias,
        scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)


def paged_bifurcated_decode_attention_q8(
    q: torch.Tensor,           # (b, g, p, n, hd) — framework decode layout
    k_pages_q: torch.Tensor,   # (P, g, pm, hd) int8 — quantized page pool
    v_pages_q: torch.Tensor,
    k_scale_pages: torch.Tensor,  # (P, g, pm) f32 — logit scale PRE-FOLDED
    v_scale_pages: torch.Tensor,  # (P, g, pm) f32
    page_tables: torch.Tensor, # (N, ppn) int32
    seg_lens: torch.Tensor,    # (N,) int32
    paths: torch.Tensor,       # (depth, b) int32 — -1 = level unused
    k_dec: torch.Tensor,       # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,    # (b, c_d) bool
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Int8 twin of ``paged_bifurcated_decode_attention``: int8 pool pages
    and per-(token, head) f32 scale pages (k pre-folded with the logit
    scale; ``scale`` touches the decode arm only), read by the paged q8
    kernel."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale
    qk, path_rows, kd, vd, bias = _slot_operands(q, paths, k_dec, v_dec,
                                                 dec_mask)
    out = paged_fused_bifurcated_decode_q8(
        qk, k_pages_q.contiguous(), v_pages_q.contiguous(),
        k_scale_pages.contiguous(), v_scale_pages.contiguous(),
        page_tables.to(torch.int32).contiguous(),
        seg_lens.to(torch.int32).contiguous(), path_rows, kd, vd, bias,
        scale=scale, c_d=c_d, pn=p * n)
    return _from_rows(out, q)
