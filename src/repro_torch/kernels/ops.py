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

``packed_bifurcated_decode_attention`` / ``..._q8`` are the PACKED
dispatchers of the heterogeneous step: the paged decode batch and one
request's suffix-prefill chunk in one launch. The chunk's query rows join
the decode rows, its KV arrives as a contiguous fresh envelope read
causally per row, and its ancestors' pages are the same pool pages the
decode rows read. ``packed_work_queue`` (the reference's work queue: live
pages, then fresh tiles) is what the plain versions walk;
``_packed_operands`` builds the rows, the path table with its extra
pseudo-segment level, the per-row positions and decode slots.
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
    packed_fused_bifurcated_decode,
    packed_fused_bifurcated_decode_plain,
    packed_fused_bifurcated_decode_q8,
    packed_fused_bifurcated_decode_q8_plain,
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


# ---------------------------------------------------------------------------
# Packed dispatchers: one launch for decode + a piggybacked prefill chunk
# ---------------------------------------------------------------------------

def packed_work_queue(page_tables, seg_lens, page_m: int, *, fresh_len,
                      fresh_start, num_fresh_tiles: int, pseudo_seg: int):
    """Work queue of (kind, seg, page/offset) descriptors — tensor data.

    Generalizes ``live_page_list``: the first ``n_live`` entries are the
    live pool pages in the paged kernels' (segment, page) order (which
    keeps decode-only queues bit-comparable), followed by
    ``ceil(fresh_len / page_m)`` FRESH prefill-chunk tiles positioned at
    absolute offset ``fresh_start`` and owned by the ``pseudo_seg`` id that
    only the chunk rows' extra path level carries. Returns

      ent_kind (max_q,) int32 — 0 pool page / 1 fresh tile;
      ent_seg  (max_q,) int32 — owning (pseudo-)segment per entry;
      ent_pdma (max_q,) int32 — pool page; fresh and tail entries repeat
               the last live page;
      ent_fdma (max_q,) int32 — fresh tile; page entries hold tile 0,
               tail entries the last fresh tile;
      ent_pos  (max_q,) int32 — absolute position of the entry's column 0
               (pages: 0 — their masking is bias and membership only);
      n_ent    (1,) int32     — live entry count;
      ent_bias (max_q, page_m) f32 — ragged-tail / chunk-length bias.

    ``max_q = page_tables.numel() + num_fresh_tiles``. With
    ``fresh_len == 0`` the queue is the live-page list."""
    pm = int(page_m)
    fcap = int(num_fresh_tiles)
    dev = page_tables.device
    ids, segs, n_live, page_bias = live_page_list(page_tables, seg_lens, pm)
    max_pages = ids.shape[0]
    max_q = max_pages + fcap
    j = torch.arange(max_q, device=dev)
    nl = n_live[0].long()
    fresh_len = torch.as_tensor(fresh_len, device=dev).long()
    nf = (fresh_len + pm - 1) // pm                          # ceil
    is_page = j < nl
    fidx = j - nl
    is_fresh = (~is_page) & (fidx < nf)
    n_ent = (nl + nf).to(torch.int32).reshape(1)

    # extend the (max_pages,) page-list arrays to max_q; live_page_list
    # already repeats its last live entry, so the extension keeps it
    ext = torch.clamp(j, max=max_pages - 1)
    ids_x, segs_x, bias_x = ids[ext], segs[ext], page_bias[ext]

    ent_kind = is_fresh.to(torch.int32)
    ent_seg = torch.where(is_fresh, pseudo_seg, segs_x).to(torch.int32)
    ent_pdma = ids_x.to(torch.int32)
    f_cl = torch.clamp(fidx, 0, fcap - 1)
    ent_fdma = torch.where(
        is_fresh, f_cl,
        torch.where(is_page, 0, torch.clamp(nf - 1, 0, fcap - 1)),
    ).to(torch.int32)
    start = torch.as_tensor(fresh_start, device=dev).long()
    ent_pos = torch.where(is_fresh, start + fidx * pm, 0).to(torch.int32)
    fcols = f_cl[:, None] * pm + torch.arange(pm, device=dev)[None, :]
    fresh_bias = torch.where(fcols < fresh_len, 0.0, NEG_INF
                             ).to(torch.float32)
    ent_bias = torch.where(is_fresh[:, None], fresh_bias, bias_x)
    return ent_kind, ent_seg, ent_pdma, ent_fdma, ent_pos, n_ent, ent_bias


def _packed_operands(q, paths, k_dec, v_dec, dec_mask, q_fresh, fresh_pos,
                     fresh_path, pseudo_seg):
    """Packed-dispatch plumbing: decode rows ++ chunk rows in one
    kernel-major q (g, rows, hd); the (depth + 1, rows) int32 path table,
    whose extra level holds the pseudo-segment for chunk rows and -1 for
    decode rows; per-row absolute positions (rows,) for the chunk's causal
    mask (decode rows 0); the decode-arm slot of each row (rows,) (chunk
    rows -1, so the decode arm contributes nothing to them); and the
    group-major decode arm with its slot bias. The reference's tables are
    lane-replicated (rows, 128); the function computed is the same."""
    b, g, p, n, hd = q.shape
    cp = q_fresh.shape[0]
    depth = paths.shape[0]
    nd = b * p * n
    dev = q.device
    qk = torch.cat([
        q.permute(1, 0, 2, 3, 4).reshape(g, nd, hd),
        q_fresh.permute(1, 0, 2, 3).reshape(g, cp * p, hd).to(q.dtype),
    ], dim=1).contiguous()                                    # (g, rows, hd)
    i32 = dict(dtype=torch.int32, device=dev)
    pr = paths.to(torch.int32).repeat_interleave(p * n, dim=1)  # (depth, nd)
    dec_path = torch.cat([pr, torch.full((1, nd), -1, **i32)])
    fr = fresh_path.to(torch.int32)[:, None].expand(depth, cp * p)
    fr_path = torch.cat([fr, torch.full((1, cp * p), pseudo_seg, **i32)])
    path_rows = torch.cat([dec_path, fr_path], dim=1).contiguous()
    row_pos = torch.cat([torch.zeros(nd, **i32),
                         fresh_pos.to(torch.int32).repeat_interleave(p)])
    row_slot = torch.cat([torch.arange(nd, **i32) // (p * n),
                          torch.full((cp * p,), -1, **i32)])
    kd, vd, bias = _decode_operands(k_dec, v_dec, dec_mask)
    return (qk, path_rows, row_pos.contiguous(), row_slot.contiguous(), kd,
            vd, bias)


def _fresh_tiles(k_fresh, v_fresh, pm, g, hd):
    """(F*pm, g, hd) contiguous chunk envelope -> (F, g, pm, hd) tiles."""
    fcap = k_fresh.shape[0] // pm
    kf = k_fresh.reshape(fcap, pm, g, hd).transpose(1, 2)
    vf = v_fresh.reshape(fcap, pm, g, hd).transpose(1, 2)
    return kf, vf, fcap


def _packed_launches(packed_fn, queue, ent_bias, cap, kd_args):
    """Split a queue across chained walks of at most ``cap`` entries each:
    every walk but the last returns raw fp32 (acc, m, l) partials which
    seed the next — exact, so the chained output is bit-identical to one
    walk. (The reference chains kernel launches this way when a queue
    exceeds one grid envelope; on the card one launch serves any queue, so
    only the plain versions chain.)"""
    ent_kind, ent_seg, ent_pdma, ent_fdma, ent_pos, n_ent = queue
    max_q = ent_kind.shape[0]
    n_launch = -(-max_q // cap)
    carry = None
    for t in range(n_launch):
        lo = t * cap
        hi = min(lo + cap, max_q)
        q_t = (ent_kind[lo:hi], ent_seg[lo:hi], ent_pdma[lo:hi],
               ent_fdma[lo:hi], ent_pos[lo:hi],
               torch.clamp(n_ent - lo, 0, hi - lo))
        last = t == n_launch - 1
        res = packed_fn(*q_t, ent_bias[lo:hi],
                        kd_args if last else (None, None, None),
                        carry=carry, emit_partials=not last)
        if last:
            return res
        carry = res


def _packed_dispatch(q, pool, page_tables, seg_lens, paths, k_dec, v_dec,
                     dec_mask, q_fresh, k_fresh, v_fresh, fresh_len,
                     fresh_start, fresh_pos, fresh_path, scale,
                     entries_per_launch):
    """The packed dispatchers' shared body; ``pool`` is (k_pages, v_pages)
    or, int8, (k_pages, v_pages, k_scale_pages, v_scale_pages)."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    pm = pool[0].shape[2]
    depth = paths.shape[0]
    scale = hd**-0.5 if scale is None else scale
    dev = q.device
    if q_fresh is None:
        q_fresh = q.new_zeros((0, g, p, hd))
        fresh_pos = torch.zeros(0, dtype=torch.int32, device=dev)
    if k_fresh is None:
        k_fresh = k_dec.new_zeros((pm, g, hd))
        v_fresh = v_dec.new_zeros((pm, g, hd))
    if fresh_path is None:
        fresh_path = torch.full((depth,), -1, dtype=torch.int32, device=dev)
    cp = q_fresh.shape[0]
    qk, path_rows, row_pos, row_slot, kd, vd, bias = _packed_operands(
        q, paths, k_dec, v_dec, dec_mask, q_fresh, fresh_pos, fresh_path,
        page_tables.shape[0])
    ops = (qk, *(t.contiguous() for t in pool), k_fresh.contiguous(),
           v_fresh.contiguous(), page_tables.to(torch.int32).contiguous(),
           seg_lens.to(torch.int32).contiguous(), path_rows, row_pos,
           row_slot, kd, vd, bias)
    kw = dict(fresh_len=0 if fresh_len is None else int(fresh_len),
              fresh_start=0 if fresh_start is None else int(fresh_start),
              scale=scale, c_d=c_d, pn=p * n)
    quant = len(pool) == 4
    if entries_per_launch is None:
        kern = (packed_fused_bifurcated_decode_q8 if quant
                else packed_fused_bifurcated_decode)
        out = kern(*ops, **kw)
    elif qk.is_cuda:
        raise ValueError(
            "entries_per_launch chains the plain versions' queue walks; on "
            "the card one launch of the packed kernel serves any queue: "
            "pass entries_per_launch=None")
    else:
        plain = (packed_fused_bifurcated_decode_q8_plain if quant
                 else packed_fused_bifurcated_decode_plain)
        out = plain(*ops, entries_per_launch=entries_per_launch, **kw)
    nd = b * p * n
    out_dec = out[:, :nd].reshape(g, b, p, n, hd).permute(1, 0, 2, 3, 4)
    out_fresh = out[:, nd:].reshape(g, cp, p, hd).permute(1, 0, 2, 3)
    return out_dec.to(q.dtype), out_fresh.to(q.dtype)


def packed_bifurcated_decode_attention(
    q: torch.Tensor,           # (b, g, p, n, hd) — framework decode layout
    k_pages: torch.Tensor,     # (P, g, pm, hd) — head-major page pool
    v_pages: torch.Tensor,
    page_tables: torch.Tensor, # (N, ppn) int32 — pool pages per segment
    seg_lens: torch.Tensor,    # (N,) int32
    paths: torch.Tensor,       # (depth, b) int32 — -1 = level unused
    k_dec: torch.Tensor,       # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,    # (b, c_d) bool
    q_fresh: Optional[torch.Tensor] = None,  # (cp, g, p, hd) chunk rows
    k_fresh: Optional[torch.Tensor] = None,  # (F*pm, g, hd) chunk KV
    v_fresh: Optional[torch.Tensor] = None,  #   envelope
    fresh_len: Optional[int] = None,    # live envelope rows
    fresh_start: Optional[int] = None,  # absolute position of row 0
    fresh_pos: Optional[torch.Tensor] = None,   # (cp,) int32 per chunk row
    fresh_path: Optional[torch.Tensor] = None,  # (depth,) int32 ancestors
    *,
    scale: Optional[float] = None,
    entries_per_launch: Optional[int] = None,
):
    """PACKED heterogeneous-step dispatcher: ONE launch of the packed
    kernel serves the decode batch's page walk AND a piggybacked
    suffix-prefill chunk. The chunk's query rows join the decode rows, its
    KV is read from the envelope's first ``fresh_len`` rows, causally per
    row (column j sits at position ``fresh_start + j``, row r sees it iff
    that is <= ``fresh_pos`` of its chunk row), and its ancestors' pages
    are the same pool pages the decode rows read, once for both.

    Returns ``(out_dec (b, g, p, n, hd), out_fresh (cp, g, p, hd))``. With
    no chunk (``q_fresh=None``) ``out_dec`` is bit-identical to
    ``paged_bifurcated_decode_attention``'s. ``entries_per_launch`` chains
    the plain versions' queue walks (bit-identical to one walk, as the
    reference's chained launches are); on CUDA tensors it raises
    ``ValueError``: one launch serves any queue there."""
    return _packed_dispatch(
        q, (k_pages, v_pages), page_tables, seg_lens, paths, k_dec, v_dec,
        dec_mask, q_fresh, k_fresh, v_fresh, fresh_len, fresh_start,
        fresh_pos, fresh_path, scale, entries_per_launch)


def packed_bifurcated_decode_attention_q8(
    q: torch.Tensor,           # (b, g, p, n, hd) — framework decode layout
    k_pages_q: torch.Tensor,   # (P, g, pm, hd) int8 — quantized page pool
    v_pages_q: torch.Tensor,
    k_scale_pages: torch.Tensor,  # (P, g, pm) f32 — logit scale PRE-FOLDED
    v_scale_pages: torch.Tensor,  # (P, g, pm) f32
    page_tables: torch.Tensor, # (N, ppn) int32
    seg_lens: torch.Tensor,    # (N,) int32
    paths: torch.Tensor,       # (depth, b) int32
    k_dec: torch.Tensor,       # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,    # (b, c_d) bool
    q_fresh: Optional[torch.Tensor] = None,
    k_fresh: Optional[torch.Tensor] = None,  # (F*pm, g, hd), the chunk's
    v_fresh: Optional[torch.Tensor] = None,  #   KV in the activation dtype
    fresh_len: Optional[int] = None,
    fresh_start: Optional[int] = None,
    fresh_pos: Optional[torch.Tensor] = None,
    fresh_path: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    entries_per_launch: Optional[int] = None,
):
    """Int8 twin of ``packed_bifurcated_decode_attention``: int8 pool pages
    with f32 scale pages (k pre-folded with the logit scale; ``scale``
    touches the decode arm and the fresh envelope only), the chunk's KV in
    the activation dtype. With no chunk ``out_dec`` is bit-identical to
    ``paged_bifurcated_decode_attention_q8``'s."""
    return _packed_dispatch(
        q, (k_pages_q, v_pages_q, k_scale_pages, v_scale_pages),
        page_tables, seg_lens, paths, k_dec, v_dec, dec_mask, q_fresh,
        k_fresh, v_fresh, fresh_len, fresh_start, fresh_pos, fresh_path,
        scale, entries_per_launch)
