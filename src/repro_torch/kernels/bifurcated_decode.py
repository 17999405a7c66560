"""Fused bifurcated flash-decode: the CUDA kernels and their plain versions.

The paper's context GEMM (⟨q, K_c⟩, Eq. 3) is the memory-IO hot spot of
shared-prefix batch decoding: K_c is the one tensor whose HBM traffic the
technique eliminates b-fold. Eleven kernels live here, written in CUDA
C++ for Hopper (``csrc/bifurcated_decode.cu``, ``csrc/forest_q8_decode.cu``,
``csrc/tree_decode.cu``, ``csrc/paged_decode.cu`` and
``csrc/packed_decode.cu`` over the shared ``csrc/decode_common.cuh``,
built by ``_build.py``):

``fused_bifurcated_decode`` — the deployable single-pass path. For each kv
  head, all ``rows = b*p*n`` query rows stream K_c/V_c once, then fold in
  their own sample's decode slots (slot bias applied in-kernel), and the
  normalised output is written once. No logits reach device memory; on
  the card the walk is split across CTAs by default (``splits``), whose
  fp32 partials a second kernel merges exactly, one launch a call.
  Replaces ``repro/kernels/bifurcated_decode.py:fused_bifurcated_decode``
  (Pallas, ``_fused_kernel``).

``context_flash_partials`` — the context arm alone, returning the
  unnormalised fp32 ``(acc, m, l)`` partials: the two-pass escape hatch of
  ``ops.bifurcated_decode_attention``; split as ``fused_bifurcated_decode``
  (its context pieces), the merge writing the partials. Replaces
  ``repro/kernels/bifurcated_decode.py:context_flash_partials`` (Pallas,
  ``_ctx_flash_kernel``).

``fused_bifurcated_decode_q8`` — the fused decode with an int8 context arm
  (int8 K_c/V_c + f32 per-(token, head) scales, the logit scale pre-folded
  into ``k_scale``): the scales fold into the logits and the softmax
  weights, ``l`` unscaled; split as ``fused_bifurcated_decode``, into the
  paged int8 kernel's pieces. Replaces ``..._q8`` (Pallas,
  ``_fused_q8_kernel``).

``grouped_fused_bifurcated_decode`` / ``..._q8`` — the multi-prefix FOREST
  decode: G context segments, a row -> segment map and ragged live lengths
  ``ctx_lens``; each row attends over its own segment's live prefix and its
  own sample's decode slots. Rows whose segment id lies outside [0, G)
  come out NaN (the reference's einsum path gives NaN for ids >= G, its
  Pallas kernel decode-arm-only attention; the engine never makes such
  ids). Both split their walk on the card (``splits``) as the trie kernels
  do, the forest being the trie at depth 1: the same bits as
  ``tree_fused_bifurcated_decode[_q8]`` on a depth-1 trie. Replace the
  Pallas ``_grouped_fused_kernel`` / ``_grouped_fused_q8_kernel``.

``tree_fused_bifurcated_decode`` / ``..._q8`` — the prefix-TRIE (cascade)
  decode: N node segments, ragged live lengths ``node_lens`` and a
  (depth, rows) row -> node table (-1 = level unused); each row attends
  over every node on its path (a node repeated on one path counts once)
  and its own sample's decode slots. Rows whose path holds an id outside
  [-1, N) come out NaN (the reference's einsum path clips such an id to
  node N - 1, its Pallas kernel ignores the level). On the card both
  split the walk across CTAs by default (``splits``), as
  ``fused_bifurcated_decode``. Replace the Pallas ``_tree_fused_kernel``
  / ``_tree_fused_q8_kernel``.

``paged_fused_bifurcated_decode`` / ``..._q8`` — the PAGED decode: the
  segments' keys lie in a shared (P, g, pm, hd) page pool addressed
  through (N, ppn) int32 page tables (-1 = unallocated) with live lengths
  ``seg_lens`` (N,), and a (depth, rows) row -> segment table: the trie
  decode over pool pages, only live pages read. A -1 entry inside a live
  length is a hole (its keys masked). Rows whose path holds an id outside
  [-1, N), or a segment whose live pages name an id outside [-1, P), come
  out NaN. Split on the card as the trie kernels, cut by logical key
  position: the trie kernels' bits at any page size. The plain versions
  walk ``ops.live_page_list`` page by page, as the reference's Pallas
  kernels do (at S > 1 the kernels' pieces). Replace
  ``_paged_fused_kernel`` / ``_paged_fused_q8_kernel``.

``packed_fused_bifurcated_decode`` / ``..._q8`` — the PACKED heterogeneous
  step: the paged decode of #8/#9 with one request's suffix-prefill chunk
  riding on it. The chunk's query rows follow the decode rows; a path
  table with one extra level marks them with the pseudo-segment id N, and
  they attend their ancestors' live pages (the same pages the decode rows
  read, once for both), then the chunk's KV envelope causally per row;
  the decode arm is keyed by each row's slot (chunk rows: none). With no
  chunk rows the output is #8's / #9's bit for bit, at the same
  ``splits``. Both split their walk on the card (``splits``): the decode
  rows' tiles are #8's / #9's split walk, the chunk rows' tiles take
  2048-key pieces. The plain versions walk the reference's work queue
  (``ops.packed_work_queue``) entry by entry, or at S > 1 the kernel's
  pieces. Replace ``_packed_fused_kernel`` / ``_packed_fused_q8_kernel``.

Each wrapper takes CPU tensors to its plain PyTorch version (which walks
the context in blocks with the same fp32 online update, ``_online_update``)
and CUDA tensors to its kernel; a CUDA tensor the kernel does not take
raises, it never falls back. Every kernel takes bf16 queries only on the
card: another dtype raises ``TypeError`` there (fp32 runs the plain
version on the CPU). ``<wrapper>.launches`` counts kernel launches. The
bound and design of the kernels are written at the top of the CUDA
sources.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_M = 512        # context keys per block of the plain versions
KERNEL_HEAD_DIMS = (16, 64, 80, 112, 128)
MAX_TREE_DEPTH = 32         # the tree kernels' path-table height
MAX_TREE_NODES = 65536      # and node count (their shared-memory bitmap)
ROW_TILE = 64        # the decode kernels' query rows per CTA
KEY_BLOCK = 64       # and keys per block: the unit a split walk cuts
CTX_WEIGHT = 2       # an int8 context block's CTA time in decode blocks
CTX_WEIGHT_BF16 = 1  # a bf16 context block's (#1, #2, #4, #6, #8)
PIECE_BLOCKS = 4     # blocks of a split walk's piece (256 keys or slots)
CHUNK_PIECE_BLOCKS = 32     # a packed chunk row's piece (2048 keys)
CTA_THREADS = 128    # the decode kernels' threads per CTA
CTAS_PER_SM = 2      # split-walk CTAs an SM holds (registers, shared memory)
DEFAULT_MAX_SPLITS = 64     # split_count's ceiling
MAX_SPLITS = 1024    # shares per (row tile, kv head) the wrappers take


def _online_update(s, v, acc, m, l, p_scale=None):
    """One flash block step: fold logits ``s`` (g, rows, blk) f32 and values
    ``v`` (g, blk, hd) into the running fp32 state ``acc`` (g, rows, hd),
    ``m`` and ``l`` (g, rows, 1). Returns the new ``(acc, m, l)``. The
    softmax weights are cast to ``v``'s dtype before the value product, and
    the product accumulates in fp32. ``p_scale`` (g, 1, blk): an optional
    per-column multiplier folded into the weights before the value product
    (the int8 arm's ``w * s_v`` fold); ``l`` stays unscaled."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    pv_in = p if p_scale is None else p * p_scale
    pv = torch.matmul(pv_in.to(v.dtype).float(), v.float())
    return acc * corr + pv, m_new, l_new


def _init_state(q):
    g, rows, hd = q.shape
    acc = torch.zeros(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.full((g, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(g, rows, 1, dtype=torch.float32, device=q.device)
    return acc, m, l


def _context_arm(q, k_ctx, v_ctx, scale, block_m, k_scale=None, v_scale=None,
                 length=None, state=None):
    """The context arm over keys [0, length) (default: all) in ``block_m``
    blocks, from the running ``state`` (acc, m, l) (default: empty). With
    ``k_scale``/``v_scale`` (g, m_c) the context is int8: the logits are
    (q · K_q) * k_scale (the logit scale pre-folded, ``scale`` unused) and
    the weights carry v_scale against f32 V_q, as in the reference."""
    qf = q.float()
    acc, m, l = _init_state(q) if state is None else state
    stop = k_ctx.shape[1] if length is None else length
    for start in range(0, stop, block_m):
        end = min(start + block_m, stop)
        s = torch.matmul(qf, k_ctx[:, start:end].float().transpose(1, 2))
        v = v_ctx[:, start:end]
        if k_scale is None:
            acc, m, l = _online_update(s * scale, v, acc, m, l)
        else:
            acc, m, l = _online_update(
                s * k_scale[:, None, start:end], v.float(), acc, m, l,
                p_scale=v_scale[:, None, start:end])
    return acc, m, l


def _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l, *, scale,
                          c_d, pn=None, row_slot=None):
    """Fold the decode arm (slot bias, cross-sample mask
    ``row // pn == col // c_d``, or ``row_slot[row] == col // c_d`` when
    each row's slot is given, -1 for none) into the running state and
    normalise."""
    rows, ld = q.shape[1], k_dec.shape[1]
    s = torch.matmul(q.float(), k_dec.float().transpose(1, 2)) * scale
    s = s + dec_bias.reshape(1, 1, ld)
    if row_slot is None:
        row_s = torch.arange(rows, device=q.device)[:, None] // pn
    else:
        row_s = row_slot.long()[:, None]
    col_s = torch.arange(ld, device=q.device)[None, :] // c_d
    s = torch.where(row_s == col_s, s, torch.full((), NEG_INF, device=q.device))
    acc, m, l = _online_update(s, v_dec, acc, m, l)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def split_count(rows: int, g: int, *, sms: int) -> int:
    """Shares per (64-row tile, kv head) of #1-#9
    (``splits=None`` on the card; #10's and #11's decode tiles,
    ``packed_split_count``):
    1 when the ``ceil(rows / 64) * g`` CTAs of the single walk
    already fill the ``sms`` SMs, else as many as make one wave of
    CTAS_PER_SM CTAs an SM (33 at the main shapes: 1 tile x 8 kv heads on
    132 SMs), at most DEFAULT_MAX_SPLITS. The shapes give no node lengths
    without reading device memory back, so a short list leaves some shares
    empty: such a CTA reads its tile's paths and writes empty partials."""
    ctas = -(-rows // ROW_TILE) * g
    if ctas >= sms:
        return 1
    return max(2, min(CTAS_PER_SM * sms // ctas, DEFAULT_MAX_SPLITS))


def packed_split_count(n_dec: int, n_chunk: int, g: int, *,
                       sms: int) -> Tuple[int, int]:
    """Shares per (64-row tile, kv head) of #10 and #11 (``splits=None``
    on the card): (S of the decode rows' tiles, S of the chunk rows'
    tiles). With no chunk rows both are #8's / #9's count,
    ``split_count(n_dec, g)``, so a decode-only call computes their default
    bits. With chunk rows the two kinds share the card: the decode tiles
    (``ceil(n_dec / 64) * g`` CTAs a share) take one CTA an SM, the chunk
    tiles (``ceil(n_chunk / 64) * g``) one wave of CTAS_PER_SM CTAs an SM,
    each at least 1 and at most DEFAULT_MAX_SPLITS (S 16 and 2 at the main
    packed shape, the best of PERF.md's sweep). The wrapper knows no node
    length: each chunk tile walks its rows' ancestors and the envelope in
    2048-key pieces."""
    if not n_chunk:
        s = split_count(n_dec, g, sms=sms)
        return s, s

    def share(ctas, per_sm):
        return max(1, min(per_sm * sms // ctas, DEFAULT_MAX_SPLITS))

    s_dec = share(-(-n_dec // ROW_TILE) * g, 1) if n_dec else 1
    return s_dec, share(-(-n_chunk // ROW_TILE) * g, CTAS_PER_SM)


def split_shares(node_blocks, n_dec: int, splits: int, *,
                 ctx_weight: int = CTX_WEIGHT):
    """The ``splits`` >= 2 shares of one (row tile, kv head), as the kernel
    cuts them: the tile's pieces are each node's blocks (``node_blocks``,
    in ascending node id; #1 / #3: one node, the context) in runs of
    PIECE_BLOCKS from its first key, then the ``n_dec`` decode blocks
    likewise, weighted ``ctx_weight`` per context block (CTX_WEIGHT for an
    int8 context, CTX_WEIGHT_BF16 for a bf16 one) and 1 per decode
    block; the shares take consecutive runs of
    pieces, each run at most a weight ``cap``, the least cap (searched as
    the kernel searches it: 128 candidates, then 128 below the first that
    fits) for which ``splits`` runs hold them all. Returns [((i0, i1),
    (b0, b1))]: each share's context blocks [i0, i1) of the tile's list
    and decode blocks [b0, b1)."""
    pieces = []                         # (weight, context?, first block)
    first = 0
    for nb in node_blocks:
        pieces += [(ctx_weight * min(PIECE_BLOCKS, first + nb - b), True, b)
                   for b in range(first, first + nb, PIECE_BLOCKS)]
        first += nb
    n_ctx = first
    pieces += [(min(PIECE_BLOCKS, n_dec - b), False, b)
               for b in range(0, n_dec, PIECE_BLOCKS)]
    total = ctx_weight * n_ctx + n_dec

    def runs(cap):
        n, cur = 0, cap
        for w, _, _ in pieces:
            if cur + w > cap:
                n, cur = n + 1, w
            else:
                cur += w
        return n

    w_max = max(ctx_weight * min(PIECE_BLOCKS, n_ctx) if n_ctx else 0,
                min(PIECE_BLOCKS, n_dec))
    cap0 = max(w_max, -(-total // splits))
    step = max(1, (total - cap0 + CTA_THREADS - 2) // (CTA_THREADS - 1))
    cap = min([cap0 + t * step for t in range(CTA_THREADS)
               if total and runs(cap0 + t * step) <= splits]
              + [max(total, 1)])
    if step > 1:
        cap = min([c for c in range(max(cap0, cap - step + 1),
                                    max(cap0, cap - step + 1) + CTA_THREADS)
                   if c < cap and runs(c) <= splits] + [cap])
    shares = [[n_ctx, n_ctx, n_dec, n_dec] for _ in range(splits)]
    n, cur = 0, cap
    for w, ctx, b in pieces:
        if cur + w > cap:
            n, cur = n + 1, w
        else:
            cur += w
        sh = shares[n - 1]
        if ctx:
            sh[0], sh[1] = min(sh[0], b), b + w // ctx_weight
        else:
            sh[2], sh[3] = min(sh[2], b), b + w
    return [((i0, i1 if i0 < n_ctx else n_ctx),
             (b0, b1 if b0 < n_dec else n_dec)) for i0, i1, b0, b1 in shares]


def merge_partials_raw(parts):
    """The exact merge of a row's fp32 partials [(acc, m, l), ...] in its
    merge order: m = max m_s, w_s = exp(m_s - m), l = sum l_s w_s, acc =
    sum acc_s w_s; returns the unnormalised (acc, m, l)."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for a, ms, ls in parts:
        w = torch.exp(ms - m)
        l = l + ls * w
        acc = acc + a * w
    return acc, m, l


def merge_partials(parts):
    """``merge_partials_raw``, normalised: acc / max(l, 1e-30) in fp32."""
    acc, _, l = merge_partials_raw(parts)
    return acc / torch.clamp(l, min=1e-30)


def max_pieces(depth: int, m_c: int, c_d: int,
               piece_blocks: int = PIECE_BLOCKS) -> int:
    """The pieces a row may read: ``piece_blocks`` * 64 keys of each of
    its ``depth`` nodes of at most ``m_c`` keys, and the pieces its
    sample's ``c_d`` decode slots touch."""
    span = piece_blocks * KEY_BLOCK
    return depth * -(-m_c // span) + -(-c_d // span) + 1


def _split_walk(q, fetch, n_nodes, node_len, paths, k_dec, v_dec, dec_bias,
                bad, *, scale, c_d, pn, block_m, merge, n_dec=None,
                row_slot=None, fresh=None):
    """The split walk of #1-#3 / #6-#9 / #11 (its result does not
    depend on S): per 64-row tile, each node's keys in pieces of
    PIECE_BLOCKS * 64 from its first key, each summed from a fresh fp32
    state over the rows on the node (in ``block_m`` runs), then the decode
    arm's slots in pieces of as many from the tile's first slot, over the
    rows whose sample has slots there; ``merge`` (``merge_partials``)
    combines each row's pieces in order: its nodes ascending, then its
    decode pieces. ``fetch(node, a, b)`` gives keys [a, b) of a node: K, V
    (g, n, hd), their scales (g, n) or None, and which keys are readable
    (n,). #11 (``n_dec`` given): the tiles of the first ``n_dec`` rows
    (the decode rows, each row's sample ``row_slot[row]``, -1 none), then
    those of the chunk rows from row ``n_dec``, in pieces of
    CHUNK_PIECE_BLOCKS * 64 keys and with no decode arm; ``fresh`` =
    (k_fresh, v_fresh, fresh_len, fresh_start, row_pos): after the real
    nodes, the rows whose path holds ``n_nodes`` (the pseudo-segment) read
    the envelope's keys [0, fresh_len) (F * pm, g, hd) in the tile's
    pieces, key col only where fresh_start + col <= row_pos[row]."""
    g, rows, hd = q.shape
    ld = k_dec.shape[1]
    n_first = rows if n_dec is None else n_dec
    pr = paths.long()
    qf = q.float()
    neg = torch.full((), NEG_INF, device=q.device)
    out = torch.empty_like(q)
    tiles = [(r0, min(r0 + ROW_TILE, n_first), PIECE_BLOCKS)
             for r0 in range(0, n_first, ROW_TILE)]
    tiles += [(r0, min(r0 + ROW_TILE, rows), CHUNK_PIECE_BLOCKS)
              for r0 in range(n_first, rows, ROW_TILE)]
    for row0, row_hi, piece_blocks in tiles:
        span = piece_blocks * KEY_BLOCK
        tile = slice(row0, row_hi)
        tp = pr[:, tile]
        parts = [[] for _ in range(tile.stop - row0)]   # per tile row

        def keep(sel, st):      # each selected row's partial of a piece
            for n, r in enumerate(sel.tolist()):
                parts[r].append(tuple(t[:, n] for t in st))

        for node in sorted(set(tp[(tp >= 0) & (tp < n_nodes)].tolist())):
            on = torch.nonzero((tp == node).any(0))[:, 0]
            length = node_len(node)
            for a in range(0, length, span):
                st = _init_state(q[:, tile][:, on])
                for c in range(a, min(a + span, length), block_m):
                    k, v, ks, vs, ok = fetch(node, c, min(c + block_m,
                                                          a + span, length))
                    s = torch.matmul(qf[:, tile][:, on],
                                     k.float().transpose(1, 2))
                    s = s * (scale if ks is None else ks[:, None, :])
                    s = torch.where(ok[None, None, :], s, neg)
                    v = v.masked_fill(~ok[None, :, None], 0)
                    if ks is None:
                        st = _online_update(s, v, *st)
                    else:
                        vs = vs.masked_fill(~ok[None, :], 0)
                        st = _online_update(s, v.float(), *st,
                                            p_scale=vs[:, None, :])
                keep(on, st)
        if fresh is not None:
            k_fresh, v_fresh, fresh_len, fresh_start, row_pos = fresh
            on = torch.nonzero((tp == n_nodes).any(0))[:, 0]
            pos = row_pos[tile][on].long()[:, None]
            for a in range(0, fresh_len if on.numel() else 0, span):
                st = _init_state(q[:, tile][:, on])
                for c in range(a, min(a + span, fresh_len), block_m):
                    e = min(c + block_m, a + span, fresh_len)
                    s = torch.matmul(qf[:, tile][:, on], k_fresh[c:e].float()
                                     .permute(1, 2, 0)) * scale
                    seen = fresh_start + torch.arange(c, e, device=q.device)
                    s = torch.where((seen[None, :] <= pos)[None], s, neg)
                    st = _online_update(s, v_fresh[c:e].transpose(0, 1), *st)
                keep(on, st)
        dec_lo = (row0 // pn) * c_d     # a chunk tile has no decode arm
        dec_hi = dec_lo if row0 >= n_first else min(
            ld, ((tile.stop - 1) // pn + 1) * c_d)
        if row_slot is None:
            sample = torch.arange(row0, tile.stop, device=q.device) // pn
        else:   # a slot outside the arm reads none
            sample = row_slot[tile].long()
            sample = sample.masked_fill(sample >= ld // c_d, -1)
        for c0 in range(dec_lo, dec_hi, span):
            c1 = min(dec_hi, c0 + span)
            sel = torch.nonzero((sample * c_d < c1)
                                & ((sample + 1) * c_d > c0))[:, 0]
            s = torch.matmul(qf[:, tile][:, sel],
                             k_dec[:, c0:c1].float().transpose(1, 2))
            s = s * scale + dec_bias[:, c0:c1].reshape(1, 1, -1)
            col_s = torch.arange(c0, c1, device=q.device)[None, :] // c_d
            s = torch.where(sample[sel][:, None] == col_s, s, neg)
            keep(sel, _online_update(s, v_dec[:, c0:c1],
                                     *_init_state(q[:, tile][:, sel])))
        for r, row_parts in enumerate(parts):   # no piece: 0, as the merge
            out[:, row0 + r] = (merge(row_parts).to(q.dtype) if row_parts
                                else 0.0)
    return out.masked_fill(bad[None, :, None], float("nan"))


def _tree_plain(q, k_ctx, v_ctx, k_scale, v_scale, paths, node_lens, k_dec,
                v_dec, dec_bias, *, scale, c_d, pn, block_m, splits=1,
                merge=merge_partials):
    n_nodes, _, m_c, _ = k_ctx.shape
    pr = paths.long()
    lens = node_lens.tolist()
    bad = ((pr < -1) | (pr >= n_nodes)).any(0)
    if splits > 1:
        def fetch(node, a, b):
            sc = ((None, None) if k_scale is None
                  else (k_scale[node][:, a:b], v_scale[node][:, a:b]))
            return (k_ctx[node][:, a:b], v_ctx[node][:, a:b], *sc,
                    torch.ones(b - a, dtype=torch.bool, device=q.device))

        return _split_walk(
            q, fetch, n_nodes, lambda n: min(max(int(lens[n]), 0), m_c),
            paths, k_dec, v_dec, dec_bias, bad, scale=scale, c_d=c_d, pn=pn,
            block_m=block_m, merge=merge)
    acc, m, l = _init_state(q)
    # the distinct ids on any path, ascending: the kernel's node order and
    # the set semantics (a node repeated on one path counts once)
    for node in sorted(set(pr[(pr >= 0) & (pr < n_nodes)].tolist())):
        rows_n = torch.nonzero((pr == node).any(0))[:, 0]
        a, mm, ll = _context_arm(
            q[:, rows_n], k_ctx[node], v_ctx[node], scale, block_m,
            k_scale=None if k_scale is None else k_scale[node],
            v_scale=None if v_scale is None else v_scale[node],
            length=min(max(int(lens[node]), 0), m_c),
            state=(acc[:, rows_n], m[:, rows_n], l[:, rows_n]))
        acc[:, rows_n], m[:, rows_n], l[:, rows_n] = a, mm, ll
    out = _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                scale=scale, c_d=c_d, pn=pn)
    return out.masked_fill(bad[None, :, None], float("nan"))


def _single_plain(q, k_ctx, v_ctx, k_scale, v_scale, k_dec, v_dec, dec_bias,
                  *, scale, c_d, pn, block_m, splits=1, merge=merge_partials):
    """One shared context (int8 when ``k_scale`` is given). ``splits`` 1:
    the single walk, the context in ``block_m`` blocks, then the decode
    arm. S > 1: the kernel's pieces, the context being node 0 of a
    one-node trie on every row's depth-1 path (``_tree_plain``'s split
    walk, so the pieces are #9's on the same context), merged by
    ``merge``; the same for any S > 1."""
    if splits > 1:
        dev = q.device
        node = [None if t is None else t[None]
                for t in (k_ctx, v_ctx, k_scale, v_scale)]
        return _tree_plain(
            q, *node, torch.zeros(1, q.shape[1], dtype=torch.int32, device=dev),
            torch.tensor([k_ctx.shape[1]], dtype=torch.int32, device=dev),
            k_dec, v_dec, dec_bias, scale=scale, c_d=c_d, pn=pn,
            block_m=block_m, splits=splits, merge=merge)
    acc, m, l = _context_arm(q, k_ctx, v_ctx, scale, block_m,
                             k_scale=k_scale, v_scale=v_scale)
    return _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                 scale=scale, c_d=c_d, pn=pn)


def fused_bifurcated_decode_plain(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                                  scale: float, c_d: int, pn: int,
                                  block_m: int = BLOCK_M,
                                  splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bifurcated_decode``: at ``splits``
    1 the context in ``block_m`` blocks, then the decode arm with the slot
    bias and the cross-sample mask ``row // pn == col // c_d``, then
    normalise; at S > 1 the kernel's pieces, merged exactly per row (the
    same for any S > 1)."""
    return _single_plain(q, k_ctx, v_ctx, None, None, k_dec, v_dec, dec_bias,
                         scale=scale, c_d=c_d, pn=pn, block_m=block_m,
                         splits=splits)


def fused_bifurcated_decode_q8_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale,
                                     k_dec, v_dec, dec_bias, *, scale: float,
                                     c_d: int, pn: int,
                                     block_m: int = BLOCK_M,
                                     splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bifurcated_decode_q8``: int8
    context arm (scales folded into logits and weights, the value product
    in f32), then the bf16 decode arm as in the fused version; ``splits``
    as in ``fused_bifurcated_decode_plain``."""
    return _single_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale, k_dec, v_dec,
                         dec_bias, scale=scale, c_d=c_d, pn=pn,
                         block_m=block_m, splits=splits)


def _grouped_plain(q, k_ctx, v_ctx, k_scale, v_scale, row_group, ctx_lens,
                   k_dec, v_dec, dec_bias, **kw):
    """The forest is the trie at depth 1, except that a row of id -1 reads
    no segment there and is NaN here, as every id outside [0, G)."""
    out = _tree_plain(q, k_ctx, v_ctx, k_scale, v_scale, row_group[None],
                      ctx_lens, k_dec, v_dec, dec_bias, **kw)
    return out.masked_fill((row_group == -1)[None, :, None], float("nan"))


def grouped_fused_bifurcated_decode_plain(q, k_ctx, v_ctx, row_group,
                                          ctx_lens, k_dec, v_dec, dec_bias,
                                          *, scale: float, c_d: int, pn: int,
                                          block_m: int = BLOCK_M,
                                          splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_fused_bifurcated_decode``: at
    ``splits`` 1 each row's context arm over the live prefix of its own
    segment, then the decode arm as in the fused version; at S > 1 the
    kernel's pieces, those of the bf16 trie's split walk at depth 1
    (``_tree_plain``; the same for any S > 1). Rows of a segment id
    outside [0, G) come out NaN."""
    return _grouped_plain(q, k_ctx, v_ctx, None, None, row_group, ctx_lens,
                          k_dec, v_dec, dec_bias, scale=scale, c_d=c_d,
                          pn=pn, block_m=block_m, splits=splits)


def grouped_fused_bifurcated_decode_q8_plain(q, k_ctx_q, v_ctx_q, k_scale,
                                             v_scale, row_group, ctx_lens,
                                             k_dec, v_dec, dec_bias, *,
                                             scale: float, c_d: int, pn: int,
                                             block_m: int = BLOCK_M,
                                             splits: int = 1
                                             ) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_fused_bifurcated_decode_q8``:
    at ``splits`` 1 the single walk; at S > 1 the kernel's pieces, those
    of the int8 trie's split walk at depth 1 (``_tree_plain``; the same
    for any S > 1)."""
    return _grouped_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale, row_group,
                          ctx_lens, k_dec, v_dec, dec_bias, scale=scale,
                          c_d=c_d, pn=pn, block_m=block_m, splits=splits)


def tree_fused_bifurcated_decode_plain(q, k_ctx, v_ctx, paths, node_lens,
                                       k_dec, v_dec, dec_bias, *,
                                       scale: float, c_d: int, pn: int,
                                       block_m: int = BLOCK_M,
                                       splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``tree_fused_bifurcated_decode``: at
    ``splits`` 1 each trie node on any path, in ascending id order, folds
    its live prefix into the running state of the rows whose path holds
    it; then the decode arm as in the fused version. At S > 1 the kernel's
    pieces, merged exactly per row (``_split_walk``; the same for any
    S > 1). Rows whose path holds an id outside [-1, N) come out NaN."""
    return _tree_plain(q, k_ctx, v_ctx, None, None, paths, node_lens, k_dec,
                       v_dec, dec_bias, scale=scale, c_d=c_d, pn=pn,
                       block_m=block_m, splits=splits)


def tree_fused_bifurcated_decode_q8_plain(q, k_ctx_q, v_ctx_q, k_scale,
                                          v_scale, paths, node_lens, k_dec,
                                          v_dec, dec_bias, *, scale: float,
                                          c_d: int, pn: int,
                                          block_m: int = BLOCK_M,
                                          splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``tree_fused_bifurcated_decode_q8``: the
    walks of the bf16 version over int8 nodes."""
    return _tree_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale, paths,
                       node_lens, k_dec, v_dec, dec_bias, scale=scale,
                       c_d=c_d, pn=pn, block_m=block_m, splits=splits)


def context_flash_partials_plain(q, k_ctx, v_ctx, *, scale: float,
                                 block_m: int = BLOCK_M, splits: int = 1,
                                 merge=merge_partials_raw):
    """Plain PyTorch version of ``context_flash_partials``: at ``splits`` 1
    the context in ``block_m`` blocks; at S > 1 the kernel's pieces, 256
    keys each from key 0 (#1's context pieces), each from a fresh fp32
    state, merged exactly by ``merge`` (``merge_partials_raw``) into the
    unnormalised (acc, m, l); the same for any S > 1."""
    if splits > 1:
        span = PIECE_BLOCKS * KEY_BLOCK
        acc, m, l = merge([
            _context_arm(q, k_ctx[:, a:a + span], v_ctx[:, a:a + span],
                         scale, block_m)
            for a in range(0, k_ctx.shape[1], span)])
    else:
        acc, m, l = _context_arm(q, k_ctx, v_ctx, scale, block_m)
    return acc, m[..., 0], l[..., 0]


def _on_cuda(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (the kernel runs), False
    when on the CPU (the plain version runs); raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_contiguous(*tensors):
    # the same contract on both devices, so CPU runs catch a bad layout
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")


def _check_kernel_operands(q, *tensors):
    """What the kernels take on the card: bf16 queries (float32 runs on
    the CPU's plain path), the head dims they are built for, 16-byte
    aligned operands."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bfloat16 queries on CUDA, not "
                        f"{q.dtype}; float32 runs on the CPU's plain path")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"not {q.shape[-1]}")
    if any(t.data_ptr() % 16 for t in (q,) + tensors):
        raise ValueError("kernel operands must be 16-byte aligned")


def _check_context(q, k_ctx, v_ctx):
    if q.ndim != 3 or k_ctx.ndim != 3 or k_ctx.shape != v_ctx.shape:
        raise ValueError(f"want q (g, rows, hd), k_ctx = v_ctx (g, m_c, hd); "
                         f"got {tuple(q.shape)}, {tuple(k_ctx.shape)}, "
                         f"{tuple(v_ctx.shape)}")
    g, _, hd = q.shape
    if k_ctx.shape[0] != g or k_ctx.shape[2] != hd or k_ctx.shape[1] < 1:
        raise ValueError(f"context {tuple(k_ctx.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k_ctx.dtype != q.dtype or v_ctx.dtype != q.dtype:
        raise TypeError("context must have the query's dtype")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_arg(splits, q, on_cuda):
    """The shares of a split walk: ``split_count`` on the card and 1 on
    the CPU when ``splits`` is None, else ``splits`` (1..MAX_SPLITS)."""
    if splits is None:
        if not on_cuda:
            return 1
        return split_count(q.shape[1], q.shape[0],
                           sms=_sm_count(q.device.index))
    if (isinstance(splits, bool) or not isinstance(splits, int)
            or not 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"splits must be an int in 1..{MAX_SPLITS} or "
                         f"None, not {splits!r}")
    return splits


def _packed_pair(splits):
    """#10's / #11's shares as (decode tiles', chunk tiles'): an int is
    both."""
    return tuple(splits) if isinstance(splits, tuple) else (splits, splits)


def _packed_split_arg(splits, q, n_dec, on_cuda):
    """#10's / #11's shares, (decode tiles', chunk tiles'):
    ``packed_split_count`` on the card and (1, 1) on the CPU when
    ``splits`` is None, else ``splits``: an int (both) or a pair, each in
    1..MAX_SPLITS."""
    if splits is None:
        if not on_cuda:
            return 1, 1
        g, rows, _ = q.shape
        return packed_split_count(n_dec, rows - n_dec, g,
                                  sms=_sm_count(q.device.index))
    if isinstance(splits, tuple) and len(splits) == 2 and None not in splits:
        return tuple(_split_arg(s, q, on_cuda) for s in splits)
    if isinstance(splits, tuple):
        raise ValueError(f"splits must be an int, a pair of ints or None, "
                         f"not {splits!r}")
    return _packed_pair(_split_arg(splits, q, on_cuda))


def _split_scratch(q, splits, n_pieces, n_first=None, n_pieces_rest=0):
    """The split walk's f32 scratch, flat: acc (g, slots, hd), (m, l) (g,
    slots, 2), then each row's piece count (int32), where a kv head's
    slots are ``n_pieces`` for each of its first ``n_first`` rows (default
    all) and ``n_pieces_rest`` for each of the others (#11's chunk rows);
    None for the single walk."""
    if splits == 1:
        return None
    g, rows, hd = q.shape
    n_first = rows if n_first is None else n_first
    slots = n_first * n_pieces + (rows - n_first) * n_pieces_rest
    return torch.empty(g * (slots * (hd + 2) + rows), dtype=torch.float32,
                       device=q.device)


def _raise_on_error(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn):
    g, rows, hd = q.shape
    ld = k_dec.shape[1] if k_dec.ndim == 3 else -1
    if (k_dec.shape != (g, ld, hd) or v_dec.shape != k_dec.shape
            or dec_bias.shape != (1, ld) or rows % pn
            or ld != (rows // pn) * c_d):
        raise ValueError(f"decode arm {tuple(k_dec.shape)}, bias "
                         f"{tuple(dec_bias.shape)} do not fit q "
                         f"{tuple(q.shape)} with c_d={c_d}, pn={pn}")
    if k_dec.dtype != q.dtype or v_dec.dtype != q.dtype:
        raise TypeError("decode arm must have the query's dtype")
    if dec_bias.dtype != torch.float32:
        raise TypeError("dec_bias must be float32")
    return ld


def _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale, lead=()):
    """int8 values (*lead, g, m_c, hd) and f32 scales (*lead, g, m_c)."""
    g, _, hd = q.shape
    n = len(lead)
    if (k_ctx_q.ndim != 3 + n or k_ctx_q.shape[:n] != lead
            or k_ctx_q.shape[n] != g or k_ctx_q.shape[n + 2] != hd
            or k_ctx_q.shape[n + 1] < 1 or v_ctx_q.shape != k_ctx_q.shape
            or k_scale.shape != k_ctx_q.shape[:-1]
            or v_scale.shape != k_scale.shape):
        raise ValueError(f"int8 context {tuple(k_ctx_q.shape)}, scales "
                         f"{tuple(k_scale.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_ctx_q.dtype != torch.int8 or v_ctx_q.dtype != torch.int8:
        raise TypeError("int8 context values must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("int8 context scales must be float32")


def _check_segments(q, k_ctx, row_group, ctx_lens):
    n_groups = k_ctx.shape[0]
    if row_group.shape != (q.shape[1],) or ctx_lens.shape != (n_groups,):
        raise ValueError(f"row_group {tuple(row_group.shape)} / ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not fit q "
                         f"{tuple(q.shape)} and {n_groups} segments")
    if row_group.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("row_group and ctx_lens must be int32")


def _check_paths(q, k_ctx, paths, node_lens):
    n_nodes = k_ctx.shape[0]
    if (paths.ndim != 2 or paths.shape[1] != q.shape[1]
            or node_lens.shape != (n_nodes,)):
        raise ValueError(f"paths {tuple(paths.shape)} / node_lens "
                         f"{tuple(node_lens.shape)} do not fit q "
                         f"{tuple(q.shape)} and {n_nodes} nodes")
    if not 1 <= paths.shape[0] <= MAX_TREE_DEPTH or n_nodes > MAX_TREE_NODES:
        raise ValueError(f"tree of depth {paths.shape[0]} over {n_nodes} "
                         f"nodes: the kernels take depth 1..{MAX_TREE_DEPTH}"
                         f" and at most {MAX_TREE_NODES} nodes")
    if paths.dtype != torch.int32 or node_lens.dtype != torch.int32:
        raise TypeError("paths and node_lens must be int32")


def _launch(name, device, *args):
    """Call the C function ``name`` on ``device``'s current stream (the
    library is built first if needed) and raise if the launch was
    refused."""
    fn = getattr(_build.library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(name, err)


def fused_bifurcated_decode(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                            scale: float, c_d: int, pn: int,
                            splits=None) -> torch.Tensor:
    """Single-pass bifurcated decode; returns the normalised (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of sample r // pn
      k_ctx/v_ctx: (g, m_c, hd) shared context, q's dtype
      k_dec/v_dec: (g, b * c_d, hd) every sample's decode slots, group-major
      dec_bias:    (1, b * c_d) f32 — 0 for live slots, NEG_INF else
      splits:      shares per (64-row tile, kv head) of the work (None:
                   ``split_count`` on the card, 1 on the CPU); 1 runs the
                   single walk, S > 1 S CTAs per tile and head and an exact
                   merge, one launch either way
    """
    _check_context(q, k_ctx, v_ctx)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return fused_bifurcated_decode_plain(*ops, scale=scale, c_d=c_d,
                                             pn=pn, splits=splits)
    _check_kernel_operands(*ops)
    g, rows, hd = q.shape
    m_c = k_ctx.shape[1]
    out = torch.empty_like(q)
    n_pieces = max_pieces(1, m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), g, rows, m_c, ld, hd,
            c_d, pn, splits, n_pieces, float(scale))
    fused_bifurcated_decode.launches += 1
    return out


fused_bifurcated_decode.launches = 0


def context_flash_partials(q, k_ctx, v_ctx, *, scale: float, splits=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context-arm flash partials: acc (g, rows, hd) f32, m (g, rows) f32,
    l (g, rows) f32 — unnormalised, for an exact merge with another arm.
    ``splits`` as in ``fused_bifurcated_decode``: the pieces are #1's
    context pieces, merged into the partials by the second kernel."""
    _check_context(q, k_ctx, v_ctx)
    _check_contiguous(q, k_ctx, v_ctx)
    cuda = _on_cuda(q, k_ctx, v_ctx)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return context_flash_partials_plain(q, k_ctx, v_ctx, scale=scale,
                                            splits=splits)
    _check_kernel_operands(q, k_ctx, v_ctx)
    g, rows, hd = q.shape
    m_c = k_ctx.shape[1]
    acc = torch.empty(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    l = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    n_pieces = max_pieces(1, m_c, 0)
    part = _split_scratch(q, splits, n_pieces)
    _launch("context_flash_partials", q.device,
            *(t.data_ptr() for t in (q, k_ctx, v_ctx, acc, m, l)),
            None if part is None else part.data_ptr(), g, rows, m_c, hd,
            splits, n_pieces, float(scale))
    context_flash_partials.launches += 1
    return acc, m, l


context_flash_partials.launches = 0


# ---------------------------------------------------------------------------
# int8 context arm and multi-prefix forest (csrc/forest_q8_decode.cu)
# ---------------------------------------------------------------------------

def fused_bifurcated_decode_q8(q, k_ctx_q, v_ctx_q, k_scale, v_scale, k_dec,
                               v_dec, dec_bias, *, scale: float, c_d: int,
                               pn: int, splits=None) -> torch.Tensor:
    """Single-pass bifurcated decode with an int8 context arm; returns the
    normalised (g, rows, hd).

      q:               (g, rows, hd), rows = b * p * n
      k_ctx_q/v_ctx_q: (g, m_c, hd) int8
      k_scale/v_scale: (g, m_c) f32, ``k_scale`` with the logit scale
                       pre-folded (``scale`` applies to the decode arm only)
      k_dec/v_dec:     (g, b * c_d, hd), q's dtype; dec_bias (1, b * c_d) f32
      splits:          as in ``fused_bifurcated_decode``; the pieces are
                       ``paged_fused_bifurcated_decode_q8``'s on a single
                       prefix, so at S > 1 the two compute the same bits
    """
    _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx_q, v_ctx_q, k_scale, v_scale, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return fused_bifurcated_decode_q8_plain(*ops, scale=scale, c_d=c_d,
                                                pn=pn, splits=splits)
    _check_kernel_operands(q, k_ctx_q, v_ctx_q, k_dec, v_dec, dec_bias)
    g, rows, hd = q.shape
    m_c = k_ctx_q.shape[1]
    out = torch.empty_like(q)
    n_pieces = max_pieces(1, m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), g, rows, m_c, ld, hd,
            c_d, pn, splits, n_pieces, float(scale))
    fused_bifurcated_decode_q8.launches += 1
    return out


fused_bifurcated_decode_q8.launches = 0


def grouped_fused_bifurcated_decode(q, k_ctx, v_ctx, row_group, ctx_lens,
                                    k_dec, v_dec, dec_bias, *, scale: float,
                                    c_d: int, pn: int,
                                    splits=None) -> torch.Tensor:
    """Single-pass multi-prefix (forest) decode; returns the normalised
    (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of slot r // pn
      k_ctx/v_ctx: (G, g, m_c, hd) context segments, q's dtype
      row_group:   (rows,) int32 — the segment each row reads
      ctx_lens:    (G,) int32 — live length of each segment
      k_dec/v_dec: (g, b * c_d, hd); dec_bias (1, b * c_d) f32
    Rows whose segment id lies outside [0, G) come out NaN. ``splits`` as
    in ``tree_fused_bifurcated_decode``: the forest is the trie at depth 1
    (``row_group`` its path table), so at S > 1 the rows of ids in [0, G)
    get that kernel's bits."""
    if k_ctx.ndim != 4 or v_ctx.shape != k_ctx.shape:
        raise ValueError(f"want k_ctx = v_ctx (G, g, m_c, hd); got "
                         f"{tuple(k_ctx.shape)}, {tuple(v_ctx.shape)}")
    _check_context(q, k_ctx[0], v_ctx[0])
    _check_segments(q, k_ctx, row_group, ctx_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx, v_ctx, row_group, ctx_lens, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return grouped_fused_bifurcated_decode_plain(
            *ops, scale=scale, c_d=c_d, pn=pn, splits=splits)
    _check_kernel_operands(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    n_groups, g, m_c, hd = k_ctx.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(1, m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("grouped_fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_groups, g,
            q.shape[1], m_c, ld, hd, c_d, pn, splits, n_pieces,
            float(scale))
    grouped_fused_bifurcated_decode.launches += 1
    return out


grouped_fused_bifurcated_decode.launches = 0


def grouped_fused_bifurcated_decode_q8(q, k_ctx_q, v_ctx_q, k_scale, v_scale,
                                       row_group, ctx_lens, k_dec, v_dec,
                                       dec_bias, *, scale: float, c_d: int,
                                       pn: int, splits=None) -> torch.Tensor:
    """``grouped_fused_bifurcated_decode`` over int8 segments
    (G, g, m_c, hd) and f32 scales (G, g, m_c), ``k_scale`` with the logit
    scale pre-folded. ``splits`` as in ``tree_fused_bifurcated_decode_q8``:
    the forest is the trie at depth 1 (``row_group`` its path table), so at
    S > 1 the rows of ids in [0, G) get that kernel's bits."""
    lead = tuple(k_ctx_q.shape[:1])
    _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale, lead=lead)
    _check_segments(q, k_ctx_q, row_group, ctx_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx_q, v_ctx_q, k_scale, v_scale, row_group, ctx_lens, k_dec,
           v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return grouped_fused_bifurcated_decode_q8_plain(
            *ops, scale=scale, c_d=c_d, pn=pn, splits=splits)
    _check_kernel_operands(q, k_ctx_q, v_ctx_q, k_dec, v_dec, dec_bias)
    n_groups, g, m_c, hd = k_ctx_q.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(1, m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("grouped_fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_groups, g,
            q.shape[1], m_c, ld, hd, c_d, pn, splits, n_pieces,
            float(scale))
    grouped_fused_bifurcated_decode_q8.launches += 1
    return out


grouped_fused_bifurcated_decode_q8.launches = 0

# ---------------------------------------------------------------------------
# prefix trie (csrc/tree_decode.cu)
# ---------------------------------------------------------------------------

def tree_fused_bifurcated_decode(q, k_ctx, v_ctx, paths, node_lens, k_dec,
                                 v_dec, dec_bias, *, scale: float, c_d: int,
                                 pn: int, splits=None) -> torch.Tensor:
    """Single-pass prefix-trie (cascade) decode; returns the normalised
    (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of slot r // pn
      k_ctx/v_ctx: (N, g, m_c, hd) trie-node segments, q's dtype
      paths:       (depth, rows) int32 — the node each row reads at each
                   trie level, -1 for a level it does not use
      node_lens:   (N,) int32 — live length of each node
      k_dec/v_dec: (g, b * c_d, hd); dec_bias (1, b * c_d) f32
      splits:      shares per (64-row tile, kv head) of the work (None:
                   ``split_count`` on the card, 1 on the CPU); 1 runs the
                   single walk, S > 1 S CTAs per tile and head and an exact
                   merge, one launch either way
    Rows whose path holds an id outside [-1, N) come out NaN."""
    if k_ctx.ndim != 4 or v_ctx.shape != k_ctx.shape:
        raise ValueError(f"want k_ctx = v_ctx (N, g, m_c, hd); got "
                         f"{tuple(k_ctx.shape)}, {tuple(v_ctx.shape)}")
    _check_context(q, k_ctx[0], v_ctx[0])
    _check_paths(q, k_ctx, paths, node_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx, v_ctx, paths, node_lens, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return tree_fused_bifurcated_decode_plain(*ops, scale=scale, c_d=c_d,
                                                  pn=pn, splits=splits)
    _check_kernel_operands(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    n_nodes, g, m_c, hd = k_ctx.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(paths.shape[0], m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("tree_fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_nodes,
            paths.shape[0], g, q.shape[1], m_c, ld, hd, c_d, pn, splits,
            n_pieces, float(scale))
    tree_fused_bifurcated_decode.launches += 1
    return out


tree_fused_bifurcated_decode.launches = 0


def tree_fused_bifurcated_decode_q8(q, k_ctx_q, v_ctx_q, k_scale, v_scale,
                                    paths, node_lens, k_dec, v_dec, dec_bias,
                                    *, scale: float, c_d: int, pn: int,
                                    splits=None) -> torch.Tensor:
    """``tree_fused_bifurcated_decode`` over int8 nodes (N, g, m_c, hd) and
    f32 scales (N, g, m_c), ``k_scale`` with the logit scale pre-folded
    (``scale`` applies to the decode arm only). ``splits`` as in
    ``tree_fused_bifurcated_decode``."""
    lead = tuple(k_ctx_q.shape[:1])
    _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale, lead=lead)
    _check_paths(q, k_ctx_q, paths, node_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx_q, v_ctx_q, k_scale, v_scale, paths, node_lens, k_dec,
           v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return tree_fused_bifurcated_decode_q8_plain(
            *ops, scale=scale, c_d=c_d, pn=pn, splits=splits)
    _check_kernel_operands(q, k_ctx_q, v_ctx_q, k_dec, v_dec, dec_bias)
    n_nodes, g, m_c, hd = k_ctx_q.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(paths.shape[0], m_c, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("tree_fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_nodes,
            paths.shape[0], g, q.shape[1], m_c, ld, hd, c_d, pn, splits,
            n_pieces, float(scale))
    tree_fused_bifurcated_decode_q8.launches += 1
    return out


tree_fused_bifurcated_decode_q8.launches = 0

# ---------------------------------------------------------------------------
# paged pool (csrc/paged_decode.cu)
# ---------------------------------------------------------------------------

def _paged_bad_rows(paths, page_tables, seg_lens, n_pages, pm, max_id):
    """(rows,) bool: the rows whose path holds an id outside [-1, max_id],
    or a segment whose live table entries name an id outside [-1, P)."""
    n_segs, ppn = page_tables.shape
    pr = paths.long()
    needed = (seg_lens.long() + pm - 1) // pm
    live_slot = (torch.arange(ppn, device=paths.device)[None, :]
                 < needed[:, None])
    poisoned = (live_slot & ((page_tables < -1) | (page_tables >= n_pages))
                ).any(1)
    in_table = (pr >= 0) & (pr < n_segs)
    return (((pr < -1) | (pr > max_id))
            | (in_table & poisoned[pr.clamp(0, n_segs - 1)])).any(0)


def _paged_split_walk(q, k_pages, v_pages, k_sp, v_sp, page_tables,
                      seg_lens, paths, k_dec, v_dec, dec_bias, bad, *, scale,
                      c_d, pn, merge, **packed):
    """``_split_walk`` over the segments of a page pool (``packed``: #11's
    n_dec, row_slot and fresh)."""
    n_pages, _, pm, _ = k_pages.shape
    n_segs, ppn = page_tables.shape
    lens = seg_lens.tolist()

    def fetch(seg, a, b):
        # keys [a, b) of a segment through its page table: holes and ids
        # outside the pool are not read (masked, values zeroed)
        cols = torch.arange(a, b, device=q.device)
        pid = page_tables[seg].long()[cols // pm]
        ok = (pid >= 0) & (pid < n_pages)
        pid, off = pid.clamp(0, n_pages - 1), cols % pm
        sc = ((None, None) if k_sp is None
              else (k_sp[pid, :, off].T, v_sp[pid, :, off].T))
        return (k_pages[pid, :, off].transpose(0, 1),
                v_pages[pid, :, off].transpose(0, 1), *sc, ok)

    return _split_walk(
        q, fetch, n_segs, lambda n: min(max(int(lens[n]), 0), ppn * pm),
        paths, k_dec, v_dec, dec_bias, bad, scale=scale, c_d=c_d, pn=pn,
        block_m=BLOCK_M, merge=merge, **packed)


def _paged_plain(q, k_pages, v_pages, k_sp, v_sp, page_tables, seg_lens,
                 paths, k_dec, v_dec, dec_bias, *, scale, c_d, pn, splits=1,
                 merge=merge_partials):
    from repro_torch.kernels.ops import live_page_list

    n_pages, _, pm, _ = k_pages.shape
    n_segs, ppn = page_tables.shape
    bad = _paged_bad_rows(paths, page_tables, seg_lens, n_pages, pm,
                          n_segs - 1)
    if splits > 1:
        return _paged_split_walk(q, k_pages, v_pages, k_sp, v_sp,
                                 page_tables, seg_lens, paths, k_dec, v_dec,
                                 dec_bias, bad, scale=scale, c_d=c_d, pn=pn,
                                 merge=merge)
    ids, segs, n_live, page_bias = live_page_list(page_tables, seg_lens, pm)
    n_live = int(n_live[0])
    pr = paths.long()
    qf = q.float()
    acc, m, l = _init_state(q)
    # the live pages in (segment, page) order, as the Pallas grid walks
    # them: every row rides every page, rows off the page's segment masked
    for i, (pid, seg) in enumerate(zip(ids[:n_live].tolist(),
                                       segs[:n_live].tolist())):
        if pid >= n_pages:              # outside the pool: never read
            continue
        on = (pr == seg).any(0)                              # (rows,)
        s = torch.matmul(qf, k_pages[pid].float().transpose(1, 2))
        s = s * (scale if k_sp is None else k_sp[pid][:, None, :])
        # the ragged tail and the rows off the page's segment at NEG_INF
        # (the reference adds the tail's bias: the same bits for any finite
        # logit); the tail's values zeroed, as the kernel zero-fills them,
        # so whatever a page holds past its segment never reaches the output
        tail = page_bias[i] < 0
        s = torch.where(tail[None, None, :] | ~on[None, :, None],
                        torch.full((), NEG_INF, device=q.device), s)
        v = v_pages[pid].masked_fill(tail[None, :, None], 0)
        if k_sp is None:
            acc, m, l = _online_update(s, v, acc, m, l)
        else:
            acc, m, l = _online_update(s, v.float(), acc, m, l,
                                       p_scale=v_sp[pid][:, None, :])
    out = _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                scale=scale, c_d=c_d, pn=pn)
    return out.masked_fill(bad[None, :, None], float("nan"))


def paged_fused_bifurcated_decode_plain(q, k_pages, v_pages, page_tables,
                                        seg_lens, paths, k_dec, v_dec,
                                        dec_bias, *, scale: float, c_d: int,
                                        pn: int, splits: int = 1
                                        ) -> torch.Tensor:
    """Plain PyTorch version of ``paged_fused_bifurcated_decode``: at
    ``splits`` 1 the reference's page walk. Every live page of
    ``ops.live_page_list``, in (segment, page) order, folds into the
    running state of all rows, its ragged tail biased to NEG_INF and the
    rows whose path does not hold its segment masked; then the decode arm
    as in the fused version. At S > 1 the kernel's pieces, keys read
    through the page tables, merged exactly per row (``_split_walk``; the
    same for any S > 1)."""
    return _paged_plain(q, k_pages, v_pages, None, None, page_tables,
                        seg_lens, paths, k_dec, v_dec, dec_bias, scale=scale,
                        c_d=c_d, pn=pn, splits=splits)


def paged_fused_bifurcated_decode_q8_plain(q, k_pages_q, v_pages_q,
                                           k_scale_pages, v_scale_pages,
                                           page_tables, seg_lens, paths,
                                           k_dec, v_dec, dec_bias, *,
                                           scale: float, c_d: int, pn: int,
                                           splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``paged_fused_bifurcated_decode_q8``: the
    walks of the bf16 version over int8 pages, the logits scaled by the
    page's k scales (logit scale folded) and the weights by its v scales,
    ``l`` unscaled."""
    return _paged_plain(q, k_pages_q, v_pages_q, k_scale_pages,
                        v_scale_pages, page_tables, seg_lens, paths, k_dec,
                        v_dec, dec_bias, scale=scale, c_d=c_d, pn=pn,
                        splits=splits)


def _check_paged(q, k_pages, v_pages, page_tables, seg_lens, paths,
                 k_sp=None, v_sp=None):
    """A (P, g, pm, hd) pool fitting q (int8 with (P, g, pm) f32 scales
    when ``k_sp`` is given, else q's dtype), (N, ppn) int32 page tables,
    (N,) int32 lengths and a (depth, rows) int32 path table."""
    if q.ndim != 3:
        raise ValueError(f"want q (g, rows, hd); got {tuple(q.shape)}")
    g, rows, hd = q.shape
    if (k_pages.ndim != 4 or v_pages.shape != k_pages.shape
            or k_pages.shape[1] != g or k_pages.shape[3] != hd
            or k_pages.shape[0] < 1 or k_pages.shape[2] < 1):
        raise ValueError(f"page pool {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} does not fit q "
                         f"{tuple(q.shape)}: want (P, g, pm, hd), P, pm >= 1")
    if k_pages.shape[0] * g * k_pages.shape[2] >= 2**31:
        raise ValueError(f"page pool {tuple(k_pages.shape)}: the kernels "
                         f"address fewer than 2^31 key rows (P * g * pm)")
    if k_sp is None:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError("page pool must have the query's dtype")
    else:
        if (k_sp.shape != k_pages.shape[:3] or v_sp.shape != k_sp.shape):
            raise ValueError(f"scale pages {tuple(k_sp.shape)} do not fit "
                             f"the pool {tuple(k_pages.shape)}")
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError("int8 page pool values must be int8")
        if k_sp.dtype != torch.float32 or v_sp.dtype != torch.float32:
            raise TypeError("scale pages must be float32")
    n_segs = page_tables.shape[0] if page_tables.ndim == 2 else -1
    if (page_tables.ndim != 2 or min(page_tables.shape) < 1
            or seg_lens.shape != (n_segs,) or paths.ndim != 2
            or paths.shape[1] != rows):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} / "
                         f"seg_lens {tuple(seg_lens.shape)} / paths "
                         f"{tuple(paths.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= paths.shape[0] <= MAX_TREE_DEPTH or n_segs > MAX_TREE_NODES:
        raise ValueError(f"paths of depth {paths.shape[0]} over {n_segs} "
                         f"segments: the kernels take depth "
                         f"1..{MAX_TREE_DEPTH} and at most {MAX_TREE_NODES}"
                         f" segments")
    if (page_tables.dtype != torch.int32 or seg_lens.dtype != torch.int32
            or paths.dtype != torch.int32):
        raise TypeError("page_tables, seg_lens and paths must be int32")


def paged_fused_bifurcated_decode(q, k_pages, v_pages, page_tables, seg_lens,
                                  paths, k_dec, v_dec, dec_bias, *,
                                  scale: float, c_d: int, pn: int,
                                  splits=None) -> torch.Tensor:
    """Single-pass paged decode; returns the normalised (g, rows, hd).

      q:             (g, rows, hd), rows = b * p * n, row r of slot r // pn
      k_pages/v_pages: (P, g, pm, hd) one layer's page pool, q's dtype
      page_tables:   (N, ppn) int32 — pool page per (segment, page slot),
                     -1 unallocated
      seg_lens:      (N,) int32 — live length of each segment
      paths:         (depth, rows) int32 — the segment each row reads at
                     each level, -1 for a level it does not use
      k_dec/v_dec:   (g, b * c_d, hd); dec_bias (1, b * c_d) f32
      splits:        as in ``tree_fused_bifurcated_decode``; the shares are
                     cut by logical key positions, so on one logical trie
                     the two compute the same bits at the same ``splits``,
                     at any page size, and on a single prefix
                     ``fused_bifurcated_decode``'s
    Only live pages of segments on some path are read; a -1 entry inside a
    live length is a hole, its keys masked. Rows whose path holds an id
    outside [-1, N), or a segment whose live pages name an id outside
    [-1, P), come out NaN: page ids are device data, so the kernel checks
    them itself instead of the wrapper reading them back."""
    _check_paged(q, k_pages, v_pages, page_tables, seg_lens, paths)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_pages, v_pages, page_tables, seg_lens, paths, k_dec, v_dec,
           dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return paged_fused_bifurcated_decode_plain(*ops, scale=scale,
                                                   c_d=c_d, pn=pn,
                                                   splits=splits)
    _check_kernel_operands(q, k_pages, v_pages, k_dec, v_dec, dec_bias)
    n_pages, g, pm, hd = k_pages.shape
    n_segs, ppn = page_tables.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(paths.shape[0], ppn * pm, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("paged_fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_pages, n_segs,
            ppn, pm, paths.shape[0], g, q.shape[1], ld, hd, c_d, pn, splits,
            n_pieces, float(scale))
    paged_fused_bifurcated_decode.launches += 1
    return out


paged_fused_bifurcated_decode.launches = 0


def paged_fused_bifurcated_decode_q8(q, k_pages_q, v_pages_q, k_scale_pages,
                                     v_scale_pages, page_tables, seg_lens,
                                     paths, k_dec, v_dec, dec_bias, *,
                                     scale: float, c_d: int, pn: int,
                                     splits=None) -> torch.Tensor:
    """``paged_fused_bifurcated_decode`` over an int8 pool (P, g, pm, hd)
    and f32 scale pages (P, g, pm), ``k_scale_pages`` with the logit scale
    pre-folded (``scale`` applies to the decode arm only). ``splits`` as in
    ``paged_fused_bifurcated_decode``: on one logical trie the same bits
    as ``tree_fused_bifurcated_decode_q8`` at the same ``splits``, at any
    page size, and on a single prefix ``fused_bifurcated_decode_q8``'s."""
    _check_paged(q, k_pages_q, v_pages_q, page_tables, seg_lens, paths,
                 k_scale_pages, v_scale_pages)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_pages_q, v_pages_q, k_scale_pages, v_scale_pages,
           page_tables, seg_lens, paths, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    cuda = _on_cuda(*ops)
    splits = _split_arg(splits, q, cuda)
    if not cuda:
        return paged_fused_bifurcated_decode_q8_plain(
            *ops, scale=scale, c_d=c_d, pn=pn, splits=splits)
    _check_kernel_operands(q, k_pages_q, v_pages_q, k_dec, v_dec, dec_bias)
    n_pages, g, pm, hd = k_pages_q.shape
    n_segs, ppn = page_tables.shape
    out = torch.empty_like(q)
    n_pieces = max_pieces(paths.shape[0], ppn * pm, c_d)
    part = _split_scratch(q, splits, n_pieces)
    _launch("paged_fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), n_pages, n_segs,
            ppn, pm, paths.shape[0], g, q.shape[1], ld, hd, c_d, pn, splits,
            n_pieces, float(scale))
    paged_fused_bifurcated_decode_q8.launches += 1
    return out


paged_fused_bifurcated_decode_q8.launches = 0

# ---------------------------------------------------------------------------
# packed heterogeneous step (csrc/packed_decode.cu)
# ---------------------------------------------------------------------------

def _packed_walk(q, k_pages, v_pages, k_sp, v_sp, k_tiles, v_tiles,
                      ent_kind, ent_seg, ent_pdma, ent_fdma, ent_pos, n_ent,
                      paths, ent_bias, row_pos, row_slot, k_dec=None,
                      v_dec=None, dec_bias=None, *, scale: float, c_d: int,
                      carry=None, emit_partials: bool = False):
    """The reference's packed kernel as a walk over its work queue
    (``ops.packed_work_queue``): entry by entry, a pool page (kind 0) or a
    fresh tile of the chunk envelope (kind 1, ``k_tiles``/``v_tiles``
    (F, g, pm, hd)), each with the reference's op sequence: the logits
    scaled (int8 pages: by their k scales), the entry's bias (here as a
    select to NEG_INF, the ragged tail's values zeroed), the rows off the
    entry's segment masked, and on fresh tiles the causal term
    ``ent_pos + col <= row_pos[row]``; then the online update (int8 pages
    weight the values by their v scales). Then the decode arm keyed by
    ``row_slot`` and the normalisation. ``carry`` seeds the fp32 state
    (acc, m, l) from an earlier walk; ``emit_partials`` returns the raw
    state instead of the decode arm, so chained walks over a split queue
    give one walk's bits."""
    n_pages, _, pm, _ = k_pages.shape
    dev = q.device
    qf = q.float()
    acc, m, l = _init_state(q) if carry is None else carry
    pr = paths.long()
    cols = torch.arange(pm, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    n = int(n_ent[0])
    entries = zip(*(t[:n].tolist() for t in (ent_kind, ent_seg, ent_pdma,
                                             ent_fdma, ent_pos)))
    for i, (kind, seg, pid, fid, pos) in enumerate(entries):
        on = (pr == seg).any(0)                              # (rows,)
        tail = ent_bias[i] < 0
        p_scale = None
        if kind == 0:
            if pid >= n_pages:          # outside the pool: never read
                continue
            k, v = k_pages[pid], v_pages[pid]
            s = torch.matmul(qf, k.float().transpose(1, 2))
            s = s * (scale if k_sp is None else k_sp[pid][:, None, :])
            masked = tail[None, None, :] | ~on[None, :, None]
            if v_sp is not None:
                p_scale = v_sp[pid][:, None, :]
        else:
            k, v = k_tiles[fid], v_tiles[fid]
            s = torch.matmul(qf, k.float().transpose(1, 2)) * scale
            causal = (pos + cols)[None, :] <= row_pos.long()[:, None]
            masked = tail[None, None, :] | ~(on[:, None] & causal)[None]
        s = torch.where(masked, neg, s)
        v = v.masked_fill(tail[None, :, None], 0)
        if k_sp is None:
            acc, m, l = _online_update(s, v, acc, m, l)
        else:   # int8 pages' values f32; the fresh tiles' weights unscaled
            acc, m, l = _online_update(s, v.float(), acc, m, l,
                                       p_scale=p_scale)
    if emit_partials:
        return acc, m, l
    return _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                 scale=scale, c_d=c_d, row_slot=row_slot)


def _packed_plain(q, k_pages, v_pages, k_sp, v_sp, k_fresh, v_fresh,
                  page_tables, seg_lens, paths, row_pos, row_slot, k_dec,
                  v_dec, dec_bias, *, fresh_len, fresh_start, scale, c_d,
                  pn, entries_per_launch=None, splits=1,
                  merge=merge_partials):
    from repro_torch.kernels.ops import (
        _fresh_tiles,
        _packed_launches,
        packed_work_queue,
    )

    n_pages, g, pm, hd = k_pages.shape
    n_segs = page_tables.shape[0]
    bad = _paged_bad_rows(paths, page_tables, seg_lens, n_pages, pm, n_segs)
    if max(_packed_pair(splits)) > 1:
        if entries_per_launch is not None:
            raise ValueError("entries_per_launch chains the queue walk of "
                             "splits=1; the split walk takes none")
        # the envelope's value product as the queue walk's (f32 for int8
        # pages)
        v_env = v_fresh if k_sp is None else v_fresh.float()
        return _paged_split_walk(
            q, k_pages, v_pages, k_sp, v_sp, page_tables, seg_lens, paths,
            k_dec, v_dec, dec_bias, bad, scale=scale, c_d=c_d, pn=pn,
            merge=merge, n_dec=(k_dec.shape[1] // c_d) * pn,
            row_slot=row_slot,
            fresh=(k_fresh, v_env, int(fresh_len), int(fresh_start),
                   row_pos))
    k_tiles, v_tiles, fcap = _fresh_tiles(k_fresh, v_fresh, pm, g, hd)
    *queue, ent_bias = packed_work_queue(
        page_tables, seg_lens, pm, fresh_len=fresh_len,
        fresh_start=fresh_start, num_fresh_tiles=fcap, pseudo_seg=n_segs)

    def walk(kind, seg, pdma, fdma, pos, n_ent, bias, kd_args, *, carry,
             emit_partials):
        return _packed_walk(
            q, k_pages, v_pages, k_sp, v_sp, k_tiles, v_tiles, kind, seg,
            pdma, fdma, pos, n_ent, paths, bias, row_pos, row_slot,
            *kd_args, scale=scale, c_d=c_d, carry=carry,
            emit_partials=emit_partials)

    kd_args = (k_dec, v_dec, dec_bias)
    if entries_per_launch is not None and entries_per_launch < len(queue[0]):
        out = _packed_launches(walk, queue, ent_bias, entries_per_launch,
                               kd_args)
    else:
        out = walk(*queue, ent_bias, kd_args, carry=None,
                   emit_partials=False)
    return out.masked_fill(bad[None, :, None], float("nan"))


def packed_fused_bifurcated_decode_plain(q, k_pages, v_pages, k_fresh,
                                         v_fresh, page_tables, seg_lens,
                                         paths, row_pos, row_slot, k_dec,
                                         v_dec, dec_bias, *, fresh_len: int,
                                         fresh_start: int, scale: float,
                                         c_d: int, pn: int,
                                         entries_per_launch=None,
                                         splits=1) -> torch.Tensor:
    """Plain PyTorch version of ``packed_fused_bifurcated_decode``: at
    ``splits`` 1 the reference's work queue (``ops.packed_work_queue``:
    the live pages in (segment, page) order, then the envelope's
    ``ceil(fresh_len / pm)`` fresh tiles) walked by ``_packed_walk``;
    ``entries_per_launch`` chains walks of that many entries
    (bit-identical to one walk). At S > 1 (or a pair, as the wrapper
    takes) the kernel's pieces (``_split_walk``: the decode rows' tiles as
    #8's, the chunk rows' in 2048-key pieces with the envelope after their
    ancestors), merged exactly per row; the same for any S > 1. Rows whose
    path holds an id outside [-1, N], or a segment whose live pages name
    an id outside [-1, P), come out NaN."""
    return _packed_plain(q, k_pages, v_pages, None, None, k_fresh, v_fresh,
                         page_tables, seg_lens, paths, row_pos, row_slot,
                         k_dec, v_dec, dec_bias, fresh_len=fresh_len,
                         fresh_start=fresh_start, scale=scale, c_d=c_d,
                         pn=pn, entries_per_launch=entries_per_launch,
                         splits=splits)


def packed_fused_bifurcated_decode_q8_plain(q, k_pages_q, v_pages_q,
                                            k_scale_pages, v_scale_pages,
                                            k_fresh, v_fresh, page_tables,
                                            seg_lens, paths, row_pos,
                                            row_slot, k_dec, v_dec, dec_bias,
                                            *, fresh_len: int,
                                            fresh_start: int, scale: float,
                                            c_d: int, pn: int,
                                            entries_per_launch=None,
                                            splits=1) -> torch.Tensor:
    """Plain PyTorch version of ``packed_fused_bifurcated_decode_q8``: at
    ``splits`` 1 the queue walk over int8 pages (logits by their k scales,
    the logit scale folded; weights by their v scales) and the envelope's
    fresh tiles in the activation dtype (logits by ``scale``, weights
    unscaled); ``splits`` as in ``packed_fused_bifurcated_decode_plain``
    (the decode rows' tiles as #9's)."""
    return _packed_plain(q, k_pages_q, v_pages_q, k_scale_pages,
                         v_scale_pages, k_fresh, v_fresh, page_tables,
                         seg_lens, paths, row_pos, row_slot, k_dec, v_dec,
                         dec_bias, fresh_len=fresh_len,
                         fresh_start=fresh_start, scale=scale, c_d=c_d,
                         pn=pn, entries_per_launch=entries_per_launch,
                         splits=splits)


def _check_packed(q, k_pages, k_fresh, v_fresh, row_pos, row_slot, k_dec,
                  v_dec, dec_bias, fresh_len, c_d, pn):
    """The packed kernels' own operands: a (F*pm, g, hd) fresh envelope in
    q's dtype holding ``fresh_len`` live rows, (rows,) int32 row positions
    and slots, and a decode arm of b * c_d slots whose b * pn decode rows
    come first. Returns (ld, n_dec)."""
    g, rows, hd = q.shape
    pm = k_pages.shape[2]
    if (k_fresh.ndim != 3 or v_fresh.shape != k_fresh.shape
            or k_fresh.shape[1:] != (g, hd) or k_fresh.shape[0] < pm
            or k_fresh.shape[0] % pm):
        raise ValueError(f"fresh envelope {tuple(k_fresh.shape)} / "
                         f"{tuple(v_fresh.shape)} does not fit q "
                         f"{tuple(q.shape)}: want (F * pm, g, hd), F >= 1, "
                         f"pm = {pm}")
    if k_fresh.dtype != q.dtype or v_fresh.dtype != q.dtype:
        raise TypeError("fresh envelope must have the query's dtype")
    if not 0 <= fresh_len <= k_fresh.shape[0]:
        raise ValueError(f"fresh_len {fresh_len} outside the envelope's "
                         f"{k_fresh.shape[0]} rows")
    if row_pos.shape != (rows,) or row_slot.shape != (rows,):
        raise ValueError(f"row_pos {tuple(row_pos.shape)} / row_slot "
                         f"{tuple(row_slot.shape)} do not fit {rows} rows")
    if row_pos.dtype != torch.int32 or row_slot.dtype != torch.int32:
        raise TypeError("row_pos and row_slot must be int32")
    ld = k_dec.shape[1] if k_dec.ndim == 3 else -1
    n_dec = (ld // c_d) * pn if ld > 0 and c_d > 0 and pn > 0 else -1
    if (k_dec.shape != (g, ld, hd) or v_dec.shape != k_dec.shape
            or dec_bias.shape != (1, ld) or ld % c_d
            or not 0 <= n_dec <= rows):
        raise ValueError(f"decode arm {tuple(k_dec.shape)}, bias "
                         f"{tuple(dec_bias.shape)} do not fit q "
                         f"{tuple(q.shape)} with c_d={c_d}, pn={pn}")
    if k_dec.dtype != q.dtype or v_dec.dtype != q.dtype:
        raise TypeError("decode arm must have the query's dtype")
    if dec_bias.dtype != torch.float32:
        raise TypeError("dec_bias must be float32")
    return ld, n_dec


def _packed_launch(name, q, pool, fresh, page_tables, paths, ops, ld,
                   n_dec, fresh_len, fresh_start, scale, c_d, pn, splits):
    """One launch of a packed kernel at ``splits``, its (decode tiles',
    chunk tiles') shares, the split walk's scratch sized by the pieces
    each kind of row may read."""
    _check_kernel_operands(q, *pool, *fresh, *ops[-3:])
    n_pages, g, pm, hd = pool[0].shape
    n_segs, ppn = page_tables.shape
    rows, depth = q.shape[1], paths.shape[0]
    out = torch.empty_like(q)
    ints = (n_pages, n_segs, ppn, pm, depth, g, rows, n_dec, ld, hd, c_d, pn,
            int(fresh_len), int(fresh_start))
    keys = max(ppn * pm, fresh[0].shape[0])   # a node's or the envelope's
    n_pieces = max_pieces(depth, keys, c_d)
    n_chunk = max_pieces(depth, keys, 0, CHUNK_PIECE_BLOCKS)
    part = _split_scratch(q, max(splits), n_pieces, n_dec, n_chunk)
    _launch(name, q.device, *(t.data_ptr() for t in ops), out.data_ptr(),
            None if part is None else part.data_ptr(), *ints, *splits,
            n_pieces, n_chunk, float(scale))
    return out


def packed_fused_bifurcated_decode(q, k_pages, v_pages, k_fresh, v_fresh,
                                   page_tables, seg_lens, paths, row_pos,
                                   row_slot, k_dec, v_dec, dec_bias, *,
                                   fresh_len: int, fresh_start: int,
                                   scale: float, c_d: int, pn: int,
                                   splits=None) -> torch.Tensor:
    """One packed heterogeneous step; returns the normalised (g, rows, hd).

      q:             (g, rows, hd): the b * pn decode rows (row r of slot
                     r // pn), then the chunk rows
      k_pages/v_pages: (P, g, pm, hd) one layer's page pool, q's dtype
      k_fresh/v_fresh: (F * pm, g, hd) the chunk's KV envelope, q's dtype;
                     its first ``fresh_len`` rows are live, row j at
                     absolute position ``fresh_start + j``
      page_tables:   (N, ppn) int32; seg_lens (N,) int32
      paths:         (depth + 1, rows) int32: the segment each row reads at
                     each level, -1 unused; the pseudo-segment id N marks
                     the rows that read the fresh envelope
      row_pos:       (rows,) int32: a chunk row sees envelope row j iff
                     fresh_start + j <= row_pos[row]
      row_slot:      (rows,) int32: the decode slot of each row, -1 none
      k_dec/v_dec:   (g, b * c_d, hd); dec_bias (1, b * c_d) f32
      splits:        shares per (64-row tile, kv head), an int or a pair
                     (decode rows' tiles, chunk rows' tiles); None:
                     ``packed_split_count`` on the card, 1 on the CPU; 1
                     runs the single walk, else the decode rows' tiles are
                     #8's split walk and the chunk rows' tiles walk their
                     ancestors and the envelope in 2048-key pieces, merged
                     exactly, one launch either way
    Each row attends its path's live pages, the envelope (causal) if its
    path holds N, and its own slot's decode arm. The decode rows' result
    is ``paged_fused_bifurcated_decode``'s at the same decode ``splits``,
    bit for bit, with or without the chunk. Rows whose path holds an id
    outside [-1, N], or a segment whose live pages name an id outside
    [-1, P), come out NaN."""
    _check_paged(q, k_pages, v_pages, page_tables, seg_lens, paths)
    ld, n_dec = _check_packed(q, k_pages, k_fresh, v_fresh, row_pos,
                              row_slot, k_dec, v_dec, dec_bias, fresh_len,
                              c_d, pn)
    ops = (q, k_pages, v_pages, k_fresh, v_fresh, page_tables, seg_lens,
           paths, row_pos, row_slot, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    kw = dict(fresh_len=fresh_len, fresh_start=fresh_start, scale=scale,
              c_d=c_d, pn=pn)
    cuda = _on_cuda(*ops)
    splits = _packed_split_arg(splits, q, n_dec, cuda)
    if not cuda:
        return packed_fused_bifurcated_decode_plain(*ops, **kw, splits=splits)
    out = _packed_launch("packed_fused_bifurcated_decode", q,
                         (k_pages, v_pages), (k_fresh, v_fresh),
                         page_tables, paths, ops, ld, n_dec, **kw,
                         splits=splits)
    packed_fused_bifurcated_decode.launches += 1
    return out


packed_fused_bifurcated_decode.launches = 0


def packed_fused_bifurcated_decode_q8(q, k_pages_q, v_pages_q, k_scale_pages,
                                      v_scale_pages, k_fresh, v_fresh,
                                      page_tables, seg_lens, paths, row_pos,
                                      row_slot, k_dec, v_dec, dec_bias, *,
                                      fresh_len: int, fresh_start: int,
                                      scale: float, c_d: int, pn: int,
                                      splits=None) -> torch.Tensor:
    """``packed_fused_bifurcated_decode`` over an int8 pool (P, g, pm, hd)
    and f32 scale pages (P, g, pm), ``k_scale_pages`` with the logit scale
    pre-folded; the fresh envelope stays in q's dtype (``scale`` applies
    to it and to the decode arm). ``splits`` as in
    ``packed_fused_bifurcated_decode``, the decode rows' tiles #9's split
    walk (the same bits as #9 at the same decode S)."""
    _check_paged(q, k_pages_q, v_pages_q, page_tables, seg_lens, paths,
                 k_scale_pages, v_scale_pages)
    ld, n_dec = _check_packed(q, k_pages_q, k_fresh, v_fresh, row_pos,
                              row_slot, k_dec, v_dec, dec_bias, fresh_len,
                              c_d, pn)
    ops = (q, k_pages_q, v_pages_q, k_scale_pages, v_scale_pages, k_fresh,
           v_fresh, page_tables, seg_lens, paths, row_pos, row_slot, k_dec,
           v_dec, dec_bias)
    _check_contiguous(*ops)
    kw = dict(fresh_len=fresh_len, fresh_start=fresh_start, scale=scale,
              c_d=c_d, pn=pn)
    cuda = _on_cuda(*ops)
    splits = _packed_split_arg(splits, q, n_dec, cuda)
    if not cuda:
        return packed_fused_bifurcated_decode_q8_plain(*ops, **kw,
                                                       splits=splits)
    out = _packed_launch("packed_fused_bifurcated_decode_q8", q,
                         (k_pages_q, v_pages_q), (k_fresh, v_fresh),
                         page_tables, paths, ops, ld, n_dec, **kw,
                         splits=splits)
    packed_fused_bifurcated_decode_q8.launches += 1
    return out


packed_fused_bifurcated_decode_q8.launches = 0

# every kernel wrapper of this module, for code that reads or resets the
# launch counts
KERNELS = (fused_bifurcated_decode, context_flash_partials,
           fused_bifurcated_decode_q8, grouped_fused_bifurcated_decode,
           grouped_fused_bifurcated_decode_q8, tree_fused_bifurcated_decode,
           tree_fused_bifurcated_decode_q8, paged_fused_bifurcated_decode,
           paged_fused_bifurcated_decode_q8, packed_fused_bifurcated_decode,
           packed_fused_bifurcated_decode_q8)
