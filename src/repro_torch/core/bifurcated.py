"""Context-aware bifurcated attention (paper §4) — the core contribution.

During incremental decoding in single-context batch sampling, the KV cache is
``K = K_c ⊕ K_d`` where the context part ``K_c`` is identical across the batch
axis. The attention is split into two GEMMs (paper Eq. 3–4):

  ⟨q, K_c⟩ : einsum(bgpnk, m_c g k) -> b g p n m_c    # batch axis absent
  ⟨q, K_d⟩ : einsum(bgpnk, b m_d g k) -> b g p n m_d

joined by concatenation; the value attention is bifurcated the same way and
joined by summation. FLOPs are unchanged, the result is exact up to
reduction order, and the HBM traffic for KV drops from
``g·k·b·(m_c + m_d)`` to ``g·k·(m_c + b·m_d)`` (paper Eq. 5–6).

Two join strategies are provided:

  * ``bifurcated_attention``  — paper-faithful: concatenate context and decode
    logits, one softmax over the full length (Appendix E.3's 4-einsum
    PyTorch reference).
  * ``bifurcated_attention_flash`` — never concatenates; each half keeps
    running (max, sum, value-accumulator) statistics which are merged with
    the standard two-way online-softmax combine. This is the formulation
    the fused CUDA kernel implements (kernels/bifurcated_decode.py), and the
    plain path the serve check holds the kernel path against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.masks import NEG_INF, mask_to_bias


def _decode_bias(decode_mask: torch.Tensor) -> torch.Tensor:
    if decode_mask.ndim == 2:  # (b, C_d)
        return mask_to_bias(decode_mask)[:, None, None, None, :]
    return mask_to_bias(decode_mask)[:, None, None, :, :]  # (b, n, C_d)


def bifurcated_attention(
    q: torch.Tensor,
    k_context: torch.Tensor,
    v_context: torch.Tensor,
    k_decode: torch.Tensor,
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,
    context_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Paper-faithful bifurcated attention (4 einsums + one softmax).

    Args:
      q: (b, g, p, n, k) decode queries (n = 1, or n_g for speculative).
      k_context, v_context: (m_c, g, k) — single shared context, NO batch dim.
      k_decode, v_decode: (b, C_d, g, k) — per-sample decode caches.
      decode_mask: (b, C_d) bool validity of decode-cache slots. If the
        queries carry n > 1 new positions, pass (b, n, C_d) instead.
      context_mask: optional (m_c,) bool (e.g. sliding-window clipping).
      scale: logit scale, default k**-0.5.

    Returns:
      (b, g, p, n, k) — identical to standard attention over K_c ⊕ K_d.
    """
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale

    # ⟨q, K_c⟩ : context GEMM — K_c loaded once for the whole batch.
    logits_c = torch.einsum("bgpnk,mgk->bgpnm", q, k_context).float()
    # ⟨q, K_d⟩ : decode GEMM — batched as usual.
    logits_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_decode).float()
    logits_c = logits_c * scale
    logits_d = logits_d * scale

    if context_mask is not None:
        logits_c = logits_c + mask_to_bias(context_mask)[None, None, None, None, :]
    if decode_mask is not None:
        logits_d = logits_d + _decode_bias(decode_mask)

    m_c = logits_c.shape[-1]
    weights = torch.softmax(torch.cat([logits_c, logits_d], dim=-1), dim=-1)
    w_c = weights[..., :m_c].to(v_context.dtype)
    w_d = weights[..., m_c:].to(v_decode.dtype)

    # ⟨w, V⟩ bifurcated: join by summation (paper Eq. 4).
    out_c = torch.einsum("bgpnm,mgv->bgpnv", w_c, v_context)
    out_d = torch.einsum("bgpnm,bmgv->bgpnv", w_d, v_decode)
    return (out_c + out_d).to(q.dtype)


def _partial_softmax(
    logits: torch.Tensor, v: torch.Tensor, batched: bool, ctx_layout: str = "mgk"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Running-softmax statistics (max, sumexp, acc) for one attention half."""
    m = torch.amax(logits, dim=-1, keepdim=True)  # (b,g,p,n,1)
    # Guard fully-masked rows.
    m = torch.clamp(m, min=NEG_INF / 2)
    e = torch.exp(logits - m)
    s = torch.sum(e, dim=-1, keepdim=True)
    if batched:
        eqn = "bgpnm,bmgv->bgpnv"
    else:
        eqn = "bgpnm,mgv->bgpnv" if ctx_layout == "mgk" else "bgpnm,gmv->bgpnv"
    acc = torch.einsum(eqn, e.to(v.dtype), v).float()
    return m, s, acc


def merge_partials(parts) -> torch.Tensor:
    """Combine [(max, sumexp, acc), ...] partial softmaxes into the output."""
    m_star = parts[0][0]
    for m, _, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    total_s = 0.0
    total_acc = 0.0
    for m, s, acc in parts:
        corr = torch.exp(m - m_star)
        total_s = total_s + s * corr
        total_acc = total_acc + acc * corr
    return total_acc / total_s


def bifurcated_attention_flash(
    q: torch.Tensor,
    k_context: torch.Tensor,
    v_context: torch.Tensor,
    k_decode: torch.Tensor,
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,
    context_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    ctx_layout: str = "mgk",
) -> torch.Tensor:
    """Online-softmax join of the two halves (no logit concatenation).

    Numerically equivalent to ``bifurcated_attention``; this is the reference
    semantics for the fused kernel.

    ``ctx_layout``: "mgk" stores K_c as (m_c, g, k) (einsum-path default);
    "gmk" stores (g, m_c, k) — head-major, the fused kernel's layout.
    """
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale

    eq_qk = "bgpnk,mgk->bgpnm" if ctx_layout == "mgk" else "bgpnk,gmk->bgpnm"
    logits_c = torch.einsum(eq_qk, q, k_context).float() * scale
    if context_mask is not None:
        logits_c = logits_c + mask_to_bias(context_mask)[None, None, None, None, :]
    logits_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_decode).float() * scale
    if decode_mask is not None:
        logits_d = logits_d + _decode_bias(decode_mask)

    part_c = _partial_softmax(logits_c, v_context, batched=False,
                              ctx_layout=ctx_layout)
    part_d = _partial_softmax(logits_d, v_decode, batched=True)
    return merge_partials([part_c, part_d]).to(q.dtype)


def forest_bifurcated_attention(
    q: torch.Tensor,          # (b, g, p, n, k) — flat slot batch
    k_context: torch.Tensor,  # (G, m_c, g, k) "mgk" | (G, g, m_c, k) "gmk"
    v_context: torch.Tensor,
    group_ids: torch.Tensor,  # (b,) int32 — slot -> prefix-group assignment
    ctx_lens: torch.Tensor,   # (G,) int32 — live (ragged) prefix lengths
    k_decode: torch.Tensor,   # (b, C_d, g, k)
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,  # (b, C_d) bool
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Einsum path of multi-prefix FOREST decoding (the grouped kernel's
    semantics): one flat slot batch where slot ``b`` attends over
    ``[context[group_ids[b]][:ctx_lens[group_ids[b]]] ⊕ decode[b]]``.

    The assignment is an arbitrary ``(b,) -> group`` map, which is what a
    continuous-batching slot table produces. The per-sample context gather
    materializes a (b, m_c, ...) tensor — a CORRECTNESS reference; the IO
    claim lives in the kernel, which reads each segment once.
    """
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    gid = group_ids.long()
    kc, vc = k_context[gid], v_context[gid]
    if ctx_layout == "gmk":
        m_c = k_context.shape[2]
        vc = vc.transpose(1, 2)                   # (b, m_c, g, k)
        eq_qk = "bgpnk,bgmk->bgpnm"
    else:
        m_c = k_context.shape[1]
        eq_qk = "bgpnk,bmgk->bgpnm"

    logits_c = torch.einsum(eq_qk, q, kc).float() * scale
    valid_c = (torch.arange(m_c, device=q.device)[None, :]
               < ctx_lens[gid][:, None])
    logits_c = logits_c + mask_to_bias(valid_c)[:, None, None, None, :]
    logits_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_decode).float() * scale
    if decode_mask is not None:
        logits_d = logits_d + mask_to_bias(decode_mask)[:, None, None, None, :]

    part_c = _partial_softmax(logits_c, vc, batched=True)
    part_d = _partial_softmax(logits_d, v_decode, batched=True)
    return merge_partials([part_c, part_d]).to(q.dtype)


def _tree_level_ids(paths: torch.Tensor, lvl: int) -> torch.Tensor:
    """Level ``lvl``'s node ids with SET semantics: an id repeated from an
    earlier level of the same path becomes -1 (it contributes once)."""
    ids = paths[lvl]
    for prev in range(lvl):
        ids = torch.where(ids == paths[prev], torch.full_like(ids, -1), ids)
    return ids


def tree_bad_slots(paths: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(b,) bool — slots whose path holds an id outside [-1, N). The port
    writes NaN for them on every tree path (kernel, plain version, einsum),
    so the engine's non-finite sentinel sees them. The reference has no
    common answer: its einsum path clips such an id to node N - 1, its
    Pallas kernel ignores the level; the engine never makes such ids."""
    return ((paths < -1) | (paths >= n_nodes)).any(0)


def tree_bifurcated_attention(
    q: torch.Tensor,          # (b, g, p, n, k) — flat slot batch
    k_context: torch.Tensor,  # (N, m_c, g, k) "mgk" | (N, g, m_c, k) "gmk"
    v_context: torch.Tensor,
    paths: torch.Tensor,      # (depth, b) int32 — slot -> node id per
                              #   level, -1 = level unused by that slot
    node_lens: torch.Tensor,  # (N,) int32 — live (ragged) node lengths
    k_decode: torch.Tensor,   # (b, C_d, g, k)
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,  # (b, C_d) bool
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Einsum path of prefix-trie (cascade) decoding, the tree kernel's
    semantics: slot ``b`` attends over

        [node[paths[0][b]] ⊕ node[paths[1][b]] ⊕ ... ⊕ decode[b]],

    -1 entries contributing nothing. One partial softmax per trie LEVEL (a
    per-slot gather of that level's node), merged with the decode arm by
    the online-softmax combine. SET semantics, as in the kernel: a node id
    repeated at several levels of one path contributes once. Slots whose
    path holds an id outside [-1, N) come out NaN (``tree_bad_slots``).
    The per-level gathers materialize (b, m_c, ...) tensors — a
    correctness reference. At depth == 1 this is
    ``forest_bifurcated_attention`` with ``paths[0]`` as the groups.
    """
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    n_nodes = k_context.shape[0]
    m_c = k_context.shape[2 if ctx_layout == "gmk" else 1]
    parts = []
    for lvl in range(paths.shape[0]):
        ids = _tree_level_ids(paths, lvl)
        safe = torch.clamp(ids, 0, n_nodes - 1).long()
        kc, vc = k_context[safe], v_context[safe]
        if ctx_layout == "gmk":
            vc = vc.transpose(1, 2)                   # (b, m_c, g, k)
            eq_qk = "bgpnk,bgmk->bgpnm"
        else:
            eq_qk = "bgpnk,bmgk->bgpnm"
        logits = torch.einsum(eq_qk, q, kc).float() * scale
        valid = (ids >= 0)[:, None] & (
            torch.arange(m_c, device=q.device)[None, :]
            < node_lens[safe][:, None])
        logits = logits + mask_to_bias(valid)[:, None, None, None, :]
        parts.append(_partial_softmax(logits, vc, batched=True))

    logits_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_decode).float() * scale
    if decode_mask is not None:
        logits_d = logits_d + mask_to_bias(decode_mask)[:, None, None, None, :]
    parts.append(_partial_softmax(logits_d, v_decode, batched=True))
    out = merge_partials(parts).to(q.dtype)
    bad = tree_bad_slots(paths, n_nodes)
    return out.masked_fill(bad[:, None, None, None, None], float("nan"))
