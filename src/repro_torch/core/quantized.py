"""Int8 quantization of the shared-context KV cache.

After bifurcation the decode memory term is bound by (weights + context KV)
reads. The context cache is written once at prefill and only ever read —
the ideal quantization target. Per-(token, head) symmetric int8 scales:

    K_c ≈ K_q * s_k,   logits_c = (q · K_q) * s_k      (scale folded in)
    out_c = ((w * s_v) · V_q)                           (scale folded in)

The attention logit scale (head_dim**-0.5) is ALSO pre-folded into ``s_k``
at quantize time (``from_prefill`` / ``write_context``), so the context
arm never multiplies by it again; ``scale`` touches the decode arm only.

The int8 values and f32 scales are bit-equal to the reference's
(``repro/core/quantized.py``) on the same float input: scale =
max|x| / 127 floored at 1e-8, round half to even, clip to ±127, and the
fold applied as one f32 multiply.

Layouts mirror ``BifurcatedCache`` / ``GroupedBifurcatedCache`` /
``PrefixTreeCache``:
head-major "gmk" (default) or sequence-major "mgk"; scales follow
(…, g, m_c) / (…, m_c, g). Like the bf16 caches, the port writes in place:
a decode step writes the decode arm into the existing tensors, and the
forest and trie caches' admissions write into their existing segments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.bifurcated import (
    _partial_softmax,
    _tree_level_ids,
    merge_partials,
    tree_bad_slots,
)
from repro_torch.core.kv_cache import (
    BifurcatedCache,
    GroupedBifurcatedCache,
    PrefixTreeCache,
    _write_segment,
)
from repro_torch.core.masks import NEG_INF, mask_to_bias


def quantize_ctx(x: torch.Tensor, fold_scale: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 values (..., hd), f32 scales (...)).

    ``fold_scale`` is multiplied into the returned scales — used to
    pre-fold the attention logit scale (head_dim**-0.5) into ``s_k``."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale * fold_scale


def dequantize_ctx(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


@dataclasses.dataclass
class QuantBifurcatedCache:
    """BifurcatedCache with an int8 context arm.

    k_ctx/v_ctx: int8, (L, g, m_c, hd) under "gmk" (default) or
    (L, m_c, g, hd) under "mgk"; k_scale/v_scale: f32 per-(token, head)
    scales, (L, g, m_c) / (L, m_c, g) following the layout. ``k_scale``
    carries the attention logit scale pre-folded. The decode arm
    (L, b, C_d, g, hd) stays in the activation dtype, written in place by
    each decode step; ``dec_length`` is a host int, as on
    ``BifurcatedCache``.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_length: int
    ctx_layout: str = "gmk"

    @property
    def context_len(self) -> int:
        return self.k_ctx.shape[2 if self.ctx_layout == "gmk" else 1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def from_prefill(k_ctx, v_ctx, batch, dec_capacity, dtype=torch.bfloat16,
                     ctx_layout="gmk"):
        """k_ctx/v_ctx: (L, m_c, g, hd) float (the prefill's layout) —
        quantize + transpose ONCE at cache build; the logit scale hd**-0.5
        is pre-folded into ``k_scale`` here. ``dtype`` sizes the decode
        arm only."""
        n_layers, _, n_groups, head_dim = k_ctx.shape
        if ctx_layout == "gmk":
            k_ctx = k_ctx.transpose(1, 2)  # (L, g, m_c, hd)
            v_ctx = v_ctx.transpose(1, 2)
        kq, ks = quantize_ctx(k_ctx, fold_scale=head_dim**-0.5)
        vq, vs = quantize_ctx(v_ctx)
        dec = (n_layers, batch, dec_capacity, n_groups, head_dim)
        return QuantBifurcatedCache(
            k_ctx=kq.contiguous(), v_ctx=vq.contiguous(),
            k_scale=ks.contiguous(), v_scale=vs.contiguous(),
            k_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            v_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            dec_length=0,
            ctx_layout=ctx_layout,
        )


@dataclasses.dataclass
class GroupedQuantBifurcatedCache:
    """GroupedBifurcatedCache with int8 context segments.

    k_ctx/v_ctx: int8, (L, G, g, m_c, hd) under "gmk" (default) or
    (L, G, m_c, g, hd) under "mgk"; k_scale/v_scale: f32 per-(token, head)
    scales, (L, G, g, m_c) / (L, G, m_c, g) — k_scale carries the logit
    scale pre-folded. Segments quantize ONCE at admission
    (``write_context``). The slot table (``ctx_lens`` / ``group_ids`` /
    ``dec_lens``) is int32 device data, and admission writes into the
    existing tensors, as on ``GroupedBifurcatedCache``.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    ctx_lens: torch.Tensor
    group_ids: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_lens: torch.Tensor
    ctx_layout: str = "gmk"

    n_groups = GroupedBifurcatedCache.n_groups
    context_capacity = GroupedBifurcatedCache.context_capacity
    n_slots = GroupedBifurcatedCache.n_slots
    decode_capacity = GroupedBifurcatedCache.decode_capacity
    assign_slots = GroupedBifurcatedCache.assign_slots

    @staticmethod
    def _shapes(n_layers, n_groups, m_c, n_kv, head_dim, ctx_layout):
        if ctx_layout == "mgk":
            return ((n_layers, n_groups, m_c, n_kv, head_dim),
                    (n_layers, n_groups, m_c, n_kv))
        return ((n_layers, n_groups, n_kv, m_c, head_dim),
                (n_layers, n_groups, n_kv, m_c))

    @staticmethod
    def init(n_layers, n_groups, slots, m_c, dec_capacity, n_kv, head_dim,
             dtype=torch.bfloat16, ctx_layout="gmk", device="cuda"):
        """All-zeros cache: int8 segment values + f32 scales (shapes per
        the class docstring), ``dtype`` decode arm, int32 slot table — the
        same parameter surface as ``GroupedBifurcatedCache.init``."""
        ctx_shape, sc_shape = GroupedQuantBifurcatedCache._shapes(
            n_layers, n_groups, m_c, n_kv, head_dim, ctx_layout)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return GroupedQuantBifurcatedCache(
            k_ctx=torch.zeros(ctx_shape, dtype=torch.int8, device=device),
            v_ctx=torch.zeros(ctx_shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sc_shape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sc_shape, dtype=torch.float32, device=device),
            ctx_lens=torch.zeros(n_groups, **i32),
            group_ids=torch.zeros(slots, **i32),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, **i32),
            ctx_layout=ctx_layout,
        )

    def write_context(self, k_ctx, v_ctx, group_idx: int):
        """Admit + quantize a prefilled context into segment ``group_idx``,
        in place. k_ctx/v_ctx: (L, m_new, g, hd) float. The logit scale
        hd**-0.5 is pre-folded into k_scale; positions past m_new carry
        zero values and zero scales (masked by ``ctx_lens`` in the kernel
        and the einsum path alike). Returns ``self``."""
        m_new = k_ctx.shape[1]
        cap = self.context_capacity
        if m_new > cap:
            raise ValueError(f"context of {m_new} tokens > capacity {cap}")
        _write_quantized(self, k_ctx, v_ctx, group_idx)
        self.ctx_lens[group_idx] = m_new
        return self


def _write_quantized(cache, k_ctx, v_ctx, idx):
    """Quantize (L, m_new, g, hd) float K/V (the logit scale hd**-0.5
    folded into k_scale) and write values and scales into segment ``idx``
    of ``cache``, zeroing the segment past m_new, in place."""
    hd = k_ctx.shape[3]
    kq, ks = quantize_ctx(k_ctx, fold_scale=hd**-0.5)
    vq, vs = quantize_ctx(v_ctx)
    _write_segment(cache.k_ctx, cache.v_ctx, kq, vq, idx, cache.ctx_layout)
    _write_segment(cache.k_scale, cache.v_scale, ks, vs, idx,
                   cache.ctx_layout)


@dataclasses.dataclass
class QuantPrefixTreeCache:
    """PrefixTreeCache with int8 trie-node segments.

    k_ctx/v_ctx: int8, (L, N, g, m_c, hd) under "gmk" (default) or
    (L, N, m_c, g, hd) under "mgk"; k_scale/v_scale: f32 per-(token, head)
    scales, (L, N, g, m_c) / (L, N, m_c, g) — k_scale carries the logit
    scale pre-folded. Nodes quantize ONCE at admission (``write_node``).
    ``node_lens`` / ``paths`` / ``dec_lens`` are int32 device data, and
    admission writes into the existing tensors, as on ``PrefixTreeCache``.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    node_lens: torch.Tensor
    paths: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_lens: torch.Tensor
    ctx_layout: str = "gmk"

    n_nodes = PrefixTreeCache.n_nodes
    depth = PrefixTreeCache.depth
    node_capacity = PrefixTreeCache.node_capacity
    n_slots = PrefixTreeCache.n_slots
    decode_capacity = PrefixTreeCache.decode_capacity
    assign_paths = PrefixTreeCache.assign_paths
    slot_context_lens = PrefixTreeCache.slot_context_lens

    @staticmethod
    def init(n_layers, n_nodes, depth, slots, m_c, dec_capacity, n_kv,
             head_dim, dtype=torch.bfloat16, ctx_layout="gmk", device="cuda"):
        """All-zeros cache: int8 node values + f32 scales, ``dtype`` decode
        arm, int32 trie state — the same parameter surface as
        ``PrefixTreeCache.init``."""
        ctx_shape, sc_shape = GroupedQuantBifurcatedCache._shapes(
            n_layers, n_nodes, m_c, n_kv, head_dim, ctx_layout)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return QuantPrefixTreeCache(
            k_ctx=torch.zeros(ctx_shape, dtype=torch.int8, device=device),
            v_ctx=torch.zeros(ctx_shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sc_shape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sc_shape, dtype=torch.float32, device=device),
            node_lens=torch.zeros(n_nodes, **i32),
            paths=torch.full((depth, slots), -1, **i32),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, **i32),
            ctx_layout=ctx_layout,
        )

    def write_node(self, k_ctx, v_ctx, node_idx: int):
        """Admit + quantize a prefilled KV slice (L, m_new, g, hd) float
        into node ``node_idx``, in place; the logit scale is folded into
        k_scale, positions past m_new carry zero values and scales.
        Returns ``self``."""
        m_new = k_ctx.shape[1]
        cap = self.node_capacity
        if m_new > cap:
            raise ValueError(f"node slice of {m_new} tokens > capacity {cap}")
        _write_quantized(self, k_ctx, v_ctx, node_idx)
        self.node_lens[node_idx] = m_new
        return self


def tree_cache_family(ctx_quant: str = "none"):
    """Prefix-trie analogue of ``forest_cache_family``: the same
    ``init``/``write_node``/``assign_paths`` surface across the bf16 and
    int8 families, selected here."""
    if ctx_quant == "int8":
        return QuantPrefixTreeCache
    if ctx_quant == "none":
        return PrefixTreeCache
    raise ValueError(f"unknown ctx_quant mode: {ctx_quant!r}")


def forest_cache_family(ctx_quant: str = "none"):
    """Grouped (multi-prefix) analogue of ``ctx_cache_family``: the same
    ``init``/``write_context``/``assign_slots`` surface across the bf16
    and int8 families, selected here."""
    if ctx_quant == "int8":
        return GroupedQuantBifurcatedCache
    if ctx_quant == "none":
        return GroupedBifurcatedCache
    raise ValueError(f"unknown ctx_quant mode: {ctx_quant!r}")


def ctx_cache_family(ctx_quant: str = "none"):
    """Map a context-quantization mode to its cache class. The two
    families share the ``from_prefill`` parameter surface (``dtype`` sizes
    the decode arm in both)."""
    if ctx_quant == "int8":
        return QuantBifurcatedCache
    if ctx_quant == "none":
        return BifurcatedCache
    raise ValueError(f"unknown ctx_quant mode: {ctx_quant!r}")


def _q8_context_partial(logits_c, s_v, v_q, eq_v):
    """Context-arm partial softmax with the V scales folded into the
    weights (``l`` unscaled): returns (m, l, acc)."""
    m = torch.clamp(torch.amax(logits_c, dim=-1, keepdim=True),
                    min=NEG_INF / 2)
    e = torch.exp(logits_c - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    acc = torch.einsum(eq_v, e * s_v, v_q.float())
    return m, l, acc


def _decode_partial(q, k_decode, v_decode, decode_mask, scale):
    logits_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_decode).float() * scale
    if decode_mask is not None:
        logits_d = logits_d + mask_to_bias(decode_mask)[:, None, None, None, :]
    return _partial_softmax(logits_d, v_decode, batched=True)


def bifurcated_attention_q8(
    q: torch.Tensor,              # (b, g, p, n, k)
    k_ctx_q: torch.Tensor,        # (m_c, g, hd) int8 "mgk" | (g, m_c, hd) "gmk"
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # (m_c, g) f32 "mgk" | (g, m_c) "gmk";
    v_scale: torch.Tensor,         #   MUST carry the logit scale pre-folded
    k_decode: torch.Tensor,       # (b, C_d, g, hd)
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,
    context_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    ctx_layout: str = "mgk",
) -> torch.Tensor:
    """Flash-merge bifurcated attention with an int8 context arm. Scales
    are folded into logits (K) and weights (V); no dequantized KV tensor is
    materialized. The context logits are NOT multiplied by ``scale`` (it is
    pre-folded into ``k_scale_folded``); ``scale`` applies to the decode
    arm only."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    if ctx_layout == "gmk":
        logits_c = torch.einsum("bgpnk,gmk->bgpnm", q.float(), k_ctx_q.float())
        s_k = k_scale_folded[None, :, None, None, :]
        s_v = v_scale[None, :, None, None, :]
        eq_v = "bgpnm,gmv->bgpnv"
    else:
        logits_c = torch.einsum("bgpnk,mgk->bgpnm", q.float(), k_ctx_q.float())
        s_k = k_scale_folded.T[None, :, None, None, :]
        s_v = v_scale.T[None, :, None, None, :]
        eq_v = "bgpnm,mgv->bgpnv"
    logits_c = logits_c * s_k
    if context_mask is not None:
        logits_c = logits_c + mask_to_bias(context_mask)[None, None, None, None, :]
    part_c = _q8_context_partial(logits_c, s_v, v_ctx_q, eq_v)
    part_d = _decode_partial(q, k_decode, v_decode, decode_mask, scale)
    return merge_partials([part_c, part_d]).to(q.dtype)


def forest_bifurcated_attention_q8(
    q: torch.Tensor,              # (b, g, p, n, k) — flat slot batch
    k_ctx_q: torch.Tensor,        # int8 (G, m_c, g, hd) "mgk" | (G, g, m_c, hd)
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # f32 (G, m_c, g) | (G, g, m_c); MUST
    v_scale: torch.Tensor,         #   carry the logit scale pre-folded
    group_ids: torch.Tensor,      # (b,) int32 — slot -> prefix group
    ctx_lens: torch.Tensor,       # (G,) int32 — live (ragged) prefix lengths
    k_decode: torch.Tensor,       # (b, C_d, g, hd)
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,  # (b, C_d) bool
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Einsum path of the grouped q8 kernel: the flat-batch forest
    semantics of ``core.bifurcated.forest_bifurcated_attention`` with int8
    context segments and scale-folded dequantization. The per-sample
    gather materializes (b, m_c, ...) tensors — a correctness reference;
    the same contract as ``bifurcated_attention_q8`` applies."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    gid = group_ids.long()
    kc, vc = k_ctx_q[gid], v_ctx_q[gid]
    s_k, s_v = k_scale_folded[gid], v_scale[gid]
    if ctx_layout == "gmk":
        m_c = k_ctx_q.shape[2]
        logits_c = torch.einsum("bgpnk,bgmk->bgpnm", q.float(), kc.float())
        s_k = s_k[:, :, None, None, :]
        s_v = s_v[:, :, None, None, :]
        vc = vc.transpose(1, 2)                     # (b, m_c, g, hd)
    else:
        m_c = k_ctx_q.shape[1]
        logits_c = torch.einsum("bgpnk,bmgk->bgpnm", q.float(), kc.float())
        s_k = s_k.transpose(1, 2)[:, :, None, None, :]
        s_v = s_v.transpose(1, 2)[:, :, None, None, :]
    logits_c = logits_c * s_k
    valid_c = (torch.arange(m_c, device=q.device)[None, :]
               < ctx_lens[gid][:, None])
    logits_c = logits_c + mask_to_bias(valid_c)[:, None, None, None, :]
    part_c = _q8_context_partial(logits_c, s_v, vc, "bgpnm,bmgv->bgpnv")
    part_d = _decode_partial(q, k_decode, v_decode, decode_mask, scale)
    return merge_partials([part_c, part_d]).to(q.dtype)


def tree_bifurcated_attention_q8(
    q: torch.Tensor,              # (b, g, p, n, k) — flat slot batch
    k_ctx_q: torch.Tensor,        # int8 (N, m_c, g, hd) "mgk" | (N, g, m_c, hd)
    v_ctx_q: torch.Tensor,
    k_scale_folded: torch.Tensor,  # f32 (N, m_c, g) | (N, g, m_c); MUST
    v_scale: torch.Tensor,         #   carry the logit scale pre-folded
    paths: torch.Tensor,          # (depth, b) int32 — -1 = level unused
    node_lens: torch.Tensor,      # (N,) int32 — live (ragged) node lengths
    k_decode: torch.Tensor,       # (b, C_d, g, hd)
    v_decode: torch.Tensor,
    *,
    decode_mask: Optional[torch.Tensor] = None,  # (b, C_d) bool
    scale: Optional[float] = None,
    ctx_layout: str = "gmk",
) -> torch.Tensor:
    """Einsum path of the tree q8 kernel: the cascade semantics of
    ``core.bifurcated.tree_bifurcated_attention`` (one partial softmax per
    trie level, SET semantics, NaN for slots whose path holds an id
    outside [-1, N)) over int8 node segments with scale-folded
    dequantization; the same contract as ``bifurcated_attention_q8``
    (``scale`` touches the decode arm only). At depth == 1 this is
    ``forest_bifurcated_attention_q8``."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    n_nodes = k_ctx_q.shape[0]
    m_c = k_ctx_q.shape[2 if ctx_layout == "gmk" else 1]
    parts = []
    for lvl in range(paths.shape[0]):
        ids = _tree_level_ids(paths, lvl)
        safe = torch.clamp(ids, 0, n_nodes - 1).long()
        kc, vc = k_ctx_q[safe], v_ctx_q[safe]
        s_k, s_v = k_scale_folded[safe], v_scale[safe]
        if ctx_layout == "gmk":
            logits = torch.einsum("bgpnk,bgmk->bgpnm", q.float(), kc.float())
            s_k = s_k[:, :, None, None, :]
            s_v = s_v[:, :, None, None, :]
            vc = vc.transpose(1, 2)                 # (b, m_c, g, hd)
        else:
            logits = torch.einsum("bgpnk,bmgk->bgpnm", q.float(), kc.float())
            s_k = s_k.transpose(1, 2)[:, :, None, None, :]
            s_v = s_v.transpose(1, 2)[:, :, None, None, :]
        logits = logits * s_k
        valid = (ids >= 0)[:, None] & (
            torch.arange(m_c, device=q.device)[None, :]
            < node_lens[safe][:, None])
        logits = logits + mask_to_bias(valid)[:, None, None, None, :]
        parts.append(_q8_context_partial(logits, s_v, vc,
                                         "bgpnm,bmgv->bgpnv"))
    parts.append(_decode_partial(q, k_decode, v_decode, decode_mask, scale))
    out = merge_partials(parts).to(q.dtype)
    bad = tree_bad_slots(paths, n_nodes)
    return out.masked_fill(bad[:, None, None, None, None], float("nan"))
