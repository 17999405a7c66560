"""KV-cache containers for incremental decoding.

Both cache families are stacked over layers (leading ``L`` axis); the model
loops over layers and hands each one its slice:

  * ``DecodeCache``      — the standard batched cache (b present on every slot).
  * ``BifurcatedCache``  — the paper's layout: an *unbatched* context cache
    shared by every sample (head-major ``(L, g, m_c, k)`` by default, so the
    fused decode kernel reads contiguous blocks with no per-layer transpose;
    sequence-major "mgk" remains available), plus a small batched decode
    cache ``(L, b, C_d, g, k)``. This is the data structure that makes the
    bifurcated GEMM (and its b-fold HBM saving) possible; it also cuts cache
    *storage* from b·(m_c+C_d) to m_c + b·C_d slots (paper §5.2.2).

  * ``GroupedBifurcatedCache`` — the multi-prefix FOREST generalization:
    G fixed-capacity context segments plus a per-SLOT decode arm, with the
    slot table (``ctx_lens`` / ``group_ids`` / ``dec_lens``) as int32
    device tensors.
  * ``PrefixTreeCache`` — the prefix-TRIE (cascade) generalization of the
    forest: N node segments and, per slot, a path of node ids (one per
    trie level), with ``node_lens`` / ``paths`` / ``dec_lens`` as int32
    device tensors.

Unlike the reference's functional updates, the port writes new decode KVs
IN PLACE into the existing arm tensors (``update_layer_cache``); a decode
step returns a cache object that shares those tensors with its input and
carries the advanced length. The single-prefix caches keep their lengths
as host-side Python ints: the step loop runs on the host and slices with
them. The forest and trie caches keep every length on the device and update
their tensors in place at admission too, so admit and retire change data,
never a tensor's shape or storage.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class DecodeCache:
    """Standard batched KV cache. k/v: (L, b, C, g, hd); length: int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int  # number of valid slots, shared across batch


def update_layer_cache(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    index: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (b, n, g, k) new KVs at ``index`` into (b, C, g, k) caches, in
    place. Returns the same two tensors."""
    n = k_new.shape[1]
    if not 0 <= index <= k_cache.shape[1] - n:
        raise IndexError(f"cache write [{index}, {index + n}) outside "
                         f"capacity {k_cache.shape[1]}")
    k_cache[:, index:index + n] = k_new.to(k_cache.dtype)
    v_cache[:, index:index + n] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


@dataclasses.dataclass
class BifurcatedCache:
    """Bifurcated KV cache (paper §4).

    k_ctx/v_ctx — shared context, no batch axis; layout per ``ctx_layout``:
        "gmk" (default): (L, g, m_c, hd) — head-major, contiguous block
        reads for the fused decode kernel, no per-layer transpose copy.
        "mgk":           (L, m_c, g, hd) — sequence-major einsum layout.
    k_dec/v_dec: (L, b, C_d, g, hd) — per-sample decode continuation,
        written in place by each decode step.
    dec_length:  int                — valid decode slots.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
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
        """Build from a single-context prefill result (L, m_c, g, hd).

        The prefill emits sequence-major KV; under the default "gmk" layout
        the one-time transpose happens HERE (cache build) so that the
        per-step decode hot path never pays it again.
        """
        n_layers, _, n_groups, head_dim = k_ctx.shape
        if ctx_layout == "gmk":
            k_ctx = k_ctx.transpose(1, 2)  # (L, g, m_c, hd)
            v_ctx = v_ctx.transpose(1, 2)
        dec = (n_layers, batch, dec_capacity, n_groups, head_dim)
        return BifurcatedCache(
            k_ctx=k_ctx.to(dtype).contiguous(),
            v_ctx=v_ctx.to(dtype).contiguous(),
            k_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            v_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            dec_length=0,
            ctx_layout=ctx_layout,
        )


@dataclasses.dataclass
class GroupedBifurcatedCache:
    """Multi-prefix (forest) bifurcated KV cache: G context segments in one
    batch, continuous-batching ready.

      k_ctx/v_ctx — per ``ctx_layout``:
          "gmk" (default): (L, G, g, m_c, hd) — head-major, contiguous
          block reads for the grouped fused decode kernel.
          "mgk":           (L, G, m_c, g, hd) — sequence-major einsum layout.
      ctx_lens:  (G,) int32 — live (ragged) prefix length per segment.
      group_ids: (slots,) int32 — decode-slot -> segment assignment.
      k_dec/v_dec: (L, slots, C_d, g, hd) — per-slot decode continuation.
      dec_lens:  (slots,) int32 — per-slot decode length.

    All admission state (``ctx_lens`` / ``group_ids`` / ``dec_lens`` and
    the segment contents) is DATA: ``write_context`` and ``assign_slots``
    write into the existing tensors, so no tensor of the cache is ever
    reallocated by admit or retire.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    ctx_lens: torch.Tensor
    group_ids: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_lens: torch.Tensor
    ctx_layout: str = "gmk"

    @property
    def n_groups(self) -> int:
        return self.k_ctx.shape[1]

    @property
    def context_capacity(self) -> int:
        return self.k_ctx.shape[3 if self.ctx_layout == "gmk" else 2]

    @property
    def n_slots(self) -> int:
        return self.k_dec.shape[1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def _ctx_shape(n_layers, n_groups, m_c, n_kv, head_dim, ctx_layout):
        return ((n_layers, n_groups, m_c, n_kv, head_dim)
                if ctx_layout == "mgk"
                else (n_layers, n_groups, n_kv, m_c, head_dim))

    @staticmethod
    def init(n_layers, n_groups, slots, m_c, dec_capacity, n_kv, head_dim,
             dtype=torch.bfloat16, ctx_layout="gmk", device="cuda"):
        """All-zeros cache in ``dtype`` on ``device``: G context segments
        (shapes per the class docstring), decode arm (L, slots, C_d, g,
        hd), int32 bookkeeping (ctx_lens (G,), group_ids/dec_lens
        (slots,))."""
        ctx = GroupedBifurcatedCache._ctx_shape(
            n_layers, n_groups, m_c, n_kv, head_dim, ctx_layout)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        return GroupedBifurcatedCache(
            k_ctx=torch.zeros(ctx, dtype=dtype, device=device),
            v_ctx=torch.zeros(ctx, dtype=dtype, device=device),
            ctx_lens=torch.zeros(n_groups, dtype=torch.int32, device=device),
            group_ids=torch.zeros(slots, dtype=torch.int32, device=device),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, dtype=torch.int32, device=device),
            ctx_layout=ctx_layout,
        )

    def write_context(self, k_ctx, v_ctx, group_idx: int):
        """Admit a prefilled context into segment ``group_idx``, in place.

        k_ctx/v_ctx: (L, m_new, g, hd), the prefill's sequence-major
        layout, m_new <= context_capacity. The one-time transpose (under
        "gmk") happens here, and the segment's tail past m_new is zeroed,
        as the reference's zero-pad to capacity does. Returns ``self``."""
        m_new = k_ctx.shape[1]
        cap = self.context_capacity
        if m_new > cap:
            raise ValueError(f"context of {m_new} tokens > capacity {cap}")
        _write_segment(self.k_ctx, self.v_ctx, k_ctx, v_ctx, group_idx,
                       self.ctx_layout)
        self.ctx_lens[group_idx] = m_new
        return self

    def assign_slots(self, slot_mask: torch.Tensor, group_idx: int):
        """Point the slots selected by ``slot_mask`` (slots,) bool at
        segment ``group_idx`` and reset their decode arms (admit into a
        retired slot: the previous occupant's decode KVs are zeroed), in
        place and with no host sync. Returns ``self``."""
        self.group_ids.masked_fill_(slot_mask, group_idx)
        self.dec_lens.masked_fill_(slot_mask, 0)
        wipe = slot_mask[None, :, None, None, None]
        self.k_dec.masked_fill_(wipe, 0)
        self.v_dec.masked_fill_(wipe, 0)
        return self


@dataclasses.dataclass
class PrefixTreeCache:
    """Prefix-TRIE (cascade) bifurcated KV cache: the L-level
    generalization of ``GroupedBifurcatedCache``. N fixed-capacity node
    segments and, per decode slot, a path of node ids; a slot attends over
    the concatenation of the nodes on its path plus its own decode arm.

      k_ctx/v_ctx — per ``ctx_layout``:
          "gmk" (default): (L, N, g, m_c, hd) — head-major, contiguous
          block reads for the tree fused decode kernel.
          "mgk":           (L, N, m_c, g, hd) — sequence-major einsum layout.
      node_lens: (N,) int32 — live (ragged) token count per node.
      paths:     (depth, slots) int32 — slot -> node id per trie level,
                 -1 = level unused by that slot.
      k_dec/v_dec: (L, slots, C_d, g, hd) — per-slot decode continuation.
      dec_lens:  (slots,) int32 — per-slot decode depth.

    A node's KV is computed with its ancestors in context (prefill the
    concatenation, write each node its token slice), so node identity is
    (ancestor path, tokens). ``write_node`` and ``assign_paths`` write into
    the existing tensors: admission is data, no tensor is reallocated. At
    depth == 1 this is the grouped cache with ``paths[0]`` as
    ``group_ids``.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    node_lens: torch.Tensor
    paths: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_lens: torch.Tensor
    ctx_layout: str = "gmk"

    @property
    def n_nodes(self) -> int:
        return self.k_ctx.shape[1]

    @property
    def depth(self) -> int:
        return self.paths.shape[0]

    @property
    def node_capacity(self) -> int:
        return self.k_ctx.shape[3 if self.ctx_layout == "gmk" else 2]

    @property
    def n_slots(self) -> int:
        return self.k_dec.shape[1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def init(n_layers, n_nodes, depth, slots, m_c, dec_capacity, n_kv,
             head_dim, dtype=torch.bfloat16, ctx_layout="gmk", device="cuda"):
        """All-zeros cache in ``dtype`` on ``device``. ``m_c`` is the
        per-NODE capacity, ``depth`` the path table's height; ``paths``
        start at -1 (no slot attends any node until ``assign_paths``)."""
        ctx = GroupedBifurcatedCache._ctx_shape(
            n_layers, n_nodes, m_c, n_kv, head_dim, ctx_layout)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return PrefixTreeCache(
            k_ctx=torch.zeros(ctx, dtype=dtype, device=device),
            v_ctx=torch.zeros(ctx, dtype=dtype, device=device),
            node_lens=torch.zeros(n_nodes, **i32),
            paths=torch.full((depth, slots), -1, **i32),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, **i32),
            ctx_layout=ctx_layout,
        )

    def write_node(self, k_ctx, v_ctx, node_idx: int):
        """Admit a prefilled KV slice into trie node ``node_idx``, in place.

        k_ctx/v_ctx: (L, m_new, g, hd), the prefill's sequence-major
        layout, m_new <= node_capacity, computed WITH the node's ancestors
        in context. The one-time transpose (under "gmk") happens here and
        the node's tail past m_new is zeroed, as in
        ``GroupedBifurcatedCache.write_context``. Returns ``self``."""
        m_new = k_ctx.shape[1]
        cap = self.node_capacity
        if m_new > cap:
            raise ValueError(f"node slice of {m_new} tokens > capacity {cap}")
        _write_segment(self.k_ctx, self.v_ctx, k_ctx, v_ctx, node_idx,
                       self.ctx_layout)
        self.node_lens[node_idx] = m_new
        return self

    def assign_paths(self, slot_mask: torch.Tensor,
                     path_column: torch.Tensor):
        """Point the slots selected by ``slot_mask`` (slots,) bool at the
        trie path ``path_column`` ((depth,) int32, -1 for unused levels)
        and reset their decode arms (the previous occupant's decode KVs
        are zeroed), in place and with no host sync. Returns ``self``."""
        self.paths.copy_(torch.where(slot_mask[None, :],
                                     path_column.to(self.paths)[:, None],
                                     self.paths))
        self.dec_lens.masked_fill_(slot_mask, 0)
        wipe = slot_mask[None, :, None, None, None]
        self.k_dec.masked_fill_(wipe, 0)
        self.v_dec.masked_fill_(wipe, 0)
        return self

    def slot_context_lens(self) -> torch.Tensor:
        """(slots,) int32 — total live context per slot: the node lengths
        along its path summed (-1 levels count zero). This is each slot's
        absolute decode position base."""
        safe = torch.clamp(self.paths, 0, self.n_nodes - 1).long()
        per_level = torch.where(self.paths >= 0, self.node_lens[safe], 0)
        return per_level.sum(0).to(torch.int32)


def _write_segment(dst_k, dst_v, k, v, group_idx, ctx_layout):
    """Write (L, m_new, g, ...) context values into segment ``group_idx``
    of the (L, G, ...) slabs ``dst_k``/``dst_v`` (layout per
    ``ctx_layout``: the segment axis of m_new positions is 3 under "gmk",
    2 under "mgk"), zeroing the segment past m_new. Values are cast to the
    slab's dtype."""
    m_new = k.shape[1]
    axis = 3 if ctx_layout == "gmk" else 2
    for dst, src in ((dst_k, k), (dst_v, v)):
        seg = dst[:, group_idx]                     # (L, ...) view
        if ctx_layout == "gmk":
            src = src.transpose(1, 2)               # (L, g, m_new, ...)
        seg.narrow(axis - 1, 0, m_new).copy_(src)
        seg.narrow(axis - 1, m_new, seg.shape[axis - 1] - m_new).zero_()
