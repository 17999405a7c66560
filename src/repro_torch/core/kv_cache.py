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

Unlike the reference's functional updates, the port writes new decode KVs
IN PLACE into the existing arm tensors (``update_layer_cache``); a decode
step returns a cache object that shares those tensors with its input and
carries the advanced length. The single-prefix caches keep their lengths
as host-side Python ints: the step loop runs on the host and slices with
them. The forest cache keeps every length on the device and updates its
tensors in place at admission too, so admit and retire change data, never
a tensor's shape or storage.
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
