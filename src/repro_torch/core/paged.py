"""Paged KV storage: block-table caches over a shared page pool.

The dense cache families (core/kv_cache.py, core/quantized.py) store every
context segment / trie node as a fixed-capacity slab: a short prefix costs
its whole capacity in storage. This module pages the context axis instead
(block tables per segment / per trie node), as the reference's
``repro/core/paged.py`` does:

  * ``PagedKVStore`` / ``QuantPagedKVStore`` — the backing store: one
    head-major page POOL ``(L, P, g, page_m, hd)`` (int8 values + f32
    scale pages for the quant store) shared by every segment, a
    per-segment page TABLE ``(N, ppn)`` of pool indices (-1 = unallocated)
    and live lengths ``(N,)``. A segment occupies ``ceil(len / page_m)``
    pages whatever its capacity envelope, and the pool may be SMALLER than
    ``N * ppn`` pages (capacity oversubscription).

  * ``PagedBifurcatedCache`` / ``PagedGroupedBifurcatedCache`` /
    ``PagedPrefixTreeCache`` — paged peers of the dense single-prefix,
    forest and trie families (each covers bf16 AND int8 through its store
    type, selected by ``ctx_quant``). Writes take the page ids to use
    (host-allocated by ``PageAllocator``), and ``free_segment`` /
    ``free_group`` / ``free_node`` retire a segment structurally: its table
    row empties, so the decode kernels never read its pages again.

Unlike the reference's functional updates, the port writes IN PLACE: a
write scatters into the existing pool, tables and lengths, a clear empties
a table row, and no tensor is ever reallocated, so admit / retire /
readmit change data, never a tensor's shape or storage. The decode kernels
read the page tables from device memory (kernels/bifurcated_decode.py,
csrc/paged_decode.cu).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core.errors import (
    AllocatorCorruption,
    PoolExhausted,
    SegmentCapacityExceeded,
)
from repro_torch.core.quantized import quantize_ctx


def pages_needed(n_tokens: int, page_m: int) -> int:
    """ceil(n_tokens / page_m) — pages a segment of ``n_tokens`` occupies."""
    return -(-int(n_tokens) // int(page_m))


def gather_pages(pages: torch.Tensor, page_tables: torch.Tensor,
                 seg_axis: int = 0) -> torch.Tensor:
    """Dense per-segment slabs from a page pool (reference and oracle path
    only — the kernels never do this).

    pages: (..., P, g, pm[, hd]) with the pool axis at ``seg_axis``;
    page_tables: (N, ppn). Returns (..., N, g, ppn*pm[, hd]) with the tokens
    of unallocated pages zeroed — the dense families' zero padding, so the
    dense references run unchanged on the gathered view.
    """
    n_seg, ppn = page_tables.shape
    safe = torch.clamp(page_tables.long(), min=0).reshape(-1)
    x = torch.index_select(pages, seg_axis, safe.to(pages.device))
    pre = x.shape[:seg_axis]
    g, pm = x.shape[seg_axis + 1], x.shape[seg_axis + 2]
    tail = x.shape[seg_axis + 3:]
    x = x.reshape(*pre, n_seg, ppn, g, pm, *tail)
    x = x.transpose(seg_axis + 1, seg_axis + 2)       # (..., N, g, ppn, pm)
    x = x.reshape(*pre, n_seg, g, ppn * pm, *tail)
    tok_valid = (page_tables >= 0).repeat_interleave(pm, dim=1)
    bshape = (1,) * seg_axis + (n_seg, 1, ppn * pm) + (1,) * len(tail)
    return torch.where(tok_valid.reshape(bshape).to(x.device), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _check_write(store, m_new, page_ids):
    n_pg = pages_needed(m_new, store.page_m)
    if m_new > store.segment_capacity:
        raise SegmentCapacityExceeded(
            f"context of {m_new} tokens > segment capacity "
            f"{store.segment_capacity} ({store.pages_per_segment} pages "
            f"of {store.page_m})")
    if len(page_ids) != n_pg:
        raise ValueError(
            f"context of {m_new} tokens needs {n_pg} pages of "
            f"{store.page_m}, got {len(page_ids)} page ids")
    return n_pg


def _to_pages(x, n_pg, pm):
    """(L, g, m_new, ...) head-major values -> (L, n_pg, g, pm, ...) page
    slices, zero-padded past m_new (the last page's tail)."""
    m_new = x.shape[2]
    pad = x.new_zeros(x.shape[:2] + (n_pg * pm - m_new,) + x.shape[3:])
    x = torch.cat([x, pad], dim=2)
    x = x.reshape(x.shape[:2] + (n_pg, pm) + x.shape[3:])
    return x.transpose(1, 2)


def _write_table_row(store, seg_idx, page_ids, m_new):
    row = store.page_tables[seg_idx]
    row.fill_(-1)
    if page_ids:
        row[:len(page_ids)] = torch.as_tensor(
            list(page_ids), dtype=torch.int32).to(row.device)
    store.seg_lens[seg_idx] = m_new


@dataclasses.dataclass
class PagedKVStore:
    """bf16 (or any float) paged context store.

    k_pages/v_pages: (L, P, g, page_m, hd) — the head-major page pool,
    L-stacked over layers like every cache of the port.
    page_tables: (N, ppn) int32 — pool page per (segment, page slot); -1 =
    unallocated. seg_lens: (N,) int32 — live token count per segment.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_tables: torch.Tensor
    seg_lens: torch.Tensor
    page_m: int = 128

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def n_segments(self) -> int:
        return self.page_tables.shape[0]

    @property
    def pages_per_segment(self) -> int:
        return self.page_tables.shape[1]

    @property
    def segment_capacity(self) -> int:
        return self.pages_per_segment * self.page_m

    @staticmethod
    def init(n_layers, n_segments, pages_per_segment, num_pages, n_kv,
             head_dim, page_m=128, dtype=torch.bfloat16, device="cuda"):
        pool = (n_layers, num_pages, n_kv, page_m, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return PagedKVStore(
            k_pages=torch.zeros(pool, dtype=dtype, device=device),
            v_pages=torch.zeros(pool, dtype=dtype, device=device),
            page_tables=torch.full((n_segments, pages_per_segment), -1,
                                   **i32),
            seg_lens=torch.zeros(n_segments, **i32),
            page_m=page_m,
        )

    def write_segment(self, k_ctx, v_ctx, seg_idx: int,
                      page_ids: Sequence[int]):
        """Admit a prefilled (L, m_new, g, hd) sequence-major slice into
        segment ``seg_idx`` on pool pages ``page_ids`` (host-allocated, one
        per ``page_m`` tokens, in any order), in place: the one-time
        transpose and page split happen here, the last page's tail is
        zeroed. Returns ``self``."""
        m_new = k_ctx.shape[1]
        n_pg = _check_write(self, m_new, page_ids)
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.k_pages.device)
        for dst, src in ((self.k_pages, k_ctx), (self.v_pages, v_ctx)):
            pages = _to_pages(src.transpose(1, 2).to(dst.dtype), n_pg,
                              self.page_m)
            dst.index_copy_(1, ids, pages)
        _write_table_row(self, seg_idx, page_ids, m_new)
        return self

    def clear_segment(self, seg_idx: int):
        """Structurally retire a segment, in place: its table row empties
        and its length zeroes, so the kernels never read its pages again.
        The pool keeps the bytes; return the page ids to a
        ``PageAllocator`` separately. Returns ``self``."""
        self.page_tables[seg_idx] = -1
        self.seg_lens[seg_idx] = 0
        return self

    def dense_ctx(self):
        """(k, v): (L, N, g, cap, hd) dense slabs — the dense "gmk" layout,
        for the einsum references and oracles."""
        return (gather_pages(self.k_pages, self.page_tables, seg_axis=1),
                gather_pages(self.v_pages, self.page_tables, seg_axis=1))


@dataclasses.dataclass
class QuantPagedKVStore:
    """Int8 paged context store: int8 value pages + f32 per-(token, head)
    scale pages, quantized once at admission, with the attention logit
    scale pre-folded into ``k_scale_pages`` (values and scales bit-equal to
    the reference's)."""

    k_pages: torch.Tensor        # (L, P, g, pm, hd) int8
    v_pages: torch.Tensor
    k_scale_pages: torch.Tensor  # (L, P, g, pm) f32, logit scale pre-folded
    v_scale_pages: torch.Tensor
    page_tables: torch.Tensor
    seg_lens: torch.Tensor
    page_m: int = 128

    num_pages = PagedKVStore.num_pages
    n_segments = PagedKVStore.n_segments
    pages_per_segment = PagedKVStore.pages_per_segment
    segment_capacity = PagedKVStore.segment_capacity
    clear_segment = PagedKVStore.clear_segment

    @staticmethod
    def init(n_layers, n_segments, pages_per_segment, num_pages, n_kv,
             head_dim, page_m=128, dtype=torch.bfloat16, device="cuda"):
        del dtype  # int8 pool + f32 scales; kept for surface parity
        pool = (n_layers, num_pages, n_kv, page_m, head_dim)
        sc = (n_layers, num_pages, n_kv, page_m)
        i32 = dict(dtype=torch.int32, device=device)
        return QuantPagedKVStore(
            k_pages=torch.zeros(pool, dtype=torch.int8, device=device),
            v_pages=torch.zeros(pool, dtype=torch.int8, device=device),
            k_scale_pages=torch.zeros(sc, dtype=torch.float32, device=device),
            v_scale_pages=torch.zeros(sc, dtype=torch.float32, device=device),
            page_tables=torch.full((n_segments, pages_per_segment), -1,
                                   **i32),
            seg_lens=torch.zeros(n_segments, **i32),
            page_m=page_m,
        )

    def write_segment(self, k_ctx, v_ctx, seg_idx: int,
                      page_ids: Sequence[int]):
        """Admit and quantize (L, m_new, g, hd) into segment ``seg_idx``,
        in place: the live tokens quantize as the dense int8 families do
        (logit scale folded into the k scales); the last page's tail holds
        zero values and zero scales. Returns ``self``."""
        m_new, hd = k_ctx.shape[1], k_ctx.shape[3]
        n_pg = _check_write(self, m_new, page_ids)
        kq, ks = quantize_ctx(k_ctx.transpose(1, 2), fold_scale=hd**-0.5)
        vq, vs = quantize_ctx(v_ctx.transpose(1, 2))
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.k_pages.device)
        for dst, src in ((self.k_pages, kq), (self.v_pages, vq),
                         (self.k_scale_pages, ks), (self.v_scale_pages, vs)):
            dst.index_copy_(1, ids, _to_pages(src, n_pg, self.page_m))
        _write_table_row(self, seg_idx, page_ids, m_new)
        return self

    def dense_ctx(self):
        """(kq, vq, ks, vs): dense int8 slabs (L, N, g, cap, hd) and scale
        slabs (L, N, g, cap) for the dense int8 references."""
        return tuple(gather_pages(x, self.page_tables, seg_axis=1)
                     for x in (self.k_pages, self.v_pages,
                               self.k_scale_pages, self.v_scale_pages))


def paged_store_family(ctx_quant: str = "none"):
    """The paged store class of a context-quantization mode (the paged
    analogue of ``ctx_cache_family``)."""
    if ctx_quant == "int8":
        return QuantPagedKVStore
    if ctx_quant == "none":
        return PagedKVStore
    raise ValueError(f"unknown ctx_quant mode: {ctx_quant!r}")


class PageAllocator:
    """Host-side free-list page allocator (admission state, like the
    engines' slot and node mirrors; the device never sees it). FIFO reuse,
    so a long-running serve loop permutes the pool; refcounts support
    shared pages.

    Every mutator is ATOMIC: its arguments are validated before any state
    changes, so a rejected call (``PoolExhausted``, ``AllocatorCorruption``)
    leaves the free list and refcounts as they were. ``audit()`` re-derives
    the invariants from scratch.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages))
        self._refs = [0] * num_pages

    def free_count(self) -> int:
        return len(self._free)

    def free_pages(self) -> List[int]:
        """A copy of the free list (mutating it cannot corrupt the
        allocator)."""
        return list(self._free)

    def plan_eviction(self, need: int, candidates):
        """Given ``candidates`` — (segment id, pages it would free) pairs in
        the caller's eviction order — the SHORTEST prefix whose release, on
        top of the free list, gives ``need`` allocatable pages: ``[]`` when
        the free list suffices, ``None`` when even all of them cannot.
        Pure planning: nothing is mutated."""
        if need < 0:
            raise ValueError(f"plan_eviction of {need} pages")
        have = len(self._free)
        plan = []
        for seg, n_pages in candidates:
            if have >= need:
                break
            plan.append(seg)
            have += int(n_pages)
        return plan if have >= need else None

    def _check_known(self, i, op: str):
        if not isinstance(i, int) or not 0 <= i < self.num_pages:
            raise AllocatorCorruption(
                f"{op} of unknown page id {i!r} (pool has pages "
                f"0..{self.num_pages - 1})")

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list (refcount 1 each). ATOMIC: on
        exhaustion nothing is taken."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: need {n} pages, have "
                f"{len(self._free)} free of {self.num_pages}")
        ids = self._free[:n]
        del self._free[:n]
        for i in ids:
            self._refs[i] = 1
        return ids

    @staticmethod
    def _as_ids(ids):
        return [int(i) if isinstance(i, int) or hasattr(i, "__index__")
                else i for i in ids]

    def share(self, ids: Sequence[int]):
        """Add one reference per page. Raises ``AllocatorCorruption`` on an
        unknown or FREE page, before mutating anything."""
        ids = self._as_ids(ids)
        for i in ids:
            self._check_known(i, "share")
            if self._refs[i] == 0:
                raise AllocatorCorruption(
                    f"share of free page {i} (refcount 0 — it is on the "
                    f"free list, not held by any segment)")
        for i in ids:
            self._refs[i] += 1

    def release(self, ids: Sequence[int]):
        """Drop one reference per page; a page returns to the free list at
        refcount zero. Returns the pages freed. Raises
        ``AllocatorCorruption`` — before mutating anything — on an unknown
        id or a release that would drop a refcount below zero (counting
        duplicates within the call)."""
        ids = self._as_ids(ids)
        pending = {}
        for i in ids:
            self._check_known(i, "release")
            pending[i] = pending.get(i, 0) + 1
            if pending[i] > self._refs[i]:
                raise AllocatorCorruption(
                    f"double release of page {i} (refcount {self._refs[i]}, "
                    f"released {pending[i]} times in this call"
                    + (" — page is already free" if self._refs[i] == 0
                       else "") + ")")
        freed = []
        for i in ids:
            self._refs[i] -= 1
            if self._refs[i] == 0:
                self._free.append(i)
                freed.append(i)
        return freed

    def state_dict(self) -> dict:
        """JSON-serializable snapshot (the free list's ORDER is part of the
        state: FIFO reuse makes allocation order deterministic)."""
        return {"num_pages": self.num_pages, "free": list(self._free),
                "refs": list(self._refs)}

    def load_state_dict(self, state: dict):
        """Restore from ``state_dict()``, then audit, so a corrupt snapshot
        cannot bring in an inconsistent free list."""
        if int(state["num_pages"]) != self.num_pages:
            raise AllocatorCorruption(
                f"allocator snapshot is for a {state['num_pages']}-page "
                f"pool, this pool has {self.num_pages}")
        self._free = [int(i) for i in state["free"]]
        self._refs = [int(r) for r in state["refs"]]
        self.audit()
        return self

    def audit(self, rows=None, tracked: Optional[Sequence[int]] = None):
        """Re-derive the invariants; raise ``AllocatorCorruption`` on the
        first violation, return ``True`` when all hold.

        Always: free-list ids in range and distinct, refcounts >= 0, a page
        on the free list iff its refcount is zero. With ``rows`` (the live
        segments' page-table rows, -1 ignored): every referenced id in
        range and allocated, and no page referenced by two live segments.
        With ``tracked`` (the flat multiset of ids the host mirrors hold):
        each page's refcount equals its multiplicity there.
        """
        seen = set()
        for i in self._free:
            self._check_known(i, "audit: free-list entry")
            if i in seen:
                raise AllocatorCorruption(
                    f"audit: page {i} appears twice on the free list")
            seen.add(i)
        for i, r in enumerate(self._refs):
            if r < 0:
                raise AllocatorCorruption(
                    f"audit: page {i} has negative refcount {r}")
            if (r == 0) != (i in seen):
                raise AllocatorCorruption(
                    f"audit: page {i} refcount {r} but "
                    + ("on" if i in seen else "NOT on") + " the free list")
        if rows is not None:
            owner = {}
            for s, row in enumerate(rows):
                for pid in row:
                    pid = int(pid)
                    if pid < 0:
                        continue
                    if pid >= self.num_pages:
                        raise AllocatorCorruption(
                            f"audit: live table row {s} references page "
                            f"{pid} outside the pool (size "
                            f"{self.num_pages})")
                    if self._refs[pid] == 0:
                        raise AllocatorCorruption(
                            f"audit: live table row {s} references FREE "
                            f"page {pid}")
                    if pid in owner and owner[pid] != s:
                        raise AllocatorCorruption(
                            f"audit: page {pid} referenced by two live "
                            f"segments ({owner[pid]} and {s})")
                    owner[pid] = s
        if tracked is not None:
            counts = {}
            for pid in tracked:
                pid = int(pid)
                self._check_known(pid, "audit: tracked page")
                counts[pid] = counts.get(pid, 0) + 1
            for i, r in enumerate(self._refs):
                if r != counts.get(i, 0):
                    raise AllocatorCorruption(
                        f"audit: page {i} refcount {r} but host mirrors "
                        f"hold it {counts.get(i, 0)} time(s)")
        return True


# ---------------------------------------------------------------------------
# Paged cache families (the store type carries the bf16 / int8 distinction)
# ---------------------------------------------------------------------------

def _wipe_slots(cache, slot_mask):
    """Zero the decode arms of the slots in ``slot_mask`` (slots,), in
    place."""
    wipe = slot_mask[None, :, None, None, None]
    cache.k_dec.masked_fill_(wipe, 0)
    cache.v_dec.masked_fill_(wipe, 0)


def _store_geometry(n_segments, m_c, page_m, num_pages):
    ppn = pages_needed(m_c, page_m)
    return ppn, (num_pages if num_pages is not None else n_segments * ppn)


@dataclasses.dataclass
class PagedPrefixTreeCache:
    """Paged peer of ``PrefixTreeCache`` / ``QuantPrefixTreeCache``: N trie
    nodes backed by the page pool, a (depth, slots) slot -> node path
    table. Node capacity is a TABLE envelope, not storage: a node occupies
    ``ceil(len / page_m)`` pool pages, a freed node none."""

    store: object               # PagedKVStore | QuantPagedKVStore
    paths: torch.Tensor         # (depth, b) int32, -1 = level unused
    k_dec: torch.Tensor         # (L, b, C_d, g, hd)
    v_dec: torch.Tensor
    dec_lens: torch.Tensor      # (b,) int32

    @property
    def n_nodes(self) -> int:
        return self.store.n_segments

    @property
    def depth(self) -> int:
        return self.paths.shape[0]

    @property
    def node_capacity(self) -> int:
        return self.store.segment_capacity

    @property
    def node_lens(self) -> torch.Tensor:
        return self.store.seg_lens

    @property
    def page_m(self) -> int:
        return self.store.page_m

    @property
    def n_slots(self) -> int:
        return self.k_dec.shape[1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def init(n_layers, n_nodes, depth, slots, m_c, dec_capacity, n_kv,
             head_dim, dtype=torch.bfloat16, page_m=128,
             num_pages: Optional[int] = None, ctx_quant: str = "none",
             device="cuda"):
        """``PrefixTreeCache.init``'s surface plus the paging knobs:
        ``page_m`` (page size, tokens), ``num_pages`` (pool size; default
        the full ``n_nodes * ceil(m_c / page_m)`` envelope — pass less to
        oversubscribe). ``dtype`` is the bf16 pool's and the decode arm's."""
        ppn, num_pages = _store_geometry(n_nodes, m_c, page_m, num_pages)
        store = paged_store_family(ctx_quant).init(
            n_layers, n_nodes, ppn, num_pages, n_kv, head_dim,
            page_m=page_m, dtype=dtype, device=device)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return PagedPrefixTreeCache(
            store=store,
            paths=torch.full((depth, slots), -1, **i32),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, **i32),
        )

    def write_node(self, k_ctx, v_ctx, node_idx: int,
                   page_ids: Sequence[int]):
        """``PrefixTreeCache.write_node`` onto explicit pool pages, in
        place. Returns ``self``."""
        self.store.write_segment(k_ctx, v_ctx, node_idx, page_ids)
        return self

    def free_node(self, node_idx: int):
        """Structurally retire a node (its pages leave the kernels' walk;
        return them to the allocator separately). Returns ``self``."""
        self.store.clear_segment(node_idx)
        return self

    def assign_paths(self, slot_mask: torch.Tensor,
                     path_column: torch.Tensor):
        """``PrefixTreeCache.assign_paths``: point the slots of
        ``slot_mask`` at ``path_column`` and wipe their decode arms, in
        place. Returns ``self``."""
        self.paths.copy_(torch.where(slot_mask[None, :],
                                     path_column.to(self.paths)[:, None],
                                     self.paths))
        self.dec_lens.masked_fill_(slot_mask, 0)
        _wipe_slots(self, slot_mask)
        return self

    # ---- decode-step adapter surface (shared by the paged families) ----
    def slot_paths(self) -> torch.Tensor:
        return self.paths

    def slot_dec_lens(self) -> torch.Tensor:
        return self.dec_lens

    def slot_context_lens(self) -> torch.Tensor:
        """(b,) int32 — total live context per slot (path node lengths
        summed; -1 levels count zero)."""
        safe = torch.clamp(self.paths, 0, self.n_nodes - 1).long()
        per_level = torch.where(self.paths >= 0, self.store.seg_lens[safe],
                                0)
        return per_level.sum(0).to(torch.int32)

    def advance_decode(self, n: int):
        """The decode arms hold ``n`` more tokens: in place. Returns the
        cache."""
        self.dec_lens.add_(n)
        return self


@dataclasses.dataclass
class PagedGroupedBifurcatedCache:
    """Paged peer of ``GroupedBifurcatedCache`` / its int8 twin: G flat
    prefix segments backed by the page pool and a (slots,) -> group slot
    table; the depth-1 case of ``PagedPrefixTreeCache``, kept as its own
    class so the forest engine mirrors the dense family one for one."""

    store: object               # PagedKVStore | QuantPagedKVStore
    group_ids: torch.Tensor     # (b,) int32
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_lens: torch.Tensor

    @property
    def n_groups(self) -> int:
        return self.store.n_segments

    @property
    def context_capacity(self) -> int:
        return self.store.segment_capacity

    @property
    def ctx_lens(self) -> torch.Tensor:
        return self.store.seg_lens

    @property
    def page_m(self) -> int:
        return self.store.page_m

    @property
    def n_slots(self) -> int:
        return self.k_dec.shape[1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def init(n_layers, n_groups, slots, m_c, dec_capacity, n_kv, head_dim,
             dtype=torch.bfloat16, page_m=128,
             num_pages: Optional[int] = None, ctx_quant: str = "none",
             device="cuda"):
        """``GroupedBifurcatedCache.init``'s surface plus the paging knobs
        (see ``PagedPrefixTreeCache.init``)."""
        ppn, num_pages = _store_geometry(n_groups, m_c, page_m, num_pages)
        store = paged_store_family(ctx_quant).init(
            n_layers, n_groups, ppn, num_pages, n_kv, head_dim,
            page_m=page_m, dtype=dtype, device=device)
        dec = (n_layers, slots, dec_capacity, n_kv, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return PagedGroupedBifurcatedCache(
            store=store,
            group_ids=torch.zeros(slots, **i32),
            k_dec=torch.zeros(dec, dtype=dtype, device=device),
            v_dec=torch.zeros(dec, dtype=dtype, device=device),
            dec_lens=torch.zeros(slots, **i32),
        )

    def write_context(self, k_ctx, v_ctx, group_idx: int,
                      page_ids: Sequence[int]):
        """``GroupedBifurcatedCache.write_context`` onto explicit pool
        pages, in place. Returns ``self``."""
        self.store.write_segment(k_ctx, v_ctx, group_idx, page_ids)
        return self

    def free_group(self, group_idx: int):
        self.store.clear_segment(group_idx)
        return self

    def assign_slots(self, slot_mask: torch.Tensor, group_idx: int):
        """``GroupedBifurcatedCache.assign_slots``, in place. Returns
        ``self``."""
        self.group_ids.masked_fill_(slot_mask, group_idx)
        self.dec_lens.masked_fill_(slot_mask, 0)
        _wipe_slots(self, slot_mask)
        return self

    # ---- decode-step adapter surface ----
    def slot_paths(self) -> torch.Tensor:
        return self.group_ids[None, :]                # depth 1

    def slot_dec_lens(self) -> torch.Tensor:
        return self.dec_lens

    def slot_context_lens(self) -> torch.Tensor:
        return self.store.seg_lens[self.group_ids.long()].to(torch.int32)

    def advance_decode(self, n: int):
        self.dec_lens.add_(n)
        return self


@dataclasses.dataclass
class PagedBifurcatedCache:
    """Paged peer of ``BifurcatedCache`` / ``QuantBifurcatedCache``: ONE
    shared context in a single-segment store (pages allocated in order at
    prefill) and the per-sample decode arm, whose length ``dec_length`` is
    a host int as on ``BifurcatedCache``."""

    store: object               # PagedKVStore | QuantPagedKVStore
    k_dec: torch.Tensor         # (L, b, C_d, g, hd)
    v_dec: torch.Tensor
    dec_length: int

    @property
    def context_len(self) -> torch.Tensor:
        """LIVE context length: device data under paging."""
        return self.store.seg_lens[0]

    @property
    def page_m(self) -> int:
        return self.store.page_m

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def from_prefill(k_ctx, v_ctx, batch, dec_capacity, dtype=torch.bfloat16,
                     page_m=128, ctx_quant: str = "none"):
        """From a single-context prefill (L, m_c, g, hd), on its device:
        the pool holds exactly ``ceil(m_c / page_m)`` pages (ids 0..n-1)."""
        n_layers, m_c, g, head_dim = k_ctx.shape
        n_pg = pages_needed(m_c, page_m)
        dev = k_ctx.device
        store = paged_store_family(ctx_quant).init(
            n_layers, 1, n_pg, n_pg, g, head_dim, page_m=page_m,
            dtype=dtype, device=dev)
        store.write_segment(k_ctx, v_ctx, 0, list(range(n_pg)))
        dec = (n_layers, batch, dec_capacity, g, head_dim)
        return PagedBifurcatedCache(
            store=store,
            k_dec=torch.zeros(dec, dtype=dtype, device=dev),
            v_dec=torch.zeros(dec, dtype=dtype, device=dev),
            dec_length=0,
        )

    # ---- decode-step adapter surface ----
    def slot_paths(self) -> torch.Tensor:
        b = self.k_dec.shape[1]
        return torch.zeros((1, b), dtype=torch.int32,
                           device=self.k_dec.device)   # every slot on 0

    def slot_dec_lens(self) -> torch.Tensor:
        b = self.k_dec.shape[1]
        return torch.full((b,), self.dec_length, dtype=torch.int32,
                          device=self.k_dec.device)

    def slot_context_lens(self) -> torch.Tensor:
        b = self.k_dec.shape[1]
        return self.store.seg_lens[:1].expand(b)

    def advance_decode(self, n: int):
        return dataclasses.replace(self, dec_length=self.dec_length + n)


PAGED_CACHE_FAMILIES = (PagedBifurcatedCache, PagedGroupedBifurcatedCache,
                        PagedPrefixTreeCache)
