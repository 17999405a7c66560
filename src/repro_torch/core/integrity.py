"""KV-cache integrity checksums (write-time fingerprints, load-time audit).

A CRC32 over exactly the LIVE bytes of one cache segment (a forest group's
context or a trie node), so that corruption of a snapshot, a copy or a host
bookkeeping bug is detected instead of decoded into garbage tokens:

  * paged stores (``PagedKVStore`` / ``QuantPagedKVStore``): walk the
    segment's page-table row in order and take the live tokens of each page
    from the k/v pools (and the int8 scale pools when present);
  * dense caches (grouped / tree, bf16 / int8): slice the live token prefix
    of ``k_ctx``/``v_ctx`` (+ ``k_scale``/``v_scale``) along the layout's
    token axis.

The bytes and their order are the reference's (``repro/core/integrity.py``):
bf16 is its 2-byte little-endian pattern, int8 values and fp32 scales their
own bytes, so a checksum equals the reference's whenever the bytes are
equal. The slices are packed into one byte tensor on the cache's device
and pulled to the host once per segment.

The serve engines record ``segment_checksum`` when a segment or node is
written and re-verify on demand (``audit_state(verify_checksums=True)``)
and at snapshot load (``runtime/recovery``). A mismatch raises
``core.errors.KVCorruption``. Only context bytes are fingerprinted: the
decode arms change every step, and corruption there is caught by the
decode output's non-finite sentinel in ``runtime/serve``.
"""
from __future__ import annotations

import zlib

import torch

from repro_torch.core.errors import KVCorruption


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's contiguous little-endian bytes as a flat uint8 tensor, on
    its own device."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def array_crc(*tensors) -> int:
    """CRC32 over the raw bytes of ``tensors``, in order (the reference's
    ``array_crc`` on the same values). The bytes are packed on the device
    and copied to the host in one transfer."""
    if not tensors:
        return 0
    buf = torch.cat([_as_bytes(t) for t in tensors])
    return zlib.crc32(buf.cpu().numpy().tobytes())


def _paged_segment_tensors(store, idx: int):
    """Live-token slices of every pool tensor for segment ``idx``: per page
    of its table row, (L, g, take[, hd]) of k, v and the scale pools."""
    row = store.page_tables[idx].tolist()
    m = int(store.seg_lens[idx])
    out, got = [], 0
    for pid in row:
        if pid < 0 or got >= m:
            break
        take = min(store.page_m, m - got)
        for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
            pool = getattr(store, name, None)
            if pool is not None:
                # (L, P, g, pm[, hd]) -> this page's (L, g, take[, hd])
                out.append(pool[:, pid, :, :take])
        got += take
    return out


def _dense_segment_tensors(cache, idx: int):
    """Live-token slices of the dense context tensors for segment ``idx``."""
    lens = getattr(cache, "node_lens", None)
    if lens is None:
        lens = cache.ctx_lens
    m = int(lens[idx])
    tok_axis = 2 if getattr(cache, "ctx_layout", "gmk") == "gmk" else 1
    out = []
    for name in ("k_ctx", "v_ctx", "k_scale", "v_scale"):
        t = getattr(cache, name, None)
        if t is not None:
            # per segment: gmk (L, g, m_c[, hd]) token axis 2; mgk axis 1
            out.append(t[:, idx].narrow(tok_axis, 0, m))
    return out


def segment_checksum(cache, idx: int) -> int:
    """CRC32 fingerprint of segment ``idx``'s live context bytes.

    ``cache`` is a serve-facing cache: a paged family exposes ``.store``
    (pool + page tables), a dense family ``k_ctx`` etc.; a bare paged store
    is accepted too. Changes for any single-bit flip inside the live region;
    insensitive to dead capacity and free pages."""
    store = getattr(cache, "store", None)
    if store is None and hasattr(cache, "page_tables"):
        store = cache
    if store is not None:
        tensors = _paged_segment_tensors(store, idx)
    else:
        tensors = _dense_segment_tensors(cache, idx)
    return array_crc(*tensors)


def verify_segment(cache, idx: int, expected: int, *, what: str = "segment"):
    """Recompute one segment's checksum and compare. Raises
    ``KVCorruption`` on a mismatch; returns the checksum on success."""
    got = segment_checksum(cache, idx)
    if got != expected:
        raise KVCorruption(
            f"{what} {idx} checksum mismatch: "
            f"expected {expected:#010x}, got {got:#010x} — "
            f"live KV bytes changed since write")
    return got


__all__ = ["array_crc", "segment_checksum", "verify_segment"]
