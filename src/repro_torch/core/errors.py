"""Typed capacity errors raised by the serve engines.

The port's copy of the part of the reference's taxonomy
(``repro/core/errors.py``) that the serve engines of ``runtime/serve``
raise: every failure has a type and a
machine-readable ``reason``, and keeps its historical base class so
``except ValueError`` / ``except RuntimeError`` sites still catch it.
``retryable`` tells a caller whether waiting for retirements can help
(pool, segment and slot exhaustion) or not (an envelope overflow).
``KVCorruption`` (raised by ``core/integrity`` and the serve engines'
checksum audit) and ``AllocatorCorruption`` (raised by
``core/paged.PageAllocator``) are the two invariant errors.
"""
from __future__ import annotations


class CapacityError(Exception):
    """Base for all capacity-shaped serving failures.

    ``reason`` is a short machine-readable slug; ``retryable`` says whether
    the condition can clear without changing the request (resources freed
    by retirement) or is permanent for this request/engine envelope.
    """

    reason: str = "capacity"
    retryable: bool = False


class PoolExhausted(CapacityError, RuntimeError):
    """Transient: a resource pool has too few free units right now;
    retirement frees them. Historically a bare ``RuntimeError``."""

    reason = "pool_exhausted"
    retryable = True


class SegmentsExhausted(PoolExhausted):
    """Transient: no free context segment to admit into (the segment
    table itself is the exhausted pool)."""

    reason = "segments_exhausted"


class SlotsExhausted(CapacityError, RuntimeError):
    """Transient: fewer free decode slots than the request's
    ``n_samples``. Historically a bare ``RuntimeError``."""

    reason = "slots_exhausted"
    retryable = True


class PrefillInFlight(CapacityError, RuntimeError):
    """Transient: the request's prefix path collides with a trie node
    whose KV is still being prefilled by a pending packed admission
    (``step_mode="packed"``): the node can be neither reused (its KV is not
    written yet) nor duplicated (same (parent, tokens) identity). Clears
    when the pending prefill's chunks land and the node goes live."""

    reason = "prefill_in_flight"
    retryable = True


class SegmentCapacityExceeded(CapacityError, ValueError):
    """Permanent: a context is longer than the engine's segment capacity;
    no amount of retirement makes it fit. Historically a bare
    ``ValueError``."""

    reason = "segment_capacity_exceeded"
    retryable = False


class DecodeCapacityExceeded(CapacityError, ValueError, RuntimeError):
    """Permanent: a generation would overrun the per-slot decode-arm
    capacity (the KV write would run past the arm). Subclasses both
    historical bases: ``ServeEngine.generate`` raised ``ValueError``,
    ``_SlotTableEngine.step_chunk`` raised ``RuntimeError``."""

    reason = "decode_capacity_exceeded"
    retryable = False


class KVCorruption(RuntimeError):
    """KV-cache INTEGRITY was violated: a live segment's bytes no longer
    match the checksum recorded when they were written (bit-flipped
    snapshot, bad copy, host bug), or a snapshot's leaf or host blob failed
    its CRC. Raised by ``core/integrity`` verification (snapshot load,
    ``audit_state(verify_checksums=True)``) and by
    ``checkpoint.ServeCheckpointer.load``. Never retryable for the affected
    segment: the owning request is quarantined through the ordinary
    cancel/retire path."""

    reason = "kv_corruption"
    retryable = False


class AllocatorCorruption(RuntimeError):
    """An allocator/bookkeeping INVARIANT was violated: double release,
    release/share of an unknown or free page, refcount drift, aliased page
    tables, free-list damage. Raised by ``PageAllocator``'s mutators (which
    reject the operation atomically, before any state change) and by
    ``PageAllocator.audit()``. Never retryable: it means a bug."""

    reason = "allocator_corruption"


__all__ = [
    "CapacityError",
    "PoolExhausted",
    "SegmentsExhausted",
    "SlotsExhausted",
    "PrefillInFlight",
    "SegmentCapacityExceeded",
    "DecodeCapacityExceeded",
    "KVCorruption",
    "AllocatorCorruption",
]
