"""Typed capacity errors raised by the serve engines.

The port's copy of the part of the reference's taxonomy
(``repro/core/errors.py``) that ``runtime/serve.ServeEngine`` and
``ForestServeEngine`` raise: every failure has a type and a
machine-readable ``reason``, and keeps its historical base class so
``except ValueError`` / ``except RuntimeError`` sites still catch it.
``retryable`` tells a caller whether waiting for retirements can help
(pool, segment and slot exhaustion) or not (an envelope overflow).
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


__all__ = [
    "CapacityError",
    "PoolExhausted",
    "SegmentsExhausted",
    "SlotsExhausted",
    "SegmentCapacityExceeded",
    "DecodeCapacityExceeded",
]
