"""Typed capacity errors raised by the serve engine.

The port's copy of the part of the reference's taxonomy
(``repro/core/errors.py``) that ``runtime/serve.ServeEngine`` raises: every
failure has a type and a machine-readable ``reason``, and keeps its
historical base class so ``except ValueError`` sites still catch it.
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


class DecodeCapacityExceeded(CapacityError, ValueError, RuntimeError):
    """Permanent: a generation would overrun the per-slot decode-arm
    capacity (the KV write would run past the arm). Subclasses both
    historical bases, ``ValueError`` and ``RuntimeError``."""

    reason = "decode_capacity_exceeded"
    retryable = False


__all__ = ["CapacityError", "DecodeCapacityExceeded"]
