"""Crash-safe snapshots of a live serving engine (``ServeCheckpointer``).
The training ``Checkpointer`` of the reference is not ported yet."""
from repro_torch.checkpoint.checkpointer import ServeCheckpointer

__all__ = ["ServeCheckpointer"]
