"""PyTorch/CUDA port of the bifurcated-attention serving system.

A package of its own beside the JAX reference (``src/repro``), whose layout
it mirrors module for module. It imports torch and numpy, never jax and
nothing of ``repro``. Entry points run on CUDA unless the caller asks for
the CPU; on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (never drops to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev
