"""Rotary position embeddings (RoPE), applied on the fly from positions.

Implemented in the "half-rotation" (GPT-NeoX / Llama) convention: the head
dimension splits into two halves that rotate against each other, not into
interleaved pairs. Angles are computed in float32.
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` by position-dependent angles.

    Args:
      x: (..., n, heads, head_dim) query or key tensor.
      positions: (n,) or broadcastable to (..., n) absolute token positions.
      theta: RoPE base (e.g. 10_000 or 1_000_000).

    Returns:
      Tensor of the same shape/dtype as ``x``.
    """
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, device=x.device)  # (k/2,)
    pos = positions.to(torch.float32)
    angles = pos[..., None] * inv_freq            # (..., n, k/2)
    cos = torch.cos(angles)[..., None, :]          # (..., n, 1, k/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
