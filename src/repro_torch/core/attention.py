"""Generalized multi-group attention (paper §3.3).

One implementation covers multi-head (g == h), grouped-query (1 < g < h) and
multi-query (g == 1) attention. Tensors follow the paper's einsum notation:

  b: batch, g: kv groups, p: query heads per group (h = g * p),
  n: query length, m: key/value length, k: head dim, v: value head dim (= k).

Layouts used throughout the framework:
  q            : (b, g, p, n, k)
  K, V (batched): (b, m, g, k)
  K_c, V_c      : (m_c, g, k)     -- unbatched shared-context cache

Every product runs in the operands' dtype and is then cast to float32 for
the softmax, as the reference's einsums do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.masks import mask_to_bias


def multigroup_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Standard (non-bifurcated) multi-group attention.

    Args:
      q: (b, g, p, n, k)
      k: (b, m, g, k)
      v: (b, m, g, k)
      mask: boolean, broadcastable to (b, g, p, n, m). True = attend.
      scale: logit scale; defaults to k**-0.5.

    Returns:
      (b, g, p, n, k) attention output, in q.dtype.
    """
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale
    logits = torch.einsum("bgpnk,bmgk->bgpnm", q, k).float() * scale
    if mask is not None:
        logits = logits + mask_to_bias(mask)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgpnm,bmgv->bgpnv", weights.to(v.dtype), v)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    valid_mask: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Incremental-decoding attention against a *batched* cache.

    This is the paper's "without bifurcated attention" baseline: the batch
    axis is present on the cache, so HBM reads scale as b * m.

    Args:
      q: (b, g, p, n, k) with small n (1, or n_g for speculative decoding).
      k_cache, v_cache: (b, C, g, k) linear caches, C = capacity.
      valid_mask: (b, C) bool — which cache slots hold live tokens.
    """
    mask = valid_mask[:, None, None, None, :]  # (b, 1, 1, 1, C)
    return multigroup_attention(q, k_cache, v_cache, mask=mask, scale=scale)
