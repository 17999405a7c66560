"""Grouped (multi-prefix) bifurcated attention over a rectangular layout.

The paper handles ONE shared context per decode batch; this generalizes
Eq. 3-4 to G prefixes x s samples per prefix:

    q:    (G, s, g, p, n, k)     — s samples per prefix
    K_c:  (G, m_c, g, k)         — ONE copy per prefix (not per sample)
    K_d:  (G, s, m_d, g, k)      — per-sample decode caches

The serve path uses the slot-table form instead
(``core.bifurcated.forest_bifurcated_attention`` and the grouped kernels);
this module is kept as a test oracle of the same function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.masks import mask_to_bias


def grouped_bifurcated_attention(
    q: torch.Tensor,          # (G, s, g, p, n, k)
    k_context: torch.Tensor,  # (G, m_c, g, k)
    v_context: torch.Tensor,
    k_decode: torch.Tensor,   # (G, s, m_d, g, k)
    v_decode: torch.Tensor,
    *,
    context_lengths: Optional[torch.Tensor] = None,  # (G,) live lengths
    decode_mask: Optional[torch.Tensor] = None,      # (G, s, m_d)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention over [prefix_G ⊕ decode_{G,s}] for every sample."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5 if scale is None else scale

    logits_c = torch.einsum("Gsgpnk,GMgk->GsgpnM", q, k_context).float()
    logits_d = torch.einsum("Gsgpnk,Gsmgk->Gsgpnm", q, k_decode).float()
    logits_c = logits_c * scale
    logits_d = logits_d * scale

    m_c = k_context.shape[1]
    if context_lengths is not None:  # ragged prefixes, padded to m_c
        valid = (torch.arange(m_c, device=q.device)[None, :]
                 < context_lengths[:, None])                  # (G, m_c)
        logits_c = logits_c + mask_to_bias(valid)[:, None, None, None, None, :]
    if decode_mask is not None:
        logits_d = logits_d + mask_to_bias(decode_mask)[:, :, None, None, None, :]

    weights = torch.softmax(torch.cat([logits_c, logits_d], dim=-1), dim=-1)
    w_c = weights[..., :m_c].to(v_context.dtype)
    w_d = weights[..., m_c:].to(v_decode.dtype)
    out_c = torch.einsum("GsgpnM,GMgk->Gsgpnk", w_c, v_context)
    out_d = torch.einsum("Gsgpnm,Gsmgk->Gsgpnk", w_d, v_decode)
    return (out_c + out_d).to(q.dtype)
