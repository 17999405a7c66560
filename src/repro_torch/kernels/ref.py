"""Plain einsum oracles for the decode kernels (no kernel imports here)."""
from __future__ import annotations

import torch


def bifurcated_decode_ref(
    q: torch.Tensor,          # (b, g, p, hd)  — one decode token per sample
    k_ctx: torch.Tensor,      # (g, m_c, hd)   — shared context, kernel layout
    v_ctx: torch.Tensor,      # (g, m_c, hd)
    k_dec: torch.Tensor,      # (b, g, c_d, hd)
    v_dec: torch.Tensor,      # (b, g, c_d, hd)
    dec_mask: torch.Tensor,   # (b, c_d) bool
    scale: float,
) -> torch.Tensor:
    """Monolithic softmax over [K_ctx ⊕ K_dec] — ground truth."""
    lc = torch.einsum("bgpk,gmk->bgpm", q, k_ctx).float() * scale
    ld = torch.einsum("bgpk,bgmk->bgpm", q, k_dec).float() * scale
    ld = torch.where(dec_mask[:, None, None, :], ld,
                     torch.full((), -1e30, device=ld.device))
    w = torch.softmax(torch.cat([lc, ld], dim=-1), dim=-1)
    m_c = k_ctx.shape[1]
    oc = torch.einsum("bgpm,gmv->bgpv", w[..., :m_c].to(v_ctx.dtype), v_ctx)
    od = torch.einsum("bgpm,bgmv->bgpv", w[..., m_c:].to(v_dec.dtype), v_dec)
    return (oc + od).to(q.dtype)


def context_partial_ref(q, k_ctx, v_ctx, scale):
    """Unnormalized flash partials of the context arm: (acc, m, l)."""
    s = torch.einsum("bgpk,gmk->bgpm", q, k_ctx).float() * scale
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    l = torch.sum(e, dim=-1)
    acc = torch.einsum("bgpm,gmv->bgpv", e.to(v_ctx.dtype), v_ctx).float()
    return acc, m, l
