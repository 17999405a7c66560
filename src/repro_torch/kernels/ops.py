"""Dispatch from the framework's decode layouts to the decode kernels.

``bifurcated_decode_attention`` is the deployable path. By default it runs
the SINGLE-pass fused kernel (``kernels.bifurcated_decode.
fused_bifurcated_decode``): one launch streams the K_c/V_c blocks, folds the
per-sample decode arm into the same fp32 running ``(max, sumexp, acc)``
state with the slot mask applied in-kernel, and writes the normalised
output — no fp32 partials and no logits reach device memory.

``two_pass=True`` is the escape hatch to the historical pipeline: the
context arm runs the partials kernel (fp32 ``acc/m/l`` in device memory),
the small decode arm stays on einsums, and the two halves merge with the
exact two-way online-softmax combine.

Both paths accept the framework's cache layouts ("mgk" ``(m_c, g, hd)`` or
head-major "gmk" ``(g, m_c, hd)`` — zero-copy for the kernel) and any
number ``n >= 1`` of fresh query positions per sample: ``n`` is folded into
the kernel's row dimension (``rows = b*p*n``) under a shared ``(b, C_d)``
decode mask, so attention WITHIN the fresh draft block is bidirectional,
as in the reference. On CPU tensors the kernels' plain versions run.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bifurcated_decode import (
    context_flash_partials,
    fused_bifurcated_decode,
)

NEG_INF = -1e30


def bifurcated_decode_attention(
    q: torch.Tensor,         # (b, g, p, n, hd) — framework decode layout
    k_ctx: torch.Tensor,     # (m_c, g, hd) "mgk" or (g, m_c, hd) "gmk"
    v_ctx: torch.Tensor,
    k_dec: torch.Tensor,     # (b, c_d, g, hd)
    v_dec: torch.Tensor,
    dec_mask: torch.Tensor,  # (b, c_d) bool
    *,
    scale: Optional[float] = None,
    ctx_layout: str = "mgk",
    two_pass: bool = False,
) -> torch.Tensor:
    """Single-prefix bifurcated decode dispatcher (the deployable path).

    Shapes/dtypes (framework layouts; fp32 or bf16, bf16 in serving):
      q:        (b, g, p, n, hd) — b samples, g kv heads, p query heads
                per kv head, n fresh positions (speculative drafts).
      k_ctx/v_ctx: shared context, NO batch axis — (m_c, g, hd) under
                ``ctx_layout="mgk"`` (sequence-major) or (g, m_c, hd)
                under "gmk" (head-major; zero-copy for the kernel).
      k_dec/v_dec: (b, c_d, g, hd) per-sample decode continuation.
      dec_mask: (b, c_d) bool — live decode slots.
    Returns (b, g, p, n, hd) in q's dtype, softmax-normalised over
    [context ⊕ live decode slots]."""
    b, g, p, n, hd = q.shape
    c_d = k_dec.shape[1]
    scale = hd**-0.5 if scale is None else scale

    # kernel-major query rows: r = (b_idx*p + p_idx)*n + n_idx
    qk = q.permute(1, 0, 2, 3, 4).reshape(g, b * p * n, hd).contiguous()
    if ctx_layout == "gmk":  # already kernel-major: zero-copy
        kc, vc = k_ctx.contiguous(), v_ctx.contiguous()
    else:
        kc = k_ctx.transpose(0, 1).contiguous()  # (g, m_c, hd)
        vc = v_ctx.transpose(0, 1).contiguous()

    if not two_pass:
        # ---- single-pass fused kernel: decode arm + merge in-kernel ----
        kd = k_dec.permute(2, 0, 1, 3).reshape(g, b * c_d, hd).contiguous()
        vd = v_dec.permute(2, 0, 1, 3).reshape(g, b * c_d, hd).contiguous()
        bias = torch.where(dec_mask.reshape(1, b * c_d), 0.0, NEG_INF
                           ).to(torch.float32)
        out = fused_bifurcated_decode(
            qk, kc, vc, kd, vd, bias, scale=scale, c_d=c_d, pn=p * n)
        out = out.reshape(g, b, p, n, hd).permute(1, 0, 2, 3, 4)
        return out.to(q.dtype)

    # ---- two-pass escape hatch: partials kernel + einsum arm + merge ----
    acc_c, m_cx, l_c = context_flash_partials(qk, kc, vc, scale=scale)

    # decode arm: einsum partials (c_d is small)
    s_d = torch.einsum("bgpnk,bmgk->bgpnm", q, k_dec).float() * scale
    s_d = torch.where(dec_mask[:, None, None, None, :], s_d,
                      torch.full((), NEG_INF, device=q.device))
    m_d = torch.clamp(torch.amax(s_d, dim=-1), min=NEG_INF / 2)
    e_d = torch.exp(s_d - m_d[..., None])
    l_d = torch.sum(e_d, dim=-1)
    acc_d = torch.einsum("bgpnm,bmgv->bgpnv", e_d.to(v_dec.dtype), v_dec).float()

    # exact two-way merge
    acc_cb = acc_c.reshape(g, b, p, n, hd).permute(1, 0, 2, 3, 4)
    m_cb = m_cx.reshape(g, b, p, n).permute(1, 0, 2, 3)
    l_cb = l_c.reshape(g, b, p, n).permute(1, 0, 2, 3)
    m_star = torch.maximum(m_cb, m_d)
    corr_c = torch.exp(m_cb - m_star)
    corr_d = torch.exp(m_d - m_star)
    l_tot = l_cb * corr_c + l_d * corr_d
    out = (acc_cb * corr_c[..., None] + acc_d * corr_d[..., None]) / l_tot[..., None]
    return out.to(q.dtype)  # (b, g, p, n, hd)
