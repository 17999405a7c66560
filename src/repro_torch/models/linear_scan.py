"""Chunked scalar-decay linear attention — the SSM-family compute substrate.

One algorithm serves both xLSTM's mLSTM (matrix memory, scalar exp/sig gates)
and Mamba2's SSD (scalar-per-head decay): the recurrence

    S_t = exp(a_t) * S_{t-1} + k_t v_t^T          (S: (dk, dv) per head)
    h_t = q_t @ S_t                                (optionally normalized)

is evaluated chunkwise: O(n * c) intra-chunk attention-like products plus
an O(n / c) walk over chunk summaries. ``chunked_linear_attention`` runs it
on CUDA tensors through kernel #13 (``kernels/chunked_linear.py``, one
launch) and on CPU tensors through that kernel's plain version; decode is
the one-token recurrence ``linear_attention_decode``.

All decays are log-space (``a <= 0``), so every exponential in the chunked
path is <= 1: no overflow, bf16-safe with fp32 accumulation.
"""
from __future__ import annotations

from typing import Tuple

import torch

# kernel #13's wrapper is this module's chunked_linear_attention(q, k, v,
# log_decay, *, chunk=256, normalize=False, initial_state=None): CUDA
# tensors go to the kernel, CPU tensors to its plain version
from repro_torch.kernels.chunked_linear import (  # noqa: F401
    chunked_linear_attention,
)


def linear_attention_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_decay: torch.Tensor,
    state: torch.Tensor,
    *,
    normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update. q/k: (b,H,dk), v: (b,H,dv), a: (b,H),
    state: (b,H,dk,dv[+1]) fp32, UPDATED IN PLACE (the serve caches hold
    one state per layer and sample: no copy per step). Returns (out
    (b,H,dv) in v's dtype, state)."""
    qf, kf = q.float(), k.float()
    vf = v.float()
    if normalize:
        vf = torch.cat([vf, torch.ones(*vf.shape[:-1], 1, device=vf.device)],
                       dim=-1)
    dec = torch.exp(torch.clamp(log_decay.float(), max=0.0))
    state.mul_(dec[..., None, None]).addcmul_(kf[..., :, None],
                                              vf[..., None, :])
    out = torch.einsum("bhk,bhkv->bhv", qf, state)
    if normalize:
        dv = v.shape[-1]
        num, den = out[..., :dv], out[..., dv]
        out = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return out.to(v.dtype), state


def reference_linear_attention(q, k, v, log_decay, *, normalize=False):
    """O(n^2)-free sequential oracle for tests: plain per-step recurrence."""
    b, n, H, dk = q.shape
    dv = v.shape[-1]
    state = torch.zeros(b, H, dk, dv + (1 if normalize else 0),
                        dtype=torch.float32, device=q.device)
    outs = []
    for t in range(n):
        o, state = linear_attention_decode(
            q[:, t], k[:, t], v[:, t], log_decay[:, t], state,
            normalize=normalize)
        outs.append(o)
    return torch.stack(outs, dim=1), state
