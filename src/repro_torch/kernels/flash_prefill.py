"""Flash prefill attention: the CUDA kernel and its plain version.

``flash_prefill_attention`` — causal or sliding-window GQA attention over
  a whole sequence (the prefill and the suffix prefill of
  ``models/blocks.flash_chunked_attention``): q (b, n, h, hd) against k, v
  (b, m, g, hd), h = g * p, fp32 online softmax, no (n, m) logits in
  device memory. Query row i sits at position ``q_offset`` + i (keys at
  0..m-1), so a suffix of n tokens attends its cached prefix and its own
  causal past. Written in CUDA C++ for Hopper (``csrc/flash_prefill.cu``,
  built by ``_build.py``: TMA-fed K/V, wgmma, a producer warp and two
  consumer warpgroups; its bound and design are written at the top of the
  source). Replaces ``repro/kernels/flash_prefill.py:
  flash_prefill_attention`` (Pallas, ``_flash_kernel``), which has no
  ``q_offset``.

``causal=False`` with a window raises ``ValueError``: the Pallas kernel
masks one side there (``k_pos > q_pos - window``) and the reference's
``flash_chunked_attention`` both (``|k_pos - q_pos| < window``), and
nothing in either package calls it. The wrapper takes CPU tensors to the
plain version and CUDA tensors to the kernel, which takes bf16 only (fp32
raises ``TypeError`` there); it never falls back. When the (batch, kv
head, 128-row tile) items cannot fill the card's SMs (a short suffix, a
single query), the wrapper splits each tile's keys (``split_count``): the
kernel writes fp32 partials to scratch the wrapper allocates, and a
second kernel merges them. ``flash_prefill_attention.launches`` counts
the calls that launch on the card, one per call whether the keys are
split or not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bifurcated_decode import (
    _check_contiguous,
    _check_kernel_operands,
    _launch,
    _on_cuda,
    _sm_count,
)

NEG_INF = -1e30
FLASH_HEAD_DIMS = (16, 64, 80, 112, 128)    # the kernel's instances
TILE_ROWS = 128     # the kernel's query rows per CTA: 128 // p positions
KEY_BLOCK = 128     # and keys per K/V tile
BLOCK_Q = 512       # the plain version's default query and key blocks
BLOCK_K = 512       # (the Pallas kernel's defaults)


def _check(q, k, v, causal, window, q_offset):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (b, n, h, hd), k = v (b, m, g, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, n, h, hd = q.shape
    m, g = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != hd or min(n, m, g) < 1
            or h % g):
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (h a multiple of g)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must have the query's dtype")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         f">= 0")
    if window and not causal:
        raise ValueError("a window needs causal=True: the non-causal "
                         "windowed mask differs across the reference's "
                         "kernel and its flash_chunked_attention")


def flash_prefill_attention_plain(q, k, v, *, causal=True, window=0,
                                  q_offset=0, block_q=BLOCK_Q,
                                  block_k=BLOCK_K):
    """Plain PyTorch version of ``flash_prefill_attention``: query blocks of
    ``block_q`` rows walk key blocks of ``block_k`` (aligned to multiples
    of ``block_k``, from the block holding the first row's window edge to
    the last row's causal limit) with the kernel's fp32 running state."""
    _check(q, k, v, causal, window, q_offset)
    b, n, h, hd = q.shape
    m, g = k.shape[1], k.shape[2]
    p = h // g
    scale = hd**-0.5
    dev = q.device
    out = torch.empty_like(q)
    for qs in range(0, n, block_q):
        qe = min(qs + block_q, n)
        c = qe - qs
        qc = q[:, qs:qe].reshape(b, c, g, p, hd).permute(0, 2, 3, 1, 4).float()
        q_pos = q_offset + torch.arange(qs, qe, device=dev)[:, None]
        # keys [lo, hi) that positions q_pos[0]..q_pos[-1] may see
        hi = min(m, q_offset + qe) if causal else m
        lo = max(0, q_offset + qs - window + 1) if window else 0
        acc = torch.zeros(b, g, p, c, hd, dtype=torch.float32, device=dev)
        mx = torch.full((b, g, p, c, 1), NEG_INF, dtype=torch.float32,
                        device=dev)
        l = torch.zeros(b, g, p, c, 1, dtype=torch.float32, device=dev)
        for ks in range(lo - lo % block_k, hi, block_k):
            ke = min(ks + block_k, m)
            s = torch.einsum("bgpcd,bkgd->bgpck", qc,
                             k[:, ks:ke].float()) * scale
            if causal:      # (a window comes only with causal: _check)
                k_pos = torch.arange(ks, ke, device=dev)[None, :]
                mask = k_pos <= q_pos
                if window:
                    mask = mask & (k_pos > q_pos - window)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(mx, s.amax(-1, keepdim=True))
            corr = torch.exp(mx - m_new)
            e = torch.exp(s - m_new)
            l = l * corr + e.sum(-1, keepdim=True)
            pv = torch.einsum("bgpck,bkgd->bgpcd", e.to(v.dtype).float(),
                              v[:, ks:ke].float())
            acc = acc * corr + pv
            mx = m_new
        o = acc / torch.clamp(l, min=1e-30)
        out[:, qs:qe] = o.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd).to(q.dtype)
    return out


def split_count(b, n, m, g, p, *, causal, window, q_offset, sms):
    """Key splits per tile: 1 when the kernel's b * g * tiles items fill
    the ``sms`` SMs (one CTA each), else as many as fill them, at most one
    per key block of the longest (last) tile."""
    tile_pos = TILE_ROWS // p
    tiles = -(-n // tile_pos)
    ctas = b * g * tiles
    if ctas >= sms:
        return 1
    pos0 = (tiles - 1) * tile_pos
    end = min(m, q_offset + n) if causal else m
    blk0 = max(0, q_offset + pos0 - window + 1) // KEY_BLOCK if window else 0
    return max(1, min(sms // ctas, -(-end // KEY_BLOCK) - blk0))


def flash_prefill_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Flash attention of q (b, n, h, hd) over k, v (b, m, g, hd), query row
    i at position ``q_offset`` + i; returns (b, n, h, hd) in q's dtype.
    ``window`` 0: none."""
    _check(q, k, v, causal, window, q_offset)
    _check_contiguous(q, k, v)
    if not _on_cuda(q, k, v):
        return flash_prefill_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
    _check_kernel_operands(q, k, v)
    b, n, h, hd = q.shape
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash prefill kernel takes head_dim in "
                         f"{FLASH_HEAD_DIMS}, not {hd}")
    m, g = k.shape[1], k.shape[2]
    p = h // g
    if p > TILE_ROWS:
        raise ValueError(f"the flash prefill kernel takes at most {TILE_ROWS} "
                         f"query heads per kv head, not {p}")
    splits = split_count(b, n, m, g, p, causal=causal, window=window,
                         q_offset=q_offset, sms=_sm_count(q.device.index))
    part = None
    if splits > 1:      # fp32 (acc, max, sum) of every split's tile rows
        tiles = -(-n // (TILE_ROWS // p))
        part = torch.empty(splits * b * g * tiles * TILE_ROWS * (hd + 2),
                           dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _launch("flash_prefill_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, n, m, h, g, hd,
            int(q_offset), int(window), int(bool(causal)), splits,
            float(hd**-0.5))
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
