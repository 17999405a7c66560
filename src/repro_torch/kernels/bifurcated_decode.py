"""Fused bifurcated flash-decode: the CUDA kernels and their plain versions.

The paper's context GEMM (⟨q, K_c⟩, Eq. 3) is the memory-IO hot spot of
shared-prefix batch decoding: K_c is the one tensor whose HBM traffic the
technique eliminates b-fold. Two kernels live here, written in CUDA C++ for
Hopper (``csrc/bifurcated_decode.cu``, built by ``_build.py``):

``fused_bifurcated_decode`` — the deployable single-pass path. For each kv
  head, all ``rows = b*p*n`` query rows stream K_c/V_c once, then fold in
  their own sample's decode slots (slot bias applied in-kernel), and the
  normalised output is written once. No logits and no fp32 partials reach
  device memory. Replaces ``repro/kernels/bifurcated_decode.py:
  fused_bifurcated_decode`` (Pallas, ``_fused_kernel``).

``context_flash_partials`` — the context arm alone, returning the
  unnormalised fp32 ``(acc, m, l)`` partials: the two-pass escape hatch of
  ``ops.bifurcated_decode_attention``. Replaces
  ``repro/kernels/bifurcated_decode.py:context_flash_partials`` (Pallas,
  ``_ctx_flash_kernel``).

Each wrapper takes CPU tensors to its plain PyTorch version (which walks
the context in blocks with the same fp32 online update, ``_online_update``)
and CUDA tensors to its kernel; a CUDA tensor the kernel does not take
raises, it never falls back. ``<wrapper>.launches`` counts kernel launches.
The bound and design of the kernels are written at the top of the CUDA
source.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_M = 512        # context keys per block of the plain versions
KERNEL_HEAD_DIMS = (16, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _online_update(s, v, acc, m, l):
    """One flash block step: fold logits ``s`` (g, rows, blk) f32 and values
    ``v`` (g, blk, hd) into the running fp32 state ``acc`` (g, rows, hd),
    ``m`` and ``l`` (g, rows, 1). Returns the new ``(acc, m, l)``. The
    softmax weights are cast to ``v``'s dtype before the value product, and
    the product accumulates in fp32."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return acc * corr + pv, m_new, l_new


def _context_arm(q, k_ctx, v_ctx, scale, block_m):
    g, rows, hd = q.shape
    qf = q.float()
    acc = torch.zeros(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.full((g, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(g, rows, 1, dtype=torch.float32, device=q.device)
    for start in range(0, k_ctx.shape[1], block_m):
        k = k_ctx[:, start:start + block_m]
        s = torch.matmul(qf, k.float().transpose(1, 2)) * scale
        acc, m, l = _online_update(s, v_ctx[:, start:start + block_m],
                                   acc, m, l)
    return acc, m, l


def fused_bifurcated_decode_plain(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                                  scale: float, c_d: int, pn: int,
                                  block_m: int = BLOCK_M) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bifurcated_decode``: the context in
    ``block_m`` blocks, then the decode arm with the slot bias and the
    cross-sample mask ``row // pn == col // c_d``, then normalise."""
    acc, m, l = _context_arm(q, k_ctx, v_ctx, scale, block_m)
    rows, ld = q.shape[1], k_dec.shape[1]
    s = torch.matmul(q.float(), k_dec.float().transpose(1, 2)) * scale
    s = s + dec_bias.reshape(1, 1, ld)
    row_s = torch.arange(rows, device=q.device)[:, None] // pn
    col_s = torch.arange(ld, device=q.device)[None, :] // c_d
    s = torch.where(row_s == col_s, s, torch.full((), NEG_INF, device=q.device))
    acc, m, l = _online_update(s, v_dec, acc, m, l)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def context_flash_partials_plain(q, k_ctx, v_ctx, *, scale: float,
                                 block_m: int = BLOCK_M):
    """Plain PyTorch version of ``context_flash_partials``."""
    acc, m, l = _context_arm(q, k_ctx, v_ctx, scale, block_m)
    return acc, m[..., 0], l[..., 0]


def _on_cuda(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (the kernel runs), False
    when on the CPU (the plain version runs); raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_contiguous(*tensors):
    # the same contract on both devices, so CPU runs catch a bad layout
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")


def _check_kernel_operands(q, *tensors):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"not {q.shape[-1]}")
    if any(t.data_ptr() % 16 for t in (q,) + tensors):
        raise ValueError("kernel operands must be 16-byte aligned")


def _check_context(q, k_ctx, v_ctx):
    if q.ndim != 3 or k_ctx.ndim != 3 or k_ctx.shape != v_ctx.shape:
        raise ValueError(f"want q (g, rows, hd), k_ctx = v_ctx (g, m_c, hd); "
                         f"got {tuple(q.shape)}, {tuple(k_ctx.shape)}, "
                         f"{tuple(v_ctx.shape)}")
    g, _, hd = q.shape
    if k_ctx.shape[0] != g or k_ctx.shape[2] != hd or k_ctx.shape[1] < 1:
        raise ValueError(f"context {tuple(k_ctx.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if k_ctx.dtype != q.dtype or v_ctx.dtype != q.dtype:
        raise TypeError("context must have the query's dtype")


def _raise_on_error(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def fused_bifurcated_decode(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                            scale: float, c_d: int, pn: int) -> torch.Tensor:
    """Single-pass bifurcated decode; returns the normalised (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of sample r // pn
      k_ctx/v_ctx: (g, m_c, hd) shared context, q's dtype
      k_dec/v_dec: (g, b * c_d, hd) every sample's decode slots, group-major
      dec_bias:    (1, b * c_d) f32 — 0 for live slots, NEG_INF else
    """
    _check_context(q, k_ctx, v_ctx)
    g, rows, hd = q.shape
    ld = k_dec.shape[1]
    if (k_dec.shape != (g, ld, hd) or v_dec.shape != k_dec.shape
            or dec_bias.shape != (1, ld) or ld != (rows // pn) * c_d
            or rows % pn):
        raise ValueError(f"decode arm {tuple(k_dec.shape)}, bias "
                         f"{tuple(dec_bias.shape)} do not fit q "
                         f"{tuple(q.shape)} with c_d={c_d}, pn={pn}")
    if k_dec.dtype != q.dtype or v_dec.dtype != q.dtype:
        raise TypeError("decode arm must have the query's dtype")
    if dec_bias.dtype != torch.float32:
        raise TypeError("dec_bias must be float32")
    _check_contiguous(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    if not _on_cuda(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias):
        return fused_bifurcated_decode_plain(
            q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, scale=scale, c_d=c_d,
            pn=pn)
    _check_kernel_operands(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.fused_bifurcated_decode(
            q.data_ptr(), k_ctx.data_ptr(), v_ctx.data_ptr(),
            k_dec.data_ptr(), v_dec.data_ptr(), dec_bias.data_ptr(),
            out.data_ptr(), g, rows, k_ctx.shape[1], ld, hd, c_d, pn,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error("fused_bifurcated_decode", err)
    fused_bifurcated_decode.launches += 1
    return out


fused_bifurcated_decode.launches = 0


def context_flash_partials(q, k_ctx, v_ctx, *, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context-arm flash partials: acc (g, rows, hd) f32, m (g, rows) f32,
    l (g, rows) f32 — unnormalised, for an exact merge with another arm."""
    _check_context(q, k_ctx, v_ctx)
    _check_contiguous(q, k_ctx, v_ctx)
    if not _on_cuda(q, k_ctx, v_ctx):
        return context_flash_partials_plain(q, k_ctx, v_ctx, scale=scale)
    _check_kernel_operands(q, k_ctx, v_ctx)
    lib = _build.library()
    g, rows, hd = q.shape
    acc = torch.empty(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    l = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.context_flash_partials(
            q.data_ptr(), k_ctx.data_ptr(), v_ctx.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), g, rows, k_ctx.shape[1], hd,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error("context_flash_partials", err)
    context_flash_partials.launches += 1
    return acc, m, l


context_flash_partials.launches = 0
