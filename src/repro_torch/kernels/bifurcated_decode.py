"""Fused bifurcated flash-decode: the CUDA kernels and their plain versions.

The paper's context GEMM (⟨q, K_c⟩, Eq. 3) is the memory-IO hot spot of
shared-prefix batch decoding: K_c is the one tensor whose HBM traffic the
technique eliminates b-fold. Five kernels live here, written in CUDA C++
for Hopper (``csrc/bifurcated_decode.cu`` and ``csrc/forest_q8_decode.cu``
over the shared ``csrc/decode_common.cuh``, built by ``_build.py``):

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

``fused_bifurcated_decode_q8`` — the fused decode with an int8 context arm
  (int8 K_c/V_c + f32 per-(token, head) scales, the logit scale pre-folded
  into ``k_scale``): the scales fold into the logits and the softmax
  weights, ``l`` unscaled. Replaces ``..._q8`` (Pallas, ``_fused_q8_kernel``).

``grouped_fused_bifurcated_decode`` / ``..._q8`` — the multi-prefix FOREST
  decode: G context segments, a row -> segment map and ragged live lengths
  ``ctx_lens``; each row attends over its own segment's live prefix and its
  own sample's decode slots. Rows whose segment id lies outside [0, G)
  come out NaN (the reference's einsum path gives NaN for ids >= G, its
  Pallas kernel decode-arm-only attention; the engine never makes such
  ids). Replace the Pallas ``_grouped_fused_kernel`` /
  ``_grouped_fused_q8_kernel``.

Each wrapper takes CPU tensors to its plain PyTorch version (which walks
the context in blocks with the same fp32 online update, ``_online_update``)
and CUDA tensors to its kernel; a CUDA tensor the kernel does not take
raises, it never falls back. The three kernels of the int8 and forest
paths take bf16 queries only on the card (fp32 stays on the CPU's plain
path). ``<wrapper>.launches`` counts kernel launches. The bound and design
of the kernels are written at the top of the CUDA sources.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_M = 512        # context keys per block of the plain versions
KERNEL_HEAD_DIMS = (16, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _online_update(s, v, acc, m, l, p_scale=None):
    """One flash block step: fold logits ``s`` (g, rows, blk) f32 and values
    ``v`` (g, blk, hd) into the running fp32 state ``acc`` (g, rows, hd),
    ``m`` and ``l`` (g, rows, 1). Returns the new ``(acc, m, l)``. The
    softmax weights are cast to ``v``'s dtype before the value product, and
    the product accumulates in fp32. ``p_scale`` (g, 1, blk): an optional
    per-column multiplier folded into the weights before the value product
    (the int8 arm's ``w * s_v`` fold); ``l`` stays unscaled."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    pv_in = p if p_scale is None else p * p_scale
    pv = torch.matmul(pv_in.to(v.dtype).float(), v.float())
    return acc * corr + pv, m_new, l_new


def _init_state(q):
    g, rows, hd = q.shape
    acc = torch.zeros(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.full((g, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(g, rows, 1, dtype=torch.float32, device=q.device)
    return acc, m, l


def _context_arm(q, k_ctx, v_ctx, scale, block_m, k_scale=None, v_scale=None,
                 length=None):
    """The context arm over keys [0, length) (default: all) in ``block_m``
    blocks. With ``k_scale``/``v_scale`` (g, m_c) the context is int8: the
    logits are (q · K_q) * k_scale (the logit scale pre-folded, ``scale``
    unused) and the weights carry v_scale against f32 V_q, as in the
    reference."""
    qf = q.float()
    acc, m, l = _init_state(q)
    stop = k_ctx.shape[1] if length is None else length
    for start in range(0, stop, block_m):
        end = min(start + block_m, stop)
        s = torch.matmul(qf, k_ctx[:, start:end].float().transpose(1, 2))
        v = v_ctx[:, start:end]
        if k_scale is None:
            acc, m, l = _online_update(s * scale, v, acc, m, l)
        else:
            acc, m, l = _online_update(
                s * k_scale[:, None, start:end], v.float(), acc, m, l,
                p_scale=v_scale[:, None, start:end])
    return acc, m, l


def _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l, *, scale,
                          c_d, pn):
    """Fold the decode arm (slot bias, cross-sample mask
    ``row // pn == col // c_d``) into the running state and normalise."""
    rows, ld = q.shape[1], k_dec.shape[1]
    s = torch.matmul(q.float(), k_dec.float().transpose(1, 2)) * scale
    s = s + dec_bias.reshape(1, 1, ld)
    row_s = torch.arange(rows, device=q.device)[:, None] // pn
    col_s = torch.arange(ld, device=q.device)[None, :] // c_d
    s = torch.where(row_s == col_s, s, torch.full((), NEG_INF, device=q.device))
    acc, m, l = _online_update(s, v_dec, acc, m, l)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def fused_bifurcated_decode_plain(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                                  scale: float, c_d: int, pn: int,
                                  block_m: int = BLOCK_M) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bifurcated_decode``: the context in
    ``block_m`` blocks, then the decode arm with the slot bias and the
    cross-sample mask ``row // pn == col // c_d``, then normalise."""
    acc, m, l = _context_arm(q, k_ctx, v_ctx, scale, block_m)
    return _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                 scale=scale, c_d=c_d, pn=pn)


def fused_bifurcated_decode_q8_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale,
                                     k_dec, v_dec, dec_bias, *, scale: float,
                                     c_d: int, pn: int,
                                     block_m: int = BLOCK_M) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bifurcated_decode_q8``: int8
    context arm (scales folded into logits and weights, the value product
    in f32), then the bf16 decode arm as in the fused version."""
    acc, m, l = _context_arm(q, k_ctx_q, v_ctx_q, scale, block_m,
                             k_scale=k_scale, v_scale=v_scale)
    return _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                 scale=scale, c_d=c_d, pn=pn)


def _grouped_plain(q, k_ctx, v_ctx, k_scale, v_scale, row_group, ctx_lens,
                   k_dec, v_dec, dec_bias, *, scale, c_d, pn, block_m):
    n_groups, _, m_c, _ = k_ctx.shape
    acc, m, l = _init_state(q)
    rg = row_group.long()
    lens = ctx_lens.tolist()
    for gi in range(n_groups):
        rows_g = torch.nonzero(rg == gi)[:, 0]
        if rows_g.numel() == 0:
            continue
        length = min(max(int(lens[gi]), 0), m_c)
        a, mm, ll = _context_arm(
            q[:, rows_g], k_ctx[gi], v_ctx[gi], scale, block_m,
            k_scale=None if k_scale is None else k_scale[gi],
            v_scale=None if v_scale is None else v_scale[gi], length=length)
        acc[:, rows_g], m[:, rows_g], l[:, rows_g] = a, mm, ll
    out = _decode_arm_and_flush(q, k_dec, v_dec, dec_bias, acc, m, l,
                                scale=scale, c_d=c_d, pn=pn)
    bad = (rg < 0) | (rg >= n_groups)
    return out.masked_fill(bad[None, :, None], float("nan"))


def grouped_fused_bifurcated_decode_plain(q, k_ctx, v_ctx, row_group,
                                          ctx_lens, k_dec, v_dec, dec_bias,
                                          *, scale: float, c_d: int, pn: int,
                                          block_m: int = BLOCK_M
                                          ) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_fused_bifurcated_decode``: each
    row's context arm over the live prefix of its own segment, then the
    decode arm as in the fused version; rows of a segment id outside
    [0, G) come out NaN."""
    return _grouped_plain(q, k_ctx, v_ctx, None, None, row_group, ctx_lens,
                          k_dec, v_dec, dec_bias, scale=scale, c_d=c_d,
                          pn=pn, block_m=block_m)


def grouped_fused_bifurcated_decode_q8_plain(q, k_ctx_q, v_ctx_q, k_scale,
                                             v_scale, row_group, ctx_lens,
                                             k_dec, v_dec, dec_bias, *,
                                             scale: float, c_d: int, pn: int,
                                             block_m: int = BLOCK_M
                                             ) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_fused_bifurcated_decode_q8``."""
    return _grouped_plain(q, k_ctx_q, v_ctx_q, k_scale, v_scale, row_group,
                          ctx_lens, k_dec, v_dec, dec_bias, scale=scale,
                          c_d=c_d, pn=pn, block_m=block_m)


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


def _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn):
    g, rows, hd = q.shape
    ld = k_dec.shape[1] if k_dec.ndim == 3 else -1
    if (k_dec.shape != (g, ld, hd) or v_dec.shape != k_dec.shape
            or dec_bias.shape != (1, ld) or rows % pn
            or ld != (rows // pn) * c_d):
        raise ValueError(f"decode arm {tuple(k_dec.shape)}, bias "
                         f"{tuple(dec_bias.shape)} do not fit q "
                         f"{tuple(q.shape)} with c_d={c_d}, pn={pn}")
    if k_dec.dtype != q.dtype or v_dec.dtype != q.dtype:
        raise TypeError("decode arm must have the query's dtype")
    if dec_bias.dtype != torch.float32:
        raise TypeError("dec_bias must be float32")
    return ld


def _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale, lead=()):
    """int8 values (*lead, g, m_c, hd) and f32 scales (*lead, g, m_c)."""
    g, _, hd = q.shape
    n = len(lead)
    if (k_ctx_q.ndim != 3 + n or k_ctx_q.shape[:n] != lead
            or k_ctx_q.shape[n] != g or k_ctx_q.shape[n + 2] != hd
            or k_ctx_q.shape[n + 1] < 1 or v_ctx_q.shape != k_ctx_q.shape
            or k_scale.shape != k_ctx_q.shape[:-1]
            or v_scale.shape != k_scale.shape):
        raise ValueError(f"int8 context {tuple(k_ctx_q.shape)}, scales "
                         f"{tuple(k_scale.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_ctx_q.dtype != torch.int8 or v_ctx_q.dtype != torch.int8:
        raise TypeError("int8 context values must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("int8 context scales must be float32")


def _check_segments(q, k_ctx, row_group, ctx_lens):
    n_groups = k_ctx.shape[0]
    if row_group.shape != (q.shape[1],) or ctx_lens.shape != (n_groups,):
        raise ValueError(f"row_group {tuple(row_group.shape)} / ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not fit q "
                         f"{tuple(q.shape)} and {n_groups} segments")
    if row_group.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("row_group and ctx_lens must be int32")


def _check_bf16_kernel(q, *tensors):
    """The int8 and forest kernels take bf16 queries only on the card."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"this kernel takes bfloat16 queries on CUDA, not "
                        f"{q.dtype}; float32 runs on the CPU's plain path")
    _check_kernel_operands(q, *tensors)


def _launch(name, device, *args):
    """Call the C function ``name`` on ``device``'s current stream (the
    library is built first if needed) and raise if the launch was
    refused."""
    fn = getattr(_build.library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(name, err)


def fused_bifurcated_decode(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, *,
                            scale: float, c_d: int, pn: int) -> torch.Tensor:
    """Single-pass bifurcated decode; returns the normalised (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of sample r // pn
      k_ctx/v_ctx: (g, m_c, hd) shared context, q's dtype
      k_dec/v_dec: (g, b * c_d, hd) every sample's decode slots, group-major
      dec_bias:    (1, b * c_d) f32 — 0 for live slots, NEG_INF else
    """
    _check_context(q, k_ctx, v_ctx)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    if not _on_cuda(*ops):
        return fused_bifurcated_decode_plain(*ops, scale=scale, c_d=c_d,
                                             pn=pn)
    _check_kernel_operands(*ops)
    g, rows, hd = q.shape
    out = torch.empty_like(q)
    _launch("fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(), g, rows,
            k_ctx.shape[1], ld, hd, c_d, pn, float(scale),
            _DTYPE_CODE[q.dtype])
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
    g, rows, hd = q.shape
    acc = torch.empty(g, rows, hd, dtype=torch.float32, device=q.device)
    m = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    l = torch.empty(g, rows, dtype=torch.float32, device=q.device)
    _launch("context_flash_partials", q.device,
            *(t.data_ptr() for t in (q, k_ctx, v_ctx, acc, m, l)), g, rows,
            k_ctx.shape[1], hd, float(scale), _DTYPE_CODE[q.dtype])
    context_flash_partials.launches += 1
    return acc, m, l


context_flash_partials.launches = 0


# ---------------------------------------------------------------------------
# int8 context arm and multi-prefix forest (csrc/forest_q8_decode.cu)
# ---------------------------------------------------------------------------

def fused_bifurcated_decode_q8(q, k_ctx_q, v_ctx_q, k_scale, v_scale, k_dec,
                               v_dec, dec_bias, *, scale: float, c_d: int,
                               pn: int) -> torch.Tensor:
    """Single-pass bifurcated decode with an int8 context arm; returns the
    normalised (g, rows, hd).

      q:               (g, rows, hd), rows = b * p * n
      k_ctx_q/v_ctx_q: (g, m_c, hd) int8
      k_scale/v_scale: (g, m_c) f32, ``k_scale`` with the logit scale
                       pre-folded (``scale`` applies to the decode arm only)
      k_dec/v_dec:     (g, b * c_d, hd), q's dtype; dec_bias (1, b * c_d) f32
    """
    _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx_q, v_ctx_q, k_scale, v_scale, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    if not _on_cuda(*ops):
        return fused_bifurcated_decode_q8_plain(*ops, scale=scale, c_d=c_d,
                                                pn=pn)
    _check_bf16_kernel(q, k_ctx_q, v_ctx_q, k_dec, v_dec, dec_bias)
    g, rows, hd = q.shape
    out = torch.empty_like(q)
    _launch("fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(), g, rows,
            k_ctx_q.shape[1], ld, hd, c_d, pn, float(scale))
    fused_bifurcated_decode_q8.launches += 1
    return out


fused_bifurcated_decode_q8.launches = 0


def grouped_fused_bifurcated_decode(q, k_ctx, v_ctx, row_group, ctx_lens,
                                    k_dec, v_dec, dec_bias, *, scale: float,
                                    c_d: int, pn: int) -> torch.Tensor:
    """Single-pass multi-prefix (forest) decode; returns the normalised
    (g, rows, hd).

      q:           (g, rows, hd), rows = b * p * n, row r of slot r // pn
      k_ctx/v_ctx: (G, g, m_c, hd) context segments, q's dtype
      row_group:   (rows,) int32 — the segment each row reads
      ctx_lens:    (G,) int32 — live length of each segment
      k_dec/v_dec: (g, b * c_d, hd); dec_bias (1, b * c_d) f32
    Rows whose segment id lies outside [0, G) come out NaN."""
    if k_ctx.ndim != 4 or v_ctx.shape != k_ctx.shape:
        raise ValueError(f"want k_ctx = v_ctx (G, g, m_c, hd); got "
                         f"{tuple(k_ctx.shape)}, {tuple(v_ctx.shape)}")
    _check_context(q, k_ctx[0], v_ctx[0])
    _check_segments(q, k_ctx, row_group, ctx_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx, v_ctx, row_group, ctx_lens, k_dec, v_dec, dec_bias)
    _check_contiguous(*ops)
    if not _on_cuda(*ops):
        return grouped_fused_bifurcated_decode_plain(*ops, scale=scale,
                                                     c_d=c_d, pn=pn)
    _check_bf16_kernel(q, k_ctx, v_ctx, k_dec, v_dec, dec_bias)
    n_groups, g, m_c, hd = k_ctx.shape
    out = torch.empty_like(q)
    _launch("grouped_fused_bifurcated_decode", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(), n_groups, g,
            q.shape[1], m_c, ld, hd, c_d, pn, float(scale))
    grouped_fused_bifurcated_decode.launches += 1
    return out


grouped_fused_bifurcated_decode.launches = 0


def grouped_fused_bifurcated_decode_q8(q, k_ctx_q, v_ctx_q, k_scale, v_scale,
                                       row_group, ctx_lens, k_dec, v_dec,
                                       dec_bias, *, scale: float, c_d: int,
                                       pn: int) -> torch.Tensor:
    """``grouped_fused_bifurcated_decode`` over int8 segments
    (G, g, m_c, hd) and f32 scales (G, g, m_c), ``k_scale`` with the logit
    scale pre-folded."""
    lead = tuple(k_ctx_q.shape[:1])
    _check_q8_context(q, k_ctx_q, v_ctx_q, k_scale, v_scale, lead=lead)
    _check_segments(q, k_ctx_q, row_group, ctx_lens)
    ld = _check_decode_arm(q, k_dec, v_dec, dec_bias, c_d, pn)
    ops = (q, k_ctx_q, v_ctx_q, k_scale, v_scale, row_group, ctx_lens, k_dec,
           v_dec, dec_bias)
    _check_contiguous(*ops)
    if not _on_cuda(*ops):
        return grouped_fused_bifurcated_decode_q8_plain(*ops, scale=scale,
                                                        c_d=c_d, pn=pn)
    _check_bf16_kernel(q, k_ctx_q, v_ctx_q, k_dec, v_dec, dec_bias)
    n_groups, g, m_c, hd = k_ctx_q.shape
    out = torch.empty_like(q)
    _launch("grouped_fused_bifurcated_decode_q8", q.device,
            *(t.data_ptr() for t in ops), out.data_ptr(), n_groups, g,
            q.shape[1], m_c, ld, hd, c_d, pn, float(scale))
    grouped_fused_bifurcated_decode_q8.launches += 1
    return out


grouped_fused_bifurcated_decode_q8.launches = 0

# every kernel wrapper of this module, for code that reads or resets the
# launch counts
KERNELS = (fused_bifurcated_decode, context_flash_partials,
           fused_bifurcated_decode_q8, grouped_fused_bifurcated_decode,
           grouped_fused_bifurcated_decode_q8)
