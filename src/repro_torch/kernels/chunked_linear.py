"""Chunked scalar-decay linear attention: the CUDA kernel and its plain
version.

``chunked_linear_attention`` — the Mamba2-SSD / mLSTM substrate
  (``models/linear_scan.chunked_linear_attention``): for every (batch,
  head), over chunks of ``chunk`` rows, with A the inclusive cumulative
  log-decay of a row within its chunk,

    out_i = sum_{j <= i in its chunk} (q_i . k_j) e^{min(A_i - A_j, 0)} v_j
            + e^{A_i} q_i . S
    S    <- e^{A_last} S + sum_j e^{A_last - A_j} k_j v_j^T

  with the fp32 (dk, dv) state S carried from chunk to chunk (zero, or
  ``initial_state``). q, k: (b, n, H, dk); v: (b, n, H, dv); log_decay:
  (b, n, H), <= 0. A ragged last chunk is zero-padded (zero decay there, so
  A_last is the last real row's). Only S carries anything from one chunk to
  the next: the kernel and the plain version compute each chunk's own
  products and its state contribution dS_c = sum_j e^{A_last - A_j} k_j
  v_j^T apart, then the chain S_{c+1} = e^{A_last} S_c + dS_c, then the
  inter term. ``normalize`` appends a ones column to v and divides by
  max(|that column's output|, 1), in v's dtype, as the reference's wrapper
  does. Returns (out (b, n, H, dv) in v's dtype, final state (b, H, dk,
  dv[+1]) fp32). Written in CUDA C++ for Hopper (``csrc/chunked_linear.cu``,
  built by ``_build.py``). Heads up to 128 wide (Mamba2's 64): one CTA per
  (batch, head, chunk), the state handed from chunk to chunk through L2 by
  a flag per head, one launch a call. Wider heads (xLSTM's mLSTM: dk 1024,
  dv 1024 and the normaliser column) take the wide path, two launches a
  call: the intra term's decay-weighted scores P once per (head, chunk)
  into a scratch buffer, then one CTA per (batch, head, chunk, 64 columns
  of dv) walking dk in 64-row blocks, the state as 64 x 64 blocks each
  with its own chain and flag. Their bounds, designs and the precision of
  their products are written in the source. Replaces ``repro/kernels/
  chunked_linear.py:chunked_linear_attention_kernel`` (Pallas,
  ``_chunk_kernel``), which has no initial state.

The wrapper takes CPU tensors to the plain version and CUDA tensors to the
kernels, which take bf16 q, k, v only (fp32 raises ``TypeError`` there),
dk up to 1024 and dv up to 1032 (after the normaliser column; larger raise
``ValueError``; a size that is not a multiple of 8 is zero-padded here), q,
k and v through their strides with the last dim contiguous (the model's
head-broadcast q and k go in as views). The narrow kernel takes a chunk
whose cumulative log-decay fits the CTA's shared memory beside its tiles
(up to ~23,000 rows at 128-wide heads; a larger one is refused at launch),
the wide path chunks of up to 256 rows (larger raise ``ValueError``). It
never falls back.
``chunked_linear_attention.launches`` counts kernel launches: one a call
up to 128-wide heads, two on the wide path.
``ctas_per_sm`` (the narrow kernel's one free parameter, a measurement
knob) caps the CTAs an SM holds; ``occupancy`` says how many it holds.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.bifurcated_decode import _launch, _on_cuda

KERNEL_MAX_DIM = 128                 # the narrow kernel's widest head
KERNEL_DIMS = (16, 32, 64, 128)      # its padded sizes
WIDE_MAX_DK, WIDE_MAX_DV = 1024, 1032   # the wide path's (dv: 1024 + 1,
                                        # padded to a multiple of 8)
WIDE_MAX_CHUNK = 256
WIDE_BLOCK = 64                      # its state blocks are 64 x 64
MAX_CTAS_PER_SM = 32
_SYNC = {}      # (device index, stream) -> the kernel's int32 sync words


def _check(q, k, v, log_decay, chunk, initial_state, normalize):
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or \
            v.shape[:3] != q.shape[:3] or log_decay.shape != q.shape[:3]:
        raise ValueError(f"want q = k (b, n, H, dk), v (b, n, H, dv), "
                         f"log_decay (b, n, H); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_decay.shape)}")
    if min(q.shape) < 1 or v.shape[-1] < 1 or chunk < 1:
        raise ValueError(f"empty operand or chunk {chunk} < 1")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must have q's dtype")
    if initial_state is not None:
        b, _, H, dk = q.shape
        want = (b, H, dk, v.shape[-1] + (1 if normalize else 0))
        if tuple(initial_state.shape) != want:
            raise ValueError(f"initial_state {tuple(initial_state.shape)} "
                             f"is not {want}")


def _ones_column(v):
    return torch.cat([v, torch.ones(*v.shape[:-1], 1, dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _normalized(out):
    """num / max(|den|, 1) in out's dtype, den the last column."""
    num, den = out[..., :-1], out[..., -1]
    return num / torch.clamp(den.float().abs(), min=1.0).to(out.dtype)[..., None]


def chunked_linear_attention_plain(q, k, v, log_decay, *, chunk=256,
                                   normalize=False, initial_state=None):
    """Plain PyTorch version of ``chunked_linear_attention``, in the
    kernel's order, all in fp32: each chunk on its own (its cumulative
    log-decay A, its in-chunk products and its state contribution dS_c
    from zero), then the chain S_{c+1} = e^{A_last} S_c + dS_c from the
    initial state, then each chunk's inter term e^{A_i} q_i . S_c."""
    _check(q, k, v, log_decay, chunk, initial_state, normalize)
    b, n, H, dk = q.shape
    if normalize:
        v = _ones_column(v)
    dv = v.shape[-1]
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
    dev = q.device
    starts = range(0, n + pad, c)
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool, device=dev))
    out = torch.empty(b, n + pad, H, dv, dtype=torch.float32, device=dev)
    cum, d_state = [], []
    for c0 in starts:               # each chunk on its own
        qf, kf, vf = (t[:, c0:c0 + c].float() for t in (q, k, v))
        A = torch.cumsum(log_decay[:, c0:c0 + c].float(), dim=1)  # (b, c, H)
        diff = A[:, :, None, :] - A[:, None, :, :]                # (b, i, j, H)
        D = torch.where(causal[None, :, :, None],
                        torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        scores = torch.einsum("bihk,bjhk->bijh", qf, kf) * D
        out[:, c0:c0 + c] = torch.einsum("bijh,bjhv->bihv", scores, vf)
        k_scaled = kf * torch.exp(A[:, -1:] - A)[..., None]
        d_state.append(torch.einsum("bjhk,bjhv->bhkv", k_scaled, vf))
        cum.append(A)
    states = [torch.zeros(b, H, dk, dv, dtype=torch.float32, device=dev)
              if initial_state is None else initial_state.float().clone()]
    for A, dS in zip(cum, d_state):  # the chain: S_c entering each chunk
        states.append(states[-1] * torch.exp(A[:, -1])[..., None, None] + dS)
    for c0, A, S in zip(starts, cum, states):   # the inter term
        qf = q[:, c0:c0 + c].float()
        out[:, c0:c0 + c] += torch.einsum("bihk,bhkv->bihv",
                                          qf * torch.exp(A)[..., None], S)
    out = out[:, :n].to(v.dtype)
    if normalize:
        out = _normalized(out)
    return out, states[-1]


def _padded_dim(d: int) -> int:
    return next(s for s in KERNEL_DIMS if s >= d)


def _kernel_operand(x, width):
    """x with its last dim zero-padded to ``width`` (a copy) where it is
    not already; a view stays a view."""
    if x.shape[-1] == width:
        return x
    return F.pad(x, (0, width - x.shape[-1]))


def _ctas_arg(ctas_per_sm):
    """The kernel's CTA cap an SM: 0 (none) for None, else 1..MAX."""
    if ctas_per_sm is None:
        return 0
    if (isinstance(ctas_per_sm, bool) or not isinstance(ctas_per_sm, int)
            or not 1 <= ctas_per_sm <= MAX_CTAS_PER_SM):
        raise ValueError(f"ctas_per_sm must be None or an int in "
                         f"1..{MAX_CTAS_PER_SM}, not {ctas_per_sm!r}")
    return ctas_per_sm


def _sync_words(device, n):
    """The kernels' ticket counter and chain flags (one per (batch, head),
    or per (batch, head, state block) on the wide path): at least ``n``
    int32 words, zero between calls (each launch leaves them zero), one
    buffer per device and stream (calls on one stream run one
    after the other)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _SYNC.get(key)
    if buf is None or buf.numel() < n:
        buf = _SYNC[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def occupancy(dk, dv, chunk, ctas_per_sm=None, device=None):
    """The CTAs an SM the kernel holds at once for heads of ``dk``/``dv``
    and ``chunk`` rows, under ``ctas_per_sm`` (the card's report)."""
    d = _padded_dim(max(-(-dk // 8) * 8, -(-dv // 8) * 8))
    out = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = _build.library().chunked_linear_occupancy(
            d, chunk, _ctas_arg(ctas_per_sm), ctypes.addressof(out))
    if err:
        raise RuntimeError(f"chunked_linear_occupancy: CUDA error {err}")
    return out.value


def chunked_linear_attention(q, k, v, log_decay, *, chunk=256,
                             normalize=False, initial_state=None,
                             ctas_per_sm=None):
    """Chunked linear attention of q, k (b, n, H, dk), v (b, n, H, dv)
    under log_decay (b, n, H); returns (out (b, n, H, dv) in v's dtype,
    final state (b, H, dk, dv[+1]) fp32). ``ctas_per_sm``: None, or at
    most that many of the narrow kernel's CTAs an SM (the result is the
    same). On CUDA one launch, or two for heads past 128 wide, each
    counted in ``chunked_linear_attention.launches``."""
    _check(q, k, v, log_decay, chunk, initial_state, normalize)
    cap = _ctas_arg(ctas_per_sm)
    if initial_state is None:
        ops = (q, k, v, log_decay)
    else:
        ops = (q, k, v, log_decay, initial_state)
    if not _on_cuda(*ops):
        return chunked_linear_attention_plain(
            q, k, v, log_decay, chunk=chunk, normalize=normalize,
            initial_state=initial_state)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 q, k, v on CUDA, not "
                        f"{q.dtype}; float32 runs on the CPU's plain path")
    b, n, H, dk = q.shape
    if normalize:
        v = _ones_column(v)
    dv = v.shape[-1]
    dk8, dv8 = -(-dk // 8) * 8, -(-dv // 8) * 8
    c = min(chunk, n)
    wide = max(dk8, dv8) > KERNEL_MAX_DIM
    if wide:
        if dk8 > WIDE_MAX_DK or dv8 > WIDE_MAX_DV:
            raise ValueError(f"the kernels take dk up to {WIDE_MAX_DK} and "
                             f"dv up to {WIDE_MAX_DV} (with the normaliser "
                             f"column), not {dk} and {dv}")
        if c > WIDE_MAX_CHUNK:
            raise ValueError(f"the wide path (heads past {KERNEL_MAX_DIM}) "
                             f"takes chunks of up to {WIDE_MAX_CHUNK} rows, "
                             f"not {c}")
        if cap:
            raise ValueError("ctas_per_sm caps the narrow kernel only")
    qk = [_kernel_operand(t, dk8) for t in (q, k)]
    vk = _kernel_operand(v, dv8)
    for t in qk + [vk]:
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("q, k, v must have a contiguous last dim, "
                             "strides that are multiples of 8 and 16-byte "
                             "aligned rows")
    a = log_decay.float().contiguous()
    s0 = None
    if initial_state is not None:
        s0 = F.pad(initial_state.float(),
                   (0, dv8 - dv, 0, dk8 - dk)).contiguous()
    out = torch.empty(b, n, H, dv8, dtype=torch.bfloat16, device=q.device)
    state = torch.empty(b, H, dk8, dv8, dtype=torch.float32, device=q.device)
    strides = [s for t in (qk[0], qk[1], vk) for s in t.stride()[:3]]
    ptrs = [qk[0].data_ptr(), qk[1].data_ptr(), vk.data_ptr(), a.data_ptr(),
            None if s0 is None else s0.data_ptr()]
    if wide:
        blocks = -(-dk8 // WIDE_BLOCK) * -(-dv8 // WIDE_BLOCK)
        sync = _sync_words(q.device, 1 + b * H * blocks)
        cp = -(-c // 64) * 64
        scores = torch.empty(b * H * -(-n // c) * cp * cp,
                             dtype=torch.float32, device=q.device)
        args = (*ptrs, scores.data_ptr(), out.data_ptr(), state.data_ptr(),
                sync.data_ptr(), *strides, b, n, H, dk8, dv8, c)
        for name in ("chunked_linear_scores", "chunked_linear_wide"):
            _launch(name, q.device, *args)
            chunked_linear_attention.launches += 1
    else:
        sync = _sync_words(q.device, 1 + b * H)
        _launch("chunked_linear_attention", q.device, *ptrs, out.data_ptr(),
                state.data_ptr(), sync.data_ptr(), *strides, b, n, H, dk8,
                dv8, _padded_dim(max(dk8, dv8)), c, cap)
        chunked_linear_attention.launches += 1
    out, state = out[..., :dv], state[:, :, :dk, :dv]
    if normalize:
        out = _normalized(out)
    return out, state


chunked_linear_attention.launches = 0

