"""KV-cache containers for incremental decoding.

Both cache families are stacked over layers (leading ``L`` axis); the model
loops over layers and hands each one its slice:

  * ``DecodeCache``      — the standard batched cache (b present on every slot).
  * ``BifurcatedCache``  — the paper's layout: an *unbatched* context cache
    shared by every sample (head-major ``(L, g, m_c, k)`` by default, so the
    fused decode kernel reads contiguous blocks with no per-layer transpose;
    sequence-major "mgk" remains available), plus a small batched decode
    cache ``(L, b, C_d, g, k)``. This is the data structure that makes the
    bifurcated GEMM (and its b-fold HBM saving) possible; it also cuts cache
    *storage* from b·(m_c+C_d) to m_c + b·C_d slots (paper §5.2.2).

Unlike the reference's functional updates, the port writes new decode KVs
IN PLACE into the existing arm tensors (``update_layer_cache``); a decode
step returns a cache object that shares those tensors with its input and
carries the advanced length. Lengths are host-side Python ints: the step
loop runs on the host and slices with them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class DecodeCache:
    """Standard batched KV cache. k/v: (L, b, C, g, hd); length: int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int  # number of valid slots, shared across batch


def update_layer_cache(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    index: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (b, n, g, k) new KVs at ``index`` into (b, C, g, k) caches, in
    place. Returns the same two tensors."""
    n = k_new.shape[1]
    if not 0 <= index <= k_cache.shape[1] - n:
        raise IndexError(f"cache write [{index}, {index + n}) outside "
                         f"capacity {k_cache.shape[1]}")
    k_cache[:, index:index + n] = k_new.to(k_cache.dtype)
    v_cache[:, index:index + n] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


@dataclasses.dataclass
class BifurcatedCache:
    """Bifurcated KV cache (paper §4).

    k_ctx/v_ctx — shared context, no batch axis; layout per ``ctx_layout``:
        "gmk" (default): (L, g, m_c, hd) — head-major, contiguous block
        reads for the fused decode kernel, no per-layer transpose copy.
        "mgk":           (L, m_c, g, hd) — sequence-major einsum layout.
    k_dec/v_dec: (L, b, C_d, g, hd) — per-sample decode continuation,
        written in place by each decode step.
    dec_length:  int                — valid decode slots.
    """

    k_ctx: torch.Tensor
    v_ctx: torch.Tensor
    k_dec: torch.Tensor
    v_dec: torch.Tensor
    dec_length: int
    ctx_layout: str = "gmk"

    @property
    def context_len(self) -> int:
        return self.k_ctx.shape[2 if self.ctx_layout == "gmk" else 1]

    @property
    def decode_capacity(self) -> int:
        return self.k_dec.shape[2]

    @staticmethod
    def from_prefill(k_ctx, v_ctx, batch, dec_capacity, dtype=torch.bfloat16,
                     ctx_layout="gmk"):
        """Build from a single-context prefill result (L, m_c, g, hd).

        The prefill emits sequence-major KV; under the default "gmk" layout
        the one-time transpose happens HERE (cache build) so that the
        per-step decode hot path never pays it again.
        """
        n_layers, _, n_groups, head_dim = k_ctx.shape
        if ctx_layout == "gmk":
            k_ctx = k_ctx.transpose(1, 2)  # (L, g, m_c, hd)
            v_ctx = v_ctx.transpose(1, 2)
        dec = (n_layers, batch, dec_capacity, n_groups, head_dim)
        return BifurcatedCache(
            k_ctx=k_ctx.to(dtype).contiguous(),
            v_ctx=v_ctx.to(dtype).contiguous(),
            k_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            v_dec=torch.zeros(dec, dtype=dtype, device=k_ctx.device),
            dec_length=0,
            ctx_layout=ctx_layout,
        )
