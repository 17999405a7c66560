"""Config system: model and serve dataclasses.

The port's own copy of the reference's configuration (``repro/configs``):
the same fields, defaults and derived properties, so a config built here
describes the same model as its counterpart there. Only the dense family
is ported, so the fields and classes that only the other families read
(mixture-of-experts, state-space, encoder-decoder, vision) are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def round_up(x: int, multiple: int) -> int:
    if multiple <= 1:
        return x
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # "dense": the one family ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1_000_000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | geglu | gelu
    tie_embeddings: bool = False
    # full-sequence attention implementation: "chunked" materializes
    # (chunk x m) logit rows (baseline); "flash" is the online-softmax
    # nested-scan path (beyond-paper prefill optimization, §Perf).
    train_attn: str = "chunked"
    # bifurcated context-cache layout: "gmk" (g, m_c, hd) head-major is the
    # default — contiguous block reads for the fused decode kernel and no
    # per-layer transpose copy on the hot path (uses the flash/kernel decode
    # impls). "mgk" (m_c, g, hd) is the sequence-major einsum layout.
    ctx_layout: str = "gmk"
    # padding multiples for sharding divisibility (Megatron-style padding).
    vocab_pad_multiple: int = 256
    head_pad_multiple: int = 1   # set to the mesh "model" axis size for TP
    dtype: str = "bfloat16"
    # serving: decode-cache capacity reserved beyond the shared context.
    decode_capacity: int = 256

    # ---- derived ----
    @property
    def kq_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def n_heads_padded(self) -> int:
        """Query heads padded so that h is shardable over the model axis."""
        return round_up(self.n_heads, self.head_pad_multiple)

    @property
    def n_kv_heads_padded(self) -> int:
        g, h = self.n_kv_heads, self.n_heads
        p = h // g
        # keep the group size p intact; pad groups so g_pad * p == h_pad.
        g_pad = round_up(g, max(1, self.head_pad_multiple // max(1, p)))
        while (g_pad * p) < self.n_heads_padded:
            g_pad += 1
        return g_pad

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def param_count_estimate(self) -> int:
        """Analytic 2-matmul-free parameter count (embeddings included)."""
        d, k = self.d_model, self.kq_dim
        h, g = self.n_heads, self.n_kv_heads
        attn = d * h * k + 2 * d * g * k + h * k * d
        if self.act in ("swiglu", "geglu"):
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_layer = attn + ffn
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Single-prefix batch-sampling serve configuration (the paper's
    workload, ``runtime.serve.ServeEngine``): ONE shared context of up to
    ``context_len`` tokens, ``batch`` samples decoding in lockstep, each
    with a ``decode_capacity``-token per-sample arm. ``bifurcated``
    enables the split cache (policy may still fall back for tiny
    workloads); ``use_kernel`` lowers decode layer-steps to the fused
    CUDA kernel; ``cache_dtype`` selects the context arm's storage. The
    port serves "bfloat16" only: "int8" and ``ctx_store="paged"`` raise
    ``NotImplementedError`` (runtime/serve.py)."""

    batch: int = 16              # samples per shared context
    context_len: int = 8192
    decode_capacity: int = 256
    temperature: float = 0.8
    top_p: float = 0.95
    bifurcated: bool = True
    # single-pass fused CUDA decode kernel vs paper-faithful einsums
    use_kernel: bool = False
    # context-arm cache dtype: "bfloat16" ("int8" is not ported yet)
    cache_dtype: str = "bfloat16"
    # context storage substrate: "dense" ("paged" is not ported yet)
    ctx_store: str = "dense"
    page_size: int = 128         # paged mode: tokens per pool page
    seed: int = 0
