"""Config system: model and serve dataclasses.

The port's own copy of the reference's configuration (``repro/configs``):
the same fields, defaults and derived properties, so a config built here
describes the same model as its counterpart there: every family of the
reference (dense, mixture-of-experts, vision-language, encoder-decoder,
the zamba2 hybrid and xLSTM). The reference's ``MeshRules`` and
``TrainConfig`` (sharding and training) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def round_up(x: int, multiple: int) -> int:
    if multiple <= 1:
        return x
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # tokens are re-grouped to this many per dispatch group to bound the
    # (G, S, E, C) dispatch tensor (GShard/T5X-style einsum dispatch).
    group_size: int = 512
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Chunked linear-attention substrate config (mLSTM / Mamba2-SSD)."""

    state_dim: int = 64          # key/state dim per head (Mamba2 N)
    head_dim: int = 64           # value dim per head
    n_heads: int = 0             # 0 -> derive from d_inner / head_dim
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256
    kind: str = "mamba2"         # "mamba2" | "mlstm" | "slstm"
    slstm_every: int = 0         # xLSTM: every k-th layer is an sLSTM block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | xlstm | hybrid | encdec | vlm
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one globally-shared attention block applied every
    # `attn_period` ssm layers (Zamba-style parameter sharing).
    attn_period: int = 0
    # encdec (whisper): `n_layers` decoder layers + this many encoder layers.
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # learned absolute positions (whisper). 0 -> RoPE via rope_theta.
    max_position: int = 0
    max_enc_position: int = 0
    # vlm (internvl2): stub frontend provides this many patch embeddings.
    n_image_tokens: int = 0
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
        if self.moe is not None:
            ffn = ffn * self.moe.n_experts + d * self.moe.n_experts
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
    CUDA kernel; ``cache_dtype`` selects the context arm's storage:
    "bfloat16", or "int8" (quantized once at cache build, decoded by the
    fused q8 kernel). ``ctx_store="paged"`` stores the context in a page
    pool of ``page_size``-token pages, decoded by the paged kernel."""

    batch: int = 16              # samples per shared context
    context_len: int = 8192
    decode_capacity: int = 256
    temperature: float = 0.8
    top_p: float = 0.95
    bifurcated: bool = True
    # single-pass fused CUDA decode kernel vs paper-faithful einsums
    use_kernel: bool = False
    # context-arm cache dtype: "bfloat16" | "int8" (quantized once at
    # cache build, core/quantized.py)
    cache_dtype: str = "bfloat16"
    # context storage substrate: "dense" | "paged" (core/paged.py)
    ctx_store: str = "dense"
    page_size: int = 128         # paged mode: tokens per pool page
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Continuous-batching (multi-prefix forest) serve configuration
    (``runtime.serve.ForestServeEngine``).

    The forest engine serves G concurrent shared-prefix requests from one
    decode batch of ``slots`` samples: each admitted request prefills into
    a free context segment (capacity ``ctx_capacity`` tokens) and fans out
    over free decode slots. All of this is runtime DATA: the cache's
    tensors are sized once for (slots, n_groups, ctx_capacity,
    decode_capacity) and serve any admit/retire sequence.
    ``ctx_store="paged"`` stores the segments in a shared page pool of
    ``num_pages`` pages of ``page_size`` tokens.
    """

    n_groups: int = 4            # context segments (G)
    slots: int = 16              # decode slots (flat batch b)
    ctx_capacity: int = 512      # per-segment context capacity (tokens)
    decode_capacity: int = 64    # per-slot decode capacity (tokens)
    eos_token: int = -1          # retire a slot when it samples this; -1: off
    pad_token: int = 0           # emitted by retired slots
    temperature: float = 0.0     # greedy by default (continuous serving)
    top_p: float = 1.0
    use_kernel: bool = False     # grouped fused CUDA kernel vs einsum path
    # context-segment dtype: "bfloat16" | "int8" (segments quantize once at
    # admission: write-once read-many, per prefix group)
    cache_dtype: str = "bfloat16"
    # segment storage substrate: "dense" (fixed ctx_capacity slabs) |
    # "paged" (shared page pool, core/paged.py)
    ctx_store: str = "dense"
    page_size: int = 128         # paged mode: tokens per pool page
    # paged mode: pool size in pages; None = the full table envelope
    num_pages: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Hierarchical prefix-trie (cascade) serve configuration
    (``runtime.serve.TreeServeEngine``).

    Requests arrive as a PATH of shared segments (system prompt ->
    few-shot template -> per-request prompt). Admission matches the
    longest existing prefix path in the trie, prefills once per request,
    writes each NEW level's KV slice into a free node segment (capacity
    ``node_capacity`` tokens each) and fans samples out over free decode
    slots. The cache's tensors are sized once for (slots, n_nodes, depth,
    node_capacity, decode_capacity) and serve any admit/retire sequence.

    ``depth`` is the maximum trie depth (the path table's height); a
    request may use fewer levels (unused levels are -1 in the path table).
    At depth == 1 the engine serves the flat forest's workload.

    ``suffix_prefill`` prefills only a request's new levels over its
    matched ancestors' cached K/V; ``step_mode="packed"`` defers that
    prefill to chunks of ``prefill_chunk`` tokens riding on the decode
    steps.

    ``prefix_cache`` keeps refcount-zero trie nodes RESIDENT (K/V, pages
    and trie-index entry held) so that a later request with the same
    prefix revives them at no prefill and no new page; they are evicted
    lazily, children first, only under node or page pressure, in the
    order ``evict_policy`` names: "lru" (oldest stamp first, smallest
    subtree breaking ties) or "sharing" (fewest ancestor-shared bytes
    first: cold private tails go before leaves under hot shared
    ancestors; the stamp breaks ties). Off: the evict-eagerly behaviour,
    exactly.
    """

    n_nodes: int = 8             # trie-node segments (N)
    depth: int = 3               # path-table height (max trie depth)
    slots: int = 16              # decode slots (flat batch b)
    node_capacity: int = 256     # per-node context capacity (tokens)
    decode_capacity: int = 64    # per-slot decode capacity (tokens)
    eos_token: int = -1          # retire a slot when it samples this; -1: off
    pad_token: int = 0           # emitted by retired slots
    temperature: float = 0.0     # greedy by default (continuous serving)
    top_p: float = 1.0
    use_kernel: bool = False     # tree fused CUDA kernel vs einsum path
    # node-segment dtype: "bfloat16" | "int8" (nodes quantize once at
    # admission: write-once read-many, per trie node)
    cache_dtype: str = "bfloat16"
    # node storage substrate: "dense" (fixed node_capacity slabs) |
    # "paged" (shared page pool, core/paged.py)
    ctx_store: str = "dense"
    page_size: int = 128         # paged mode: tokens per pool page
    # paged mode: pool size in pages; None = the full table envelope
    num_pages: Optional[int] = None
    # cross-request prefix cache: refcount-zero nodes kept resident and
    # revived by a matching admission, evicted lazily under pressure
    prefix_cache: bool = False
    # suffix-only prefill on a prefix hit: the matched ancestors' cached
    # KV is the context of a prefill of the new levels' tokens only
    suffix_prefill: bool = False
    # "decode" (admission prefills synchronously) | "packed" (an admission
    # with new levels is prefilled in chunks piggybacked onto decode steps)
    step_mode: str = "decode"
    # packed mode: suffix tokens prefilled per piggybacked chunk; 0 =
    # page_size. Chunks never cross trie-node boundaries.
    prefill_chunk: int = 0
    # prefix-cache eviction order: "lru" (oldest stamp first) | "sharing"
    # (least ancestor-shared bytes first, the stamp breaking ties)
    evict_policy: str = "lru"
    seed: int = 0
