"""Shared transformer building blocks: norms, MLPs, attention layers.

All parameters are plain dicts of tensors; all apply functions are pure
except the decode step, which writes the new token's KV into its cache in
place (core/kv_cache.py). Layer parameters are stacked (L, ...) so the model
can hand each layer its slice. Matmul weights are cast to the activation
dtype at each use, as in the reference; when the weights are stored in that
dtype already (the serving default) the cast is free.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import decode_attention
from repro_torch.core.bifurcated import (
    bifurcated_attention,
    bifurcated_attention_flash,
    forest_bifurcated_attention,
    tree_bifurcated_attention,
)
from repro_torch.core.kv_cache import update_layer_cache
from repro_torch.core.masks import mask_to_bias
from repro_torch.core.paged import gather_pages
from repro_torch.core.quantized import (
    bifurcated_attention_q8,
    forest_bifurcated_attention_q8,
    tree_bifurcated_attention_q8,
)
from repro_torch.core.rotary import apply_rope
from repro_torch.kernels.flash_prefill import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
from repro_torch.kernels.ops import (
    bifurcated_decode_attention,
    bifurcated_decode_attention_q8,
    grouped_bifurcated_decode_attention,
    grouped_bifurcated_decode_attention_q8,
    packed_bifurcated_decode_attention,
    packed_bifurcated_decode_attention_q8,
    paged_bifurcated_decode_attention,
    paged_bifurcated_decode_attention_q8,
    tree_bifurcated_decode_attention,
    tree_bifurcated_decode_attention_q8,
)


def _dense_init(gen: torch.Generator, shape, fan_in: int,
                dtype=None) -> torch.Tensor:
    """Scaled-normal init (1/sqrt(fan_in)), drawn in float32 and cast to
    ``dtype`` (None: kept float32)."""
    w = torch.randn(shape, generator=gen, device=gen.device).div_(fan_in**0.5)
    return w if dtype is None else w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, shape, device=None):
    """Norm params (float32, applied in float32): ``shape`` is (d,) or the
    stacked (L, d)."""
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-5):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:  # rmsnorm
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def rms_normalize(x, scale, eps: float = 1e-5):
    """The float32 mean-square norm of the Mamba2 layers (no bias)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def unembed(cfg: ModelConfig, params, x):
    """Logits over the padded vocabulary (padding at -1e30), from the
    ``lm_head`` table or, tied, the embedding."""
    table = params.get("lm_head", params["embed"])
    logits = x @ table.T.to(x.dtype)
    if cfg.padded_vocab > cfg.vocab_size:
        pad_bias = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size,
            0.0, -1e30).to(logits.dtype)
        logits = logits + pad_bias
    return logits


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
             dtype=None):
    """Stacked (L, ...) MLP weights, each cast to ``dtype`` as drawn."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi_gate": _dense_init(gen, (n_layers, d, f), d, dtype),
            "wi_up": _dense_init(gen, (n_layers, d, f), d, dtype),
            "w_down": _dense_init(gen, (n_layers, f, d), f, dtype),
        }
    return {"wi": _dense_init(gen, (n_layers, d, f), d, dtype),
            "w_down": _dense_init(gen, (n_layers, f, d), f, dtype)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _silu(x):
    # jax.nn.silu's own op sequence, each op rounding in x's dtype: in bf16
    # this matches the reference bit for bit, where F.silu rounds once
    return x * (1 / (1 + torch.exp(-x)))


def apply_mlp(cfg: ModelConfig, params, x):
    dtype = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        gate = x @ params["wi_gate"].to(dtype)
        up = x @ params["wi_up"].to(dtype)
        act = _silu(gate) if cfg.act == "swiglu" else _gelu(gate)
        h = act * up
    else:
        h = _gelu(x @ params["wi"].to(dtype))
    return h @ params["w_down"].to(dtype)


# ---------------------------------------------------------------------------
# Attention layer
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                   dtype=None):
    """Stacked (L, ...) attention weights, each cast to ``dtype`` as drawn
    (the qkv biases zeros)."""
    d, hd = cfg.d_model, cfg.kq_dim
    h, g = cfg.n_heads_padded, cfg.n_kv_heads_padded
    p = {
        "wq": _dense_init(gen, (n_layers, d, h * hd), d, dtype),
        "wk": _dense_init(gen, (n_layers, d, g * hd), d, dtype),
        "wv": _dense_init(gen, (n_layers, d, g * hd), d, dtype),
        "wo": _dense_init(gen, (n_layers, h * hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", g * hd), ("bv", g * hd)):
            p[name] = torch.zeros((n_layers, width),
                                  dtype=dtype or torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(cfg: ModelConfig, params, x, x_kv=None):
    """x: (b, n, d) -> q (b, n, h, hd), k/v (b, m, g, hd) from ``x_kv``
    (b, m, d), default ``x``."""
    dtype = x.dtype
    h, g, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.kq_dim
    x_kv = x if x_kv is None else x_kv
    q = x @ params["wq"].to(dtype)
    k = x_kv @ params["wk"].to(dtype)
    v = x_kv @ params["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    b, n = q.shape[:2]
    m = k.shape[1]
    return q.reshape(b, n, h, hd), k.reshape(b, m, g, hd), v.reshape(b, m, g, hd)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Memory-bounded full attention, causal (optionally sliding-window) or
    not (every query sees every key: an encoder, a cross-attention with
    m != n): a loop over query chunks.

    q: (b, n, h, hd); k, v: (b, m, g, hd) with h = g * p — the kv tensors are
    broadcast over the group dimension inside the einsum (no materialized
    repeat). Logits for one chunk are (b, h, chunk, m), so the peak
    activation is n/chunk times smaller than the full logits tensor.

    ``q_offset`` shifts the queries' absolute positions for the causal and
    window masks: query row i sits at position q_offset + i while the keys
    stay at 0..m-1 (the suffix-prefill case, where the first q_offset keys
    are a cached prefix every query may attend to). A window needs
    ``causal``, as in ``flash_chunked_attention``.
    """
    if window is not None and not causal:
        raise ValueError("a window needs causal=True")
    b, n, h, hd = q.shape
    m, g = k.shape[1], k.shape[2]
    p = h // g
    scale = hd**-0.5
    chunk = min(chunk, n)
    k_pos = torch.arange(m, device=q.device)[None, :]
    outs = []
    for start in range(0, n, chunk):
        qc = q[:, start:start + chunk]
        c = qc.shape[1]
        qc = qc.reshape(b, c, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,c,hd)
        logits = torch.einsum("bgpck,bmgk->bgpcm", qc, k).float() * scale
        if causal:
            q_pos = q_offset + start + torch.arange(c, device=q.device)[:, None]
            mask = k_pos <= q_pos
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
            logits = logits + mask_to_bias(mask)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgpcm,bmgk->bgpck", w.to(v.dtype), v)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd))
    return torch.cat(outs, dim=1)


def flash_chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax (flash) attention: fp32 (m, l, acc) running state over
    key blocks, never the (n x m) logits. Shapes as ``chunked_attention``:
    q (b, n, h, hd), k/v (b, m, g, hd); query row i sits at position
    ``q_offset`` + i. A CUDA tensor runs kernel #12
    (``kernels/flash_prefill.flash_prefill_attention``), whose tiles are its
    own: ``q_chunk`` and ``kv_chunk`` are the reference's blocks, and only
    the plain version that a CPU tensor runs takes them. A window needs
    ``causal`` (see the kernel module)."""
    if q.is_cuda:
        return flash_prefill_attention(q, k, v, causal=causal,
                                       window=window or 0, q_offset=q_offset)
    return flash_prefill_attention_plain(
        q, k, v, causal=causal, window=window or 0, q_offset=q_offset,
        block_q=q_chunk, block_k=kv_chunk)


def _check_train_attn(cfg: ModelConfig):
    if cfg.train_attn not in ("chunked", "flash"):
        raise NotImplementedError(f"train_attn={cfg.train_attn!r} is not ported")


def attention_train(cfg: ModelConfig, params, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None, *,
                    causal: bool = True,
                    x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill, encoder): causal self-attention,
    or with ``causal=False`` every query over every key; ``x_kv`` (b, m, d)
    makes it a cross-attention over another sequence (no rope)."""
    _check_train_attn(cfg)
    q, k, v = _project_qkv(cfg, params, x, x_kv)
    if cfg.rope_theta > 0 and x_kv is None:
        if positions is None:
            positions = torch.arange(q.shape[1], device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.train_attn == "flash":
        o = flash_chunked_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window)
    else:
        o = chunked_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window)
    b, n = o.shape[:2]
    o = o.reshape(b, n, cfg.n_heads_padded * cfg.kq_dim)
    return o @ params["wo"].to(x.dtype)


def attention_prefill_kv(cfg: ModelConfig, params, x: torch.Tensor,
                         positions: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return the rotated K/V tensors that prefill writes into the cache
    (``positions`` default 0..n-1)."""
    _, k, v = _project_qkv(cfg, params, x)
    if cfg.rope_theta > 0:
        if positions is None:
            positions = torch.arange(k.shape[1], device=x.device)
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def attention_prefill_suffix(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    k_anc: torch.Tensor,
    v_anc: torch.Tensor,
    *,
    positions: torch.Tensor,
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bifurcated SUFFIX prefill for one layer: the n fresh suffix tokens
    (``x``: (b, n, d), absolute ``positions`` m_anc..m_anc+n-1) attend over
    [cached ancestor KV ∥ their own fresh KV]. ``k_anc``/``v_anc``:
    (b, m_anc, g, hd), already rotated at their absolute positions: they
    come out of the serve cache and are never recomputed (admission costs
    O(n), not O(m_anc + n)).

    Returns (attention output (b, n, d), k_new, v_new): the fresh K/V are
    the tensors a full prefill would produce at ``positions``."""
    _check_train_attn(cfg)
    q, k_new, v_new = _project_qkv(cfg, params, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    m_anc = k_anc.shape[1]
    k_full = torch.cat([k_anc.to(k_new.dtype), k_new], dim=1)
    v_full = torch.cat([v_anc.to(v_new.dtype), v_new], dim=1)
    # absolute-position causal mask: query row i is position m_anc + i, so
    # every row sees the whole cached prefix and its own causal suffix
    if cfg.train_attn == "flash":
        o = flash_chunked_attention(q, k_full, v_full, causal=True,
                                    window=cfg.sliding_window, q_chunk=chunk,
                                    q_offset=m_anc)
    else:
        o = chunked_attention(q, k_full, v_full, window=cfg.sliding_window,
                              chunk=chunk, q_offset=m_anc)
    b, n = o.shape[:2]
    o = o.reshape(b, n, cfg.n_heads_padded * cfg.kq_dim)
    return o @ params["wo"].to(x.dtype), k_new, v_new


def attention_decode(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    layer_cache: dict,
    *,
    position: int,
    bifurcated: bool,
    impl: str = "einsum",  # einsum (paper 4-einsum) | flash (online merge) | kernel (CUDA)
) -> torch.Tensor:
    """One incremental-decoding step for one layer; returns its output
    (b, n, d) and writes the step's K/V into ``layer_cache`` IN PLACE.

    ``layer_cache`` (standard):   {"k": (b,C,g,hd), "v": ...}
    ``layer_cache`` (bifurcated): {"k_ctx": (m_c,g,hd) | (g,m_c,hd), "v_ctx":
                                   ..., "k_dec": (b,Cd,g,hd), "v_dec": ...}
      — plus {"k_scale", "v_scale"} (layout-shaped per-(token, head) f32)
      when the context arm is int8 (core/quantized.py).
    ``position`` — absolute position of the new token(s); also the write
    index for the standard cache; decode-cache index is position - m_c.

    n > 1 (speculative draft blocks): all paths share one (b, C_d) slot
    mask, so attention WITHIN the fresh draft block is bidirectional, as in
    the reference.
    """
    b, n = x.shape[:2]
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, params, x)
    if cfg.rope_theta > 0:
        pos = position + torch.arange(n, device=dev)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    q = q.reshape(b, n, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,n,hd)

    window = cfg.sliding_window
    last = position + n - 1
    if bifurcated:
        gmk = cfg.ctx_layout == "gmk"
        m_c = layer_cache["k_ctx"].shape[1 if gmk else 0]
        dec_idx = position - m_c
        k_dec, v_dec = update_layer_cache(
            layer_cache["k_dec"], layer_cache["v_dec"], k_new, v_new, dec_idx)
        cap = k_dec.shape[1]
        slot = torch.arange(cap, device=dev)[None, :]
        dec_valid = slot <= dec_idx + n - 1
        ctx_valid = None
        if window is not None:
            # SWA clips the live context to the trailing `window` positions.
            ctx_valid = torch.arange(m_c, device=dev) > last - window
            dec_valid = dec_valid & (slot + m_c > last - window)
        dec_mask = dec_valid.expand(b, cap)
        k_ctx, v_ctx = layer_cache["k_ctx"], layer_cache["v_ctx"]
        if "k_scale" in layer_cache:  # int8 context arm
            k_s, v_s = layer_cache["k_scale"], layer_cache["v_scale"]
            if impl == "kernel" and window is None:
                # single-pass fused q8 CUDA decode: int8 context blocks and
                # scales, dequantized in-kernel, merged with the decode arm
                o = bifurcated_decode_attention_q8(
                    q, k_ctx, v_ctx, k_s, v_s, k_dec, v_dec, dec_mask,
                    ctx_layout=cfg.ctx_layout)
            else:
                o = bifurcated_attention_q8(
                    q, k_ctx, v_ctx, k_s, v_s, k_dec, v_dec,
                    decode_mask=dec_mask, context_mask=ctx_valid,
                    ctx_layout=cfg.ctx_layout)
        elif impl == "kernel" and window is None:
            # single-pass fused CUDA decode: context stream + decode arm +
            # merge in ONE launch, any n (drafts ride the kernel's rows).
            o = bifurcated_decode_attention(
                q, k_ctx, v_ctx, k_dec, v_dec, dec_mask,
                ctx_layout=cfg.ctx_layout)
        elif impl == "flash" or gmk:
            o = bifurcated_attention_flash(
                q, k_ctx, v_ctx, k_dec, v_dec, decode_mask=dec_mask,
                context_mask=ctx_valid, ctx_layout=cfg.ctx_layout)
        else:
            o = bifurcated_attention(
                q, k_ctx, v_ctx, k_dec, v_dec, decode_mask=dec_mask,
                context_mask=ctx_valid)
    else:
        k_cache, v_cache = update_layer_cache(
            layer_cache["k"], layer_cache["v"], k_new, v_new, position)
        cap = k_cache.shape[1]
        slot = torch.arange(cap, device=dev)[None, :]
        valid = slot <= last
        if window is not None:
            valid = valid & (slot > last - window)
        o = decode_attention(q, k_cache, v_cache,
                             valid_mask=valid.expand(b, cap))

    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
    return o @ params["wo"].to(x.dtype)


def _scatter_decode_slots(cache_arr, new, starts):
    """Write (b, n, g, hd) new KVs at PER-SLOT offsets ``starts`` (b,) into
    a (b, C_d, g, hd) decode cache, in place and with no host sync — the
    continuous-batching analogue of ``update_layer_cache`` (slots admitted
    at different times sit at different decode depths). An offset past
    C_d - n is clamped to it, as the reference's dynamic_update_slice
    clamps (the engine's capacity guard keeps live slots from it)."""
    b, n = new.shape[:2]
    start = torch.clamp(starts.long(), 0, cache_arr.shape[1] - n)
    cols = start[:, None] + torch.arange(n, device=new.device)[None, :]
    rows = torch.arange(b, device=new.device)[:, None].expand(b, n)
    cache_arr[rows, cols] = new.to(cache_arr.dtype)
    return cache_arr


def attention_decode_forest(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    layer_cache: dict,
    *,
    group_ids: torch.Tensor,  # (b,) int32 — slot -> prefix-group assignment
    ctx_lens: torch.Tensor,   # (G,) int32 — live (ragged) prefix lengths
    dec_lens: torch.Tensor,   # (b,) int32 — per-slot decode depth
    impl: str = "einsum",     # einsum (forest reference) | kernel (CUDA)
) -> torch.Tensor:
    """One incremental-decoding step for one layer over a PREFIX FOREST:
    G shared-context segments and b decode slots, each slot attending over
    ``context[group_ids[b]] ⊕ decode[b]``. Returns the layer's output
    (b, n, d) and writes the step's K/V into ``layer_cache`` IN PLACE.

    ``layer_cache``: {"k_ctx": (G, g, m_c, hd) "gmk" | (G, m_c, g, hd)
    "mgk", "v_ctx": ..., "k_dec": (b, C_d, g, hd), "v_dec": ...} — plus
    {"k_scale", "v_scale"} ((G, g, m_c) / (G, m_c, g)) when the context
    segments are int8.

    Positions, decode-cache write offsets and decode-slot masks are all PER
    SLOT (``ctx_lens[group_ids] + dec_lens``), computed on the device.
    Sliding-window configs are not supported, as in the reference.
    """
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "forest decoding does not support sliding-window configs")
    b, n = x.shape[:2]
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, params, x)
    pos_b = ctx_lens[group_ids.long()] + dec_lens                 # (b,)
    if cfg.rope_theta > 0:
        pos = pos_b[:, None] + torch.arange(n, device=dev)[None, :]  # (b, n)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    q = q.reshape(b, n, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,n,hd)

    k_dec = _scatter_decode_slots(layer_cache["k_dec"], k_new, dec_lens)
    v_dec = _scatter_decode_slots(layer_cache["v_dec"], v_new, dec_lens)
    cap = k_dec.shape[1]
    slot = torch.arange(cap, device=dev)[None, :]
    dec_valid = slot <= dec_lens[:, None] + n - 1                 # (b, C_d)

    k_ctx, v_ctx = layer_cache["k_ctx"], layer_cache["v_ctx"]
    layout = cfg.ctx_layout
    if "k_scale" in layer_cache:
        k_s, v_s = layer_cache["k_scale"], layer_cache["v_scale"]
        if impl == "kernel":
            o = grouped_bifurcated_decode_attention_q8(
                q, k_ctx, v_ctx, k_s, v_s, group_ids, ctx_lens, k_dec, v_dec,
                dec_valid, ctx_layout=layout)
        else:
            o = forest_bifurcated_attention_q8(
                q, k_ctx, v_ctx, k_s, v_s, group_ids, ctx_lens, k_dec, v_dec,
                decode_mask=dec_valid, ctx_layout=layout)
    elif impl == "kernel":
        o = grouped_bifurcated_decode_attention(
            q, k_ctx, v_ctx, group_ids, ctx_lens, k_dec, v_dec, dec_valid,
            ctx_layout=layout)
    else:
        o = forest_bifurcated_attention(
            q, k_ctx, v_ctx, group_ids, ctx_lens, k_dec, v_dec,
            decode_mask=dec_valid, ctx_layout=layout)

    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
    return o @ params["wo"].to(x.dtype)


def attention_decode_tree(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    layer_cache: dict,
    *,
    paths: torch.Tensor,       # (depth, b) int32 — slot -> node id per level
    node_lens: torch.Tensor,   # (N,) int32 — live (ragged) node lengths
    ctx_lens_b: torch.Tensor,  # (b,) int32 — per-slot TOTAL path context
    dec_lens: torch.Tensor,    # (b,) int32 — per-slot decode depth
    impl: str = "einsum",      # einsum (cascade reference) | kernel (CUDA)
) -> torch.Tensor:
    """One incremental-decoding step for one layer over a PREFIX TRIE: N
    node segments and b decode slots, each slot attending over the
    concatenation of the nodes on its ``paths`` column ⊕ its decode arm.
    Returns the layer's output (b, n, d) and writes the step's K/V into
    ``layer_cache`` IN PLACE.

    ``layer_cache``: {"k_ctx": (N, g, m_c, hd) "gmk" | (N, m_c, g, hd)
    "mgk", "v_ctx": ..., "k_dec": (b, C_d, g, hd), "v_dec": ...} — plus
    {"k_scale", "v_scale"} ((N, g, m_c) / (N, m_c, g)) when the nodes are
    int8.

    As ``attention_decode_forest``, except that the per-slot position base
    is the SUM of the path's node lengths (``ctx_lens_b``, computed once
    per step by the caller) and the dispatch is the tree kernel or the
    cascade einsum path. Sliding-window configs are not supported, as in
    the reference.
    """
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "tree decoding does not support sliding-window configs")
    b, n = x.shape[:2]
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, params, x)
    pos_b = ctx_lens_b + dec_lens                                # (b,)
    if cfg.rope_theta > 0:
        pos = pos_b[:, None] + torch.arange(n, device=dev)[None, :]  # (b, n)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    q = q.reshape(b, n, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,n,hd)

    k_dec = _scatter_decode_slots(layer_cache["k_dec"], k_new, dec_lens)
    v_dec = _scatter_decode_slots(layer_cache["v_dec"], v_new, dec_lens)
    cap = k_dec.shape[1]
    slot = torch.arange(cap, device=dev)[None, :]
    dec_valid = slot <= dec_lens[:, None] + n - 1                 # (b, C_d)

    k_ctx, v_ctx = layer_cache["k_ctx"], layer_cache["v_ctx"]
    layout = cfg.ctx_layout
    if "k_scale" in layer_cache:
        k_s, v_s = layer_cache["k_scale"], layer_cache["v_scale"]
        if impl == "kernel":
            o = tree_bifurcated_decode_attention_q8(
                q, k_ctx, v_ctx, k_s, v_s, paths, node_lens, k_dec, v_dec,
                dec_valid, ctx_layout=layout)
        else:
            o = tree_bifurcated_attention_q8(
                q, k_ctx, v_ctx, k_s, v_s, paths, node_lens, k_dec, v_dec,
                decode_mask=dec_valid, ctx_layout=layout)
    elif impl == "kernel":
        o = tree_bifurcated_decode_attention(
            q, k_ctx, v_ctx, paths, node_lens, k_dec, v_dec, dec_valid,
            ctx_layout=layout)
    else:
        o = tree_bifurcated_attention(
            q, k_ctx, v_ctx, paths, node_lens, k_dec, v_dec,
            decode_mask=dec_valid, ctx_layout=layout)

    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
    return o @ params["wo"].to(x.dtype)


def attention_decode_paged(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    layer_cache: dict,
    *,
    page_tables: torch.Tensor,  # (N, ppn) int32 — pool pages per segment
    seg_lens: torch.Tensor,     # (N,) int32 — live (ragged) segment lengths
    paths: torch.Tensor,        # (depth, b) int32 — slot -> segment/level
    ctx_lens_b: torch.Tensor,   # (b,) int32 — per-slot TOTAL path context
    dec_lens: torch.Tensor,     # (b,) int32 — per-slot decode depth
    impl: str = "kernel",       # kernel (paged CUDA kernel) | einsum (pages
                                #   gathered into dense slabs -> cascade)
) -> torch.Tensor:
    """One incremental-decoding step for one layer over a PAGED context
    store: the general form serving single-prefix (one segment, zero
    paths), forest (depth-1 paths) and trie workloads alike. Returns the
    layer's output (b, n, d) and writes the step's K/V into ``layer_cache``
    IN PLACE.

    ``layer_cache``: {"k_pages": (P, g, pm, hd), "v_pages": ...,
    "k_dec": (b, C_d, g, hd), "v_dec": ...} — plus {"k_scale_pages",
    "v_scale_pages"} ((P, g, pm) f32) when the pool is int8.

    ``impl="kernel"`` (the default: paging exists for the kernel) runs the
    paged CUDA kernel, which reads only live pages. ``impl="einsum"`` is
    the reference and oracle path: it gathers the pool into dense
    per-segment slabs (``gather_pages``) and runs the cascade einsum path
    on them, as the reference does. Sliding-window configs are not
    supported, as in the reference.
    """
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "paged decoding does not support sliding-window configs")
    b, n = x.shape[:2]
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, params, x)
    pos_b = ctx_lens_b + dec_lens                                # (b,)
    if cfg.rope_theta > 0:
        pos = pos_b[:, None] + torch.arange(n, device=dev)[None, :]  # (b, n)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    q = q.reshape(b, n, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,n,hd)

    k_dec = _scatter_decode_slots(layer_cache["k_dec"], k_new, dec_lens)
    v_dec = _scatter_decode_slots(layer_cache["v_dec"], v_new, dec_lens)
    cap = k_dec.shape[1]
    slot = torch.arange(cap, device=dev)[None, :]
    dec_valid = slot <= dec_lens[:, None] + n - 1                 # (b, C_d)

    k_pages, v_pages = layer_cache["k_pages"], layer_cache["v_pages"]
    if "k_scale_pages" in layer_cache:
        k_sp, v_sp = layer_cache["k_scale_pages"], layer_cache["v_scale_pages"]
        if impl == "kernel":
            o = paged_bifurcated_decode_attention_q8(
                q, k_pages, v_pages, k_sp, v_sp, page_tables, seg_lens,
                paths, k_dec, v_dec, dec_valid)
        else:
            o = tree_bifurcated_attention_q8(
                q, *(gather_pages(t, page_tables)
                     for t in (k_pages, v_pages, k_sp, v_sp)),
                paths, seg_lens, k_dec, v_dec, decode_mask=dec_valid,
                ctx_layout="gmk")
    elif impl == "kernel":
        o = paged_bifurcated_decode_attention(
            q, k_pages, v_pages, page_tables, seg_lens, paths, k_dec, v_dec,
            dec_valid)
    else:
        o = tree_bifurcated_attention(
            q, gather_pages(k_pages, page_tables),
            gather_pages(v_pages, page_tables), paths, seg_lens, k_dec,
            v_dec, decode_mask=dec_valid, ctx_layout="gmk")

    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
    return o @ params["wo"].to(x.dtype)


def attention_decode_packed(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,            # (b, n, d) — the decode tokens' hidden state
    x_chunk: torch.Tensor,      # (1, cp, d) — the prefill chunk's
    layer_cache: dict,
    *,
    page_tables: torch.Tensor,  # (N, ppn) int32
    seg_lens: torch.Tensor,     # (N,) int32
    paths: torch.Tensor,        # (depth, b) int32
    ctx_lens_b: torch.Tensor,   # (b,) int32
    dec_lens: torch.Tensor,     # (b,) int32
    buf_len: int,               # valid tokens already in the fresh envelope
    chunk_valid: int,           # live tokens of this chunk
    fresh_start: int,           # absolute position of envelope column 0
    fresh_pos: torch.Tensor,    # (cp,) int32 — per chunk row
    fresh_path: torch.Tensor,   # (depth,) int32 — the chunk's ancestors
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PACKED heterogeneous step for one layer over the paged store:
    the decode batch's attention AND one request's suffix-prefill chunk in
    a single launch of the packed kernel. ``layer_cache`` is the paged
    layer cache plus {"k_fresh", "v_fresh"}: the (F*pm, g, hd) fresh-KV
    envelope of the pending node, whose first ``buf_len`` rows hold its
    already-prefilled tokens. This chunk's rotated K/V are written into it
    at ``buf_len``, in place; the rows of a padded last chunk that would
    run past the envelope are not written (the reference's
    ``dynamic_update_slice`` would clamp the start and shift the valid
    rows instead; the port never moves a valid row). The chunk rows attend
    [their ancestors' pages ⊕ the envelope, causal]; the decode rows are
    untouched by them. The decode arms are written in place too. Returns
    (decode output (b, n, d), chunk output (1, cp, d))."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "packed decoding does not support sliding-window configs")
    b, n = x.shape[:2]
    cp = x_chunk.shape[1]
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    dev = x.device
    q, k_new, v_new = _project_qkv(cfg, params, x)
    pos_b = ctx_lens_b + dec_lens                                # (b,)
    qc, kc, vc = _project_qkv(cfg, params, x_chunk)
    chunk_pos = fresh_start + buf_len + torch.arange(cp, device=dev)
    if cfg.rope_theta > 0:
        pos = pos_b[:, None] + torch.arange(n, device=dev)[None, :]  # (b, n)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
        qc = apply_rope(qc, chunk_pos, cfg.rope_theta)
        kc = apply_rope(kc, chunk_pos, cfg.rope_theta)
    q = q.reshape(b, n, g, p, hd).permute(0, 2, 3, 1, 4)  # (b,g,p,n,hd)
    q_fresh = qc[0].reshape(cp, g, p, hd)

    k_buf, v_buf = layer_cache["k_fresh"], layer_cache["v_fresh"]
    fit = min(cp, k_buf.shape[0] - buf_len)
    k_buf[buf_len:buf_len + fit] = kc[0, :fit].to(k_buf.dtype)
    v_buf[buf_len:buf_len + fit] = vc[0, :fit].to(v_buf.dtype)

    k_dec = _scatter_decode_slots(layer_cache["k_dec"], k_new, dec_lens)
    v_dec = _scatter_decode_slots(layer_cache["v_dec"], v_new, dec_lens)
    cap = k_dec.shape[1]
    slot = torch.arange(cap, device=dev)[None, :]
    dec_valid = slot <= dec_lens[:, None] + n - 1                 # (b, C_d)

    fresh = dict(q_fresh=q_fresh, k_fresh=k_buf, v_fresh=v_buf,
                 fresh_len=buf_len + chunk_valid, fresh_start=fresh_start,
                 fresh_pos=fresh_pos, fresh_path=fresh_path)
    k_pages, v_pages = layer_cache["k_pages"], layer_cache["v_pages"]
    if "k_scale_pages" in layer_cache:
        o, o_chunk = packed_bifurcated_decode_attention_q8(
            q, k_pages, v_pages, layer_cache["k_scale_pages"],
            layer_cache["v_scale_pages"], page_tables, seg_lens, paths,
            k_dec, v_dec, dec_valid, **fresh)
    else:
        o, o_chunk = packed_bifurcated_decode_attention(
            q, k_pages, v_pages, page_tables, seg_lens, paths, k_dec, v_dec,
            dec_valid, **fresh)

    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
    oc = o_chunk.reshape(1, cp, cfg.n_heads_padded * hd)
    wo = params["wo"].to(x.dtype)
    return o @ wo, oc @ wo
