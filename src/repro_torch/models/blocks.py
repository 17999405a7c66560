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
)
from repro_torch.core.kv_cache import update_layer_cache
from repro_torch.core.masks import mask_to_bias
from repro_torch.core.quantized import (
    bifurcated_attention_q8,
    forest_bifurcated_attention_q8,
)
from repro_torch.core.rotary import apply_rope
from repro_torch.kernels.ops import (
    bifurcated_decode_attention,
    bifurcated_decode_attention_q8,
    grouped_bifurcated_decode_attention,
    grouped_bifurcated_decode_attention_q8,
)


def _dense_init(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """Scaled-normal init (1/sqrt(fan_in)), float32."""
    return torch.randn(shape, generator=gen, device=gen.device) / fan_in**0.5


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


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, n_layers: int):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi_gate": _dense_init(gen, (n_layers, d, f), d),
            "wi_up": _dense_init(gen, (n_layers, d, f), d),
            "w_down": _dense_init(gen, (n_layers, f, d), f),
        }
    return {"wi": _dense_init(gen, (n_layers, d, f), d),
            "w_down": _dense_init(gen, (n_layers, f, d), f)}


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

def init_attention(cfg: ModelConfig, gen: torch.Generator, n_layers: int):
    d, hd = cfg.d_model, cfg.kq_dim
    h, g = cfg.n_heads_padded, cfg.n_kv_heads_padded
    p = {
        "wq": _dense_init(gen, (n_layers, d, h * hd), d),
        "wk": _dense_init(gen, (n_layers, d, g * hd), d),
        "wv": _dense_init(gen, (n_layers, d, g * hd), d),
        "wo": _dense_init(gen, (n_layers, h * hd, d), h * hd),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", g * hd), ("bv", g * hd)):
            p[name] = torch.zeros((n_layers, width), dtype=torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(cfg: ModelConfig, params, x):
    """x: (b, n, d) -> q (b, n, h, hd), k/v (b, n, g, hd)."""
    dtype = x.dtype
    h, g, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.kq_dim
    q = x @ params["wq"].to(dtype)
    k = x @ params["wk"].to(dtype)
    v = x @ params["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    b, n = q.shape[:2]
    return q.reshape(b, n, h, hd), k.reshape(b, n, g, hd), v.reshape(b, n, g, hd)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: Optional[int] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Memory-bounded causal attention (optionally sliding-window): a loop
    over query chunks.

    q: (b, n, h, hd); k, v: (b, m, g, hd) with h = g * p — the kv tensors are
    broadcast over the group dimension inside the einsum (no materialized
    repeat). Logits for one chunk are (b, h, chunk, m), so the peak
    activation is n/chunk times smaller than the full logits tensor.
    """
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
        q_pos = start + torch.arange(c, device=q.device)[:, None]
        mask = k_pos <= q_pos
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        logits = logits + mask_to_bias(mask)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgpcm,bmgk->bgpck", w.to(v.dtype), v)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd))
    return torch.cat(outs, dim=1)


def attention_train(cfg: ModelConfig, params, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention (prefill)."""
    if cfg.train_attn != "chunked":
        raise NotImplementedError(f"train_attn={cfg.train_attn!r} is not ported")
    q, k, v = _project_qkv(cfg, params, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, window=cfg.sliding_window)
    b, n = o.shape[:2]
    o = o.reshape(b, n, cfg.n_heads_padded * cfg.kq_dim)
    return o @ params["wo"].to(x.dtype)


def attention_prefill_kv(cfg: ModelConfig, params, x: torch.Tensor,
                         positions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return the rotated K/V tensors that prefill writes into the cache."""
    _, k, v = _project_qkv(cfg, params, x)
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


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
