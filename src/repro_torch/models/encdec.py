"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed).

The frames are precomputed embeddings (b, n_frames, d), projected by
``frame_proj`` in place of the mel-spectrogram conv stem. Learned absolute
position embeddings on both stacks (rope_theta = 0), a tied unembedding,
layernorm and gelu.

Bifurcation applies twice during shared-prefix batch sampling:
  * decoder self-attention: the standard BifurcatedCache (or its int8
    twin), decoded by the fused kernels with ``impl="kernel"``;
  * cross-attention: the encoder memory's K/V are shared by every sample
    of one input, so they are stored unbatched, (L, m_enc, g, hd), and
    read once a step for all samples (``shared_cross_attention``).

The activation dtype is the weights' (the reference fixes bf16; with bf16
weights, the serving default, the two agree). Training (``train_logits``)
is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import decode_attention
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache
from repro_torch.core.quantized import QuantBifurcatedCache, ctx_cache_family
from repro_torch.models import blocks
from repro_torch.models.blocks import (
    apply_mlp,
    apply_norm,
    attention_decode,
    attention_train,
    init_attention,
    init_mlp,
    init_norm,
)
from repro_torch.models.transformer import _layer


def shared_cross_attention(cfg: ModelConfig, params, q: torch.Tensor,
                           k_mem: torch.Tensor,
                           v_mem: torch.Tensor) -> torch.Tensor:
    """Cross-attention against an *unbatched* shared encoder memory.

    q: (b, n, d) decoder hidden; k_mem/v_mem: (m_enc, g, hd). This is the
    context-only arm of bifurcated attention (paper Eq. 3-4 with m_d = 0).
    """
    h, g, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.kq_dim
    p = h // g
    b, n = q.shape[:2]
    dtype = q.dtype
    qh = (q @ params["wq"].to(dtype)).reshape(b, n, g, p, hd).permute(
        0, 2, 3, 1, 4)
    logits = torch.einsum("bgpnk,mgk->bgpnm", qh, k_mem).float() * hd**-0.5
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgpnm,mgv->bgpnv", w.to(v_mem.dtype), v_mem)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, n, h * hd)
    return o @ params["wo"].to(dtype)


class EncDecModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: not an encdec config (family "
                             f"{cfg.family!r})")
        self.cfg = cfg

    # ---- params ----
    def init(self, seed: int = 0, *, device="cuda", dtype=torch.bfloat16):
        """Seeded random weights of the reference's shapes and scale
        (matmul weights normal / sqrt(fan_in), position tables normal x
        0.01), each cast to ``dtype`` as drawn; norm params float32. Runs
        on ``device`` (CUDA unless the caller says "cpu")."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_model

        def positions(n):
            w = torch.randn((n, d), generator=gen, device=dev) * 0.01
            return w if dtype is None else w.to(dtype)

        def stack(n_layers, cross):
            layer = {"ln1": init_norm(cfg, (n_layers, d), dev),
                     "attn": init_attention(cfg, gen, n_layers, dtype)}
            if cross:
                layer["ln_x"] = init_norm(cfg, (n_layers, d), dev)
                layer["xattn"] = init_attention(cfg, gen, n_layers, dtype)
            layer["ln2"] = init_norm(cfg, (n_layers, d), dev)
            layer["mlp"] = init_mlp(cfg, gen, n_layers, dtype)
            return layer

        return {
            "frame_proj": blocks._dense_init(gen, (d, d), d, dtype),
            "enc_pos_embed": positions(cfg.max_enc_position),
            "enc_layers": stack(cfg.n_encoder_layers, cross=False),
            "enc_norm": init_norm(cfg, (d,), dev),
            "embed": blocks._dense_init(gen, (cfg.padded_vocab, d), d, dtype),
            "pos_embed": positions(cfg.max_position),
            "dec_layers": stack(cfg.n_layers, cross=True),
            "final_norm": init_norm(cfg, (d,), dev),
        }

    # ---- shared pieces ----
    def _embed(self, params, tokens, position: int):
        """Token embeddings plus the learned positions ``position``.."""
        y = params["embed"][tokens]
        n = tokens.shape[1]
        return y + params["pos_embed"][position:position + n].to(y.dtype)

    def _unembed(self, params, x):
        return blocks.unembed(self.cfg, params, x)   # tied: the embedding

    def _mlp(self, layer, y):
        return y + apply_mlp(self.cfg, layer["mlp"],
                             apply_norm(self.cfg, layer["ln2"], y))

    def encode(self, params, frames):
        """frames (b, n, d) -> the encoder memory (b, n, d): non-causal
        self-attention layers over the projected frames."""
        cfg = self.cfg
        dtype = params["frame_proj"].dtype
        n = frames.shape[1]
        x = frames.to(dtype) @ params["frame_proj"]
        x = x + params["enc_pos_embed"][:n].to(dtype)
        for i in range(cfg.n_encoder_layers):
            layer = _layer(params["enc_layers"], i)
            x = x + attention_train(cfg, layer["attn"],
                                    apply_norm(cfg, layer["ln1"], x),
                                    causal=False)
            x = self._mlp(layer, x)
        return apply_norm(cfg, params["enc_norm"], x)

    # ---- serving ----
    def prefill(self, params, tokens, frames=None, capacity=None,
                bifurcated=False, dec_capacity=None, sample_batch=None,
                ctx_quant: str = "none"):
        """Encode ``frames``, compute the cross K/V once, then
        teacher-force the decoder prompt ``tokens`` (b, n).

        Returns (last-position logits (b, V), cache): {"self": the decoder
        self-attention cache, "cross_k", "cross_v"}. Bifurcated: the self
        cache is ``ctx_cache_family(ctx_quant)`` built from sample 0's
        context with ``sample_batch`` (default b) decode arms, and the
        cross K/V are sample 0's, unbatched (L, m_enc, g, hd). Standard: a
        DecodeCache of ``capacity`` slots (default n + dec_capacity) and
        the cross K/V (L, b, m_enc, g, hd)."""
        cfg = self.cfg
        b, n = tokens.shape
        memory = self.encode(params, frames)
        y = self._embed(params, tokens, 0)
        ks, vs, xks, xvs = [], [], [], []
        for i in range(cfg.n_layers):
            layer = _layer(params["dec_layers"], i)
            h = apply_norm(cfg, layer["ln1"], y)
            k, v = blocks.attention_prefill_kv(cfg, layer["attn"], h)
            ks.append(k)
            vs.append(v)
            y = y + attention_train(cfg, layer["attn"], h, causal=True)
            hx = apply_norm(cfg, layer["ln_x"], y)
            xk, xv = blocks.attention_prefill_kv(cfg, layer["xattn"], memory)
            xks.append(xk)
            xvs.append(xv)
            y = y + attention_train(cfg, layer["xattn"], hx, causal=False,
                                    x_kv=memory)
            y = self._mlp(layer, y)
        y = apply_norm(cfg, params["final_norm"], y)
        logits = self._unembed(params, y[:, -1:])[:, 0]

        dec_capacity = dec_capacity or cfg.decode_capacity
        capacity = capacity or (n + dec_capacity)
        ks, vs = torch.stack(ks), torch.stack(vs)        # (L, b, n, g, hd)
        xks, xvs = torch.stack(xks), torch.stack(xvs)    # (L, b, m_enc, g, hd)
        if bifurcated:
            self_cache = ctx_cache_family(ctx_quant).from_prefill(
                ks[:, 0], vs[:, 0], sample_batch or b, dec_capacity,
                dtype=ks.dtype, ctx_layout=cfg.ctx_layout)
            return logits, {"self": self_cache, "cross_k": xks[:, 0],
                            "cross_v": xvs[:, 0]}
        shape = (cfg.n_layers, b, capacity, *ks.shape[3:])
        k, v = ks.new_zeros(shape), vs.new_zeros(shape)
        k[:, :, :n] = ks
        v[:, :, :n] = vs
        return logits, {"self": DecodeCache(k=k, v=v, length=n),
                        "cross_k": xks, "cross_v": xvs}

    def decode_step(self, params, cache, tokens, *, impl: str = "einsum"):
        """tokens: (b, n). Returns (logits (b, n, V), cache'): the decoder
        self-attention's new K/V are written in place (``impl="kernel"``
        and a bifurcated cache: one launch of the fused decode kernel per
        layer, int8 context: its q8 twin); the cross K/V are read only."""
        cfg = self.cfg
        self_cache = cache["self"]
        if isinstance(self_cache, (BifurcatedCache, QuantBifurcatedCache)):
            bifurcated = True
            position = self_cache.context_len + self_cache.dec_length
            names = ("k_ctx", "v_ctx", "k_dec", "v_dec")
            if isinstance(self_cache, QuantBifurcatedCache):
                names += ("k_scale", "v_scale")
        elif isinstance(self_cache, DecodeCache):
            bifurcated = False
            position = self_cache.length
            names = ("k", "v")
        else:
            raise TypeError(f"unsupported cache {type(self_cache).__name__}")
        b, n = tokens.shape
        g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
        p = cfg.n_heads_padded // g
        y = self._embed(params, tokens, position)
        for i in range(cfg.n_layers):
            layer = _layer(params["dec_layers"], i)
            lc = {name: getattr(self_cache, name)[i] for name in names}
            xk, xv = cache["cross_k"][i], cache["cross_v"][i]
            h = apply_norm(cfg, layer["ln1"], y)
            y = y + attention_decode(cfg, layer["attn"], h, lc,
                                     position=position, bifurcated=bifurcated,
                                     impl=impl)
            hx = apply_norm(cfg, layer["ln_x"], y)
            if bifurcated:  # shared (unbatched) encoder memory: one read
                y = y + shared_cross_attention(cfg, layer["xattn"], hx, xk, xv)
            else:
                dtype = hx.dtype
                qh = (hx @ layer["xattn"]["wq"].to(dtype)).reshape(
                    b, n, g, p, hd).permute(0, 2, 3, 1, 4)
                valid = torch.ones((b, xk.shape[1]), dtype=torch.bool,
                                   device=y.device)
                o = decode_attention(qh, xk, xv, valid_mask=valid)
                o = o.permute(0, 3, 1, 2, 4).reshape(b, n, cfg.n_heads_padded * hd)
                y = y + o @ layer["xattn"]["wo"].to(dtype)
            y = self._mlp(layer, y)
        y = apply_norm(cfg, params["final_norm"], y)
        logits = self._unembed(params, y)
        if bifurcated:  # only the decode arm advances
            self_cache = dataclasses.replace(
                self_cache, dec_length=self_cache.dec_length + n)
        else:
            self_cache = dataclasses.replace(self_cache,
                                             length=self_cache.length + n)
        return logits, {"self": self_cache, "cross_k": cache["cross_k"],
                        "cross_v": cache["cross_v"]}
