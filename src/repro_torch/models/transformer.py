"""Decoder-only transformer LM, dense family.

Parameters are a plain dict whose layer weights are stacked (L, ...) as in
the reference (``params["layers"]``); the forward passes loop over layers
in Python and hand each one its slice. The decode path takes the standard
batched KV cache or the paper's ``BifurcatedCache`` — the cache TYPE
selects the path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import cast_weights
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache
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


def _layer(layers, i: int):
    """Layer ``i``'s slice of the stacked (L, ...) layer params."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported; only 'dense' is")
        self.cfg = cfg

    # ---- params ----
    def init(self, seed: int = 0, *, device="cuda", dtype=torch.bfloat16):
        """Seeded random weights of the reference's shapes and scale
        (normal / sqrt(fan_in)); matmul weights in ``dtype``, norm params in
        float32. Runs on ``device`` (CUDA unless the caller says "cpu")."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        L, d = cfg.n_layers, cfg.d_model
        params = {
            "embed": blocks._dense_init(gen, (cfg.padded_vocab, d), d),
            "layers": {
                "ln1": init_norm(cfg, (L, d), dev),
                "attn": init_attention(cfg, gen, L),
                "ln2": init_norm(cfg, (L, d), dev),
                "mlp": init_mlp(cfg, gen, L),
            },
            "final_norm": init_norm(cfg, (d,), dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = blocks._dense_init(gen, (cfg.padded_vocab, d), d)
        return cast_weights(params, dtype)

    # ---- shared pieces ----
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(torch.bfloat16)

    def _unembed(self, params, x):
        cfg = self.cfg
        table = params.get("lm_head", params["embed"])
        logits = x @ table.T.to(x.dtype)
        if cfg.padded_vocab > cfg.vocab_size:
            pad_bias = torch.where(
                torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size,
                0.0, -1e30).to(logits.dtype)
            logits = logits + pad_bias
        return logits

    # ---- prefill (batched, standard cache out) ----
    def prefill(self, params, tokens):
        """Returns (last-position logits (b, V), DecodeCache holding the
        context's rotated K/V, (L, b, m, g, hd))."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            h = apply_norm(cfg, layer["ln1"], x)
            k, v = blocks.attention_prefill_kv(cfg, layer["attn"], h, positions)
            ks.append(k)
            vs.append(v)
            x = x + attention_train(cfg, layer["attn"], h, positions)
            x = x + apply_mlp(cfg, layer["mlp"], apply_norm(cfg, layer["ln2"], x))
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x[:, -1:])[:, 0]
        cache = DecodeCache(k=torch.stack(ks), v=torch.stack(vs),
                            length=x.shape[1])
        return logits, cache

    # ---- decode ----
    def decode_step(self, params, cache, tokens, *, impl: str = "einsum"):
        """tokens: (b, n) new token ids. Returns (logits (b, n, V), cache')
        where cache' shares the input cache's tensors, updated in place."""
        cfg = self.cfg
        if isinstance(cache, BifurcatedCache):
            bifurcated = True
            position = cache.context_len + cache.dec_length
            names = ("k_ctx", "v_ctx", "k_dec", "v_dec")
        elif isinstance(cache, DecodeCache):
            bifurcated = False
            position = cache.length
            names = ("k", "v")
        else:
            raise TypeError(f"unsupported cache {type(cache).__name__}")
        x = self._embed(params, tokens)
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            lcache = {name: getattr(cache, name)[i] for name in names}
            h = apply_norm(cfg, layer["ln1"], x)
            x = x + attention_decode(cfg, layer["attn"], h, lcache,
                                     position=position, bifurcated=bifurcated,
                                     impl=impl)
            x = x + apply_mlp(cfg, layer["mlp"], apply_norm(cfg, layer["ln2"], x))
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x)
        n = tokens.shape[1]
        if bifurcated:  # only the decode arm advances
            return logits, dataclasses.replace(
                cache, dec_length=cache.dec_length + n)
        return logits, dataclasses.replace(cache, length=cache.length + n)
