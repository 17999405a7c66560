"""Zamba2-style hybrid: Mamba2 backbone + one globally-shared attention block.

Layout: ``n_super`` super-blocks of (``attn_period`` mamba layers + one
application of THE shared attention+MLP block), plus trailing mamba layers.
zamba2-7b: 81 mamba layers = 13 x 6 + 3, shared block applied 13 times.
The shared block's weights are a single set reused at every application
(Zamba's parameter-sharing trick); its KV caches are per-application (13
cache entries), and bifurcated attention applies to each application during
shared-prefix batch decoding.

The port's serving path: ``prefill`` runs every Mamba2 layer through kernel
#13 (one launch each, keeping its final state) and the shared block's
attention through the dense family's prefill attention; ``decode_step``
runs the Mamba2 recurrences in place on the cache's states and each shared
application through ``blocks.attention_decode`` (``impl="kernel"`` and a
bifurcated cache: one launch of the fused decode kernel, int8 context: its
q8 twin). The activation dtype is the embedding table's (the reference
fixes bf16; with bf16 weights, the serving default, the two agree).
Training (``train_logits``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import cast_weights
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
from repro_torch.models.mamba import (
    apply_mamba_decode,
    apply_mamba_prefill,
    init_mamba_layer,
)
from repro_torch.models.transformer import _layer


class HybridModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "hybrid" or cfg.attn_period <= 0 or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: not a hybrid config (family "
                             f"{cfg.family!r}, attn_period {cfg.attn_period})")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_period  # shared-attn applications
        self.n_tail = cfg.n_layers - self.n_super * cfg.attn_period

    # ---- params ----
    def init(self, seed: int = 0, *, device="cuda", dtype=torch.bfloat16):
        """Seeded random weights of the reference's shapes and scale;
        matmul weights in ``dtype``, the leaves the reference applies in
        float32 kept so. Runs on ``device`` (CUDA unless the caller says
        "cpu")."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, period = cfg.d_model, cfg.attn_period

        def one(tree):   # the unstacked shared block
            return {k: v[0] for k, v in tree.items()}

        def regroup(tree):  # (n_super * period, ...) -> (n_super, period, ...)
            return {k: (regroup(v) if isinstance(v, dict) else
                        v.reshape(self.n_super, period, *v.shape[1:]))
                    for k, v in tree.items()}

        params = {
            "embed": blocks._dense_init(gen, (cfg.padded_vocab, d), d).to(dtype),
            "mamba": regroup(init_mamba_layer(cfg, gen, self.n_super * period,
                                              dtype)),
            "shared_attn": {
                "ln1": init_norm(cfg, (d,), dev),
                "attn": one(init_attention(cfg, gen, 1)),
                "ln2": init_norm(cfg, (d,), dev),
                "mlp": one(init_mlp(cfg, gen, 1)),
            },
            "final_norm": init_norm(cfg, (d,), dev),
        }
        if self.n_tail:
            params["mamba_tail"] = init_mamba_layer(cfg, gen, self.n_tail, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = blocks._dense_init(
                gen, (cfg.padded_vocab, d), d).to(dtype)
        return cast_weights(params, dtype)

    # ---- shared pieces ----
    def _mamba_layers(self, params):
        """(Mamba2 layer index, its params) for every Mamba2 layer in order,
        and (application index, None) where the shared block applies."""
        cfg = self.cfg
        li = 0
        for sb in range(self.n_super):
            group = _layer(params["mamba"], sb)
            for i in range(cfg.attn_period):
                yield li, _layer(group, i)
                li += 1
            yield sb, None
        for i in range(self.n_tail):
            yield li, _layer(params["mamba_tail"], i)
            li += 1

    def _shared_mlp(self, sbp, x):
        return x + apply_mlp(self.cfg, sbp["mlp"],
                             apply_norm(self.cfg, sbp["ln2"], x))

    # ---- serving ----
    def prefill(self, params, tokens, *, capacity=None, dec_capacity=None,
                bifurcated=False, ctx_quant: str = "none"):
        """Mamba2 states through kernel #13 (its returned final state), the
        shared block's K/V computed in full and packed into the serve cache.

        Returns (last-position logits (b, V), cache): ``cache`` is
        {"attn": the shared block's cache over its n_super applications
        (bifurcated: ``ctx_cache_family(ctx_quant)`` from sample 0's
        context, as the reference builds it; else a DecodeCache of
        ``capacity`` slots), "mamba": {"ssm": (L, b, nh, state, hd) fp32,
        "conv": (L, b, width - 1, ch) bf16}, "position": n}."""
        cfg = self.cfg
        b, n = tokens.shape
        dec_capacity = dec_capacity or cfg.decode_capacity
        capacity = capacity or (n + dec_capacity)
        x = params["embed"][tokens]
        positions = torch.arange(n, device=x.device)
        sbp = params["shared_attn"]
        states, ks, vs = [], [], []
        for _, lp in self._mamba_layers(params):
            if lp is not None:
                x, S, conv = apply_mamba_prefill(cfg, lp, x)
                states.append((S, conv))
                continue
            h = apply_norm(cfg, sbp["ln1"], x)
            k, v = blocks.attention_prefill_kv(cfg, sbp["attn"], h, positions)
            ks.append(k)
            vs.append(v)
            x = x + attention_train(cfg, sbp["attn"], h, positions)
            x = self._shared_mlp(sbp, x)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = blocks.unembed(cfg, params, x[:, -1:])[:, 0]

        mamba = {"ssm": torch.stack([s for s, _ in states]),
                 "conv": torch.stack([c for _, c in states])}
        ks, vs = torch.stack(ks), torch.stack(vs)   # (n_super, b, n, g, hd)
        if bifurcated:
            m_c = capacity - dec_capacity
            attn = ctx_cache_family(ctx_quant).from_prefill(
                ks[:, 0, :m_c], vs[:, 0, :m_c], b, dec_capacity,
                dtype=ks.dtype, ctx_layout=cfg.ctx_layout)
        else:
            shape = (self.n_super, b, capacity, *ks.shape[3:])
            k, v = ks.new_zeros(shape), vs.new_zeros(shape)
            k[:, :, :n] = ks
            v[:, :, :n] = vs
            attn = DecodeCache(k=k, v=v, length=n)
        return logits, {"attn": attn, "mamba": mamba, "position": n}

    def decode_step(self, params, cache, tokens, *, impl: str = "einsum"):
        """tokens: (b, 1). Returns (logits (b, 1, V), cache'): the Mamba2
        states and the decode arm (standard cache: the token's slot) are
        written in place; cache' shares every tensor with ``cache``."""
        cfg = self.cfg
        attn = cache["attn"]
        if isinstance(attn, (BifurcatedCache, QuantBifurcatedCache)):
            bifurcated = True
            attn_pos = attn.context_len + attn.dec_length
            names = ("k_ctx", "v_ctx", "k_dec", "v_dec")
            if isinstance(attn, QuantBifurcatedCache):
                names += ("k_scale", "v_scale")
        elif isinstance(attn, DecodeCache):
            bifurcated = False
            attn_pos = attn.length
            names = ("k", "v")
        else:
            raise TypeError(f"unsupported cache {type(attn).__name__}")
        mamba = cache["mamba"]
        sbp = params["shared_attn"]
        x = params["embed"][tokens]
        for idx, lp in self._mamba_layers(params):
            if lp is not None:      # idx: the Mamba2 layer
                x, _ = apply_mamba_decode(cfg, lp, x, {
                    "ssm": mamba["ssm"][idx], "conv": mamba["conv"][idx]})
                continue
            lc = {name: getattr(attn, name)[idx] for name in names}  # idx: sb
            h = apply_norm(cfg, sbp["ln1"], x)
            x = x + attention_decode(cfg, sbp["attn"], h, lc,
                                     position=attn_pos, bifurcated=bifurcated,
                                     impl=impl)
            x = self._shared_mlp(sbp, x)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = blocks.unembed(cfg, params, x)
        n = tokens.shape[1]
        if bifurcated:  # only the decode arm advances
            attn = dataclasses.replace(attn, dec_length=attn.dec_length + n)
        else:
            attn = dataclasses.replace(attn, length=attn.length + n)
        return logits, {"attn": attn, "mamba": mamba,
                        "position": cache["position"] + n}
