"""Decoder-only transformer LM covering the dense / moe / vlm families.

Parameters are a plain dict whose layer weights are stacked (L, ...) as in
the reference (``params["layers"]``); the forward passes loop over layers
in Python and hand each one its slice. The decode path takes the standard
batched KV cache, the paper's ``BifurcatedCache`` or its int8 twin
``QuantBifurcatedCache``, a forest cache (``GroupedBifurcatedCache`` /
``GroupedQuantBifurcatedCache``), a trie cache (``PrefixTreeCache`` /
``QuantPrefixTreeCache``) or one of the paged families over a page pool
(``core/paged.PAGED_CACHE_FAMILIES``) — the cache TYPE selects the path.
``prefill_suffix`` prefills a suffix over a cached prefix's K/V, and
``decode_step_packed`` runs a decode step of a paged trie cache and one
suffix-prefill chunk through the same launches.

A mixture-of-experts config (``cfg.moe``: dbrx, mixtral) replaces each
layer's MLP by ``models/moe.py``: ``apply_moe`` (capacity-bounded
dispatch) in the prefills, ``moe_decode`` in every decode step, the packed
step's chunk rows included, as in the reference. The VLM family
(internvl2) prepends the projected patch embeddings of a stub vision
frontend (``img_proj``) to the text: they become part of the shared
context, covered by bifurcated attention like any other context token.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import (
    BifurcatedCache,
    DecodeCache,
    GroupedBifurcatedCache,
    PrefixTreeCache,
)
from repro_torch.core.paged import PAGED_CACHE_FAMILIES, PagedPrefixTreeCache
from repro_torch.core.quantized import (
    GroupedQuantBifurcatedCache,
    QuantBifurcatedCache,
    QuantPrefixTreeCache,
    forest_cache_family,
    tree_cache_family,
)
from repro_torch.models import blocks
from repro_torch.models.blocks import (
    apply_mlp,
    apply_norm,
    attention_decode,
    attention_decode_forest,
    attention_decode_paged,
    attention_decode_tree,
    attention_train,
    init_attention,
    init_mlp,
    init_norm,
)
from repro_torch.models.moe import apply_moe, init_moe, moe_decode


def _layer(layers, i: int):
    """Layer ``i``'s slice of the stacked (L, ...) layer params."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM serves the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        self.cfg = cfg

    # ---- params ----
    def init(self, seed: int = 0, *, device="cuda", dtype=torch.bfloat16):
        """Seeded random weights of the reference's shapes and scale
        (normal / sqrt(fan_in)); matmul weights in ``dtype``, norm params
        and the MoE router in float32. Each leaf is cast as soon as it is
        drawn (an expert leaf one layer at a time), so the fp32 peak is one
        leaf. Runs on ``device`` (CUDA unless the caller says "cpu")."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        L, d = cfg.n_layers, cfg.d_model
        # drawn in the order embed, attention, MLP or MoE, lm_head, img_proj
        params = {"embed": blocks._dense_init(gen, (cfg.padded_vocab, d), d,
                                              dtype)}
        layers = {"ln1": init_norm(cfg, (L, d), dev),
                  "attn": init_attention(cfg, gen, L, dtype),
                  "ln2": init_norm(cfg, (L, d), dev)}
        if cfg.moe is not None:
            layers["moe"] = init_moe(cfg, gen, L, dtype)
        else:
            layers["mlp"] = init_mlp(cfg, gen, L, dtype)
        params["layers"] = layers
        params["final_norm"] = init_norm(cfg, (d,), dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = blocks._dense_init(
                gen, (cfg.padded_vocab, d), d, dtype)
        if cfg.family == "vlm":
            # stub frontend: one projection standing in for InternViT's
            # mlp1 connector (patch embeddings are precomputed inputs)
            params["img_proj"] = blocks._dense_init(gen, (d, d), d, dtype)
        return params

    # ---- shared pieces ----
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(torch.bfloat16)

    def _unembed(self, params, x):
        return blocks.unembed(self.cfg, params, x)

    def _ffn(self, layer, x, *, decode: bool):
        """The layer's feed-forward increment on residual ``x``: the MLP,
        or the MoE (``moe_decode`` in decode steps, ``apply_moe`` with its
        capacity drops in prefills)."""
        cfg = self.cfg
        h = apply_norm(cfg, layer["ln2"], x)
        if cfg.moe is None:
            return apply_mlp(cfg, layer["mlp"], h)
        if decode:
            return moe_decode(cfg, layer["moe"], h)
        return apply_moe(cfg, layer["moe"], h)[0]

    # ---- prefill (batched, standard cache out) ----
    def prefill(self, params, tokens, patch_embeds=None):
        """Returns (last-position logits (b, V), DecodeCache holding the
        context's rotated K/V, (L, b, m, g, hd)). VLM: ``patch_embeds``
        (b, n_img, d), projected by ``img_proj``, come before the text, so
        m = n_img + the text's length."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if cfg.family == "vlm" and patch_embeds is not None:
            img = patch_embeds.to(x.dtype) @ params["img_proj"].to(x.dtype)
            x = torch.cat([img, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            h = apply_norm(cfg, layer["ln1"], x)
            k, v = blocks.attention_prefill_kv(cfg, layer["attn"], h, positions)
            ks.append(k)
            vs.append(v)
            x = x + attention_train(cfg, layer["attn"], h, positions)
            x = x + self._ffn(layer, x, decode=False)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x[:, -1:])[:, 0]
        cache = DecodeCache(k=torch.stack(ks), v=torch.stack(vs),
                            length=x.shape[1])
        return logits, cache

    def prefill_suffix(self, params, tokens, k_anc, v_anc, *, start: int):
        """Suffix-only prefill: ``tokens`` (b, n) continue a cached prefix
        of ``start`` tokens whose per-layer rotated K/V ``k_anc``/``v_anc``
        (L, b, start, g, hd), what ``prefill`` would have stacked, are fed
        as the context of each layer's attention. Only the n suffix tokens
        are embedded, projected and attended; the cached prefix is read,
        never recomputed.

        Returns (last-position logits (b, V), DecodeCache over the SUFFIX
        only: k/v (L, b, n, g, hd) at absolute positions
        start..start+n-1, ``length`` start + n)."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"prefill_suffix supports dense/moe families, "
                             f"not {cfg.family!r}")
        x = self._embed(params, tokens)
        positions = start + torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            h = apply_norm(cfg, layer["ln1"], x)
            a, k, v = blocks.attention_prefill_suffix(
                cfg, layer["attn"], h, k_anc[i], v_anc[i],
                positions=positions)
            ks.append(k)
            vs.append(v)
            x = x + a
            x = x + self._ffn(layer, x, decode=False)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x[:, -1:])[:, 0]
        cache = DecodeCache(k=torch.stack(ks), v=torch.stack(vs),
                            length=start + x.shape[1])
        return logits, cache

    # ---- decode ----
    def decode_step(self, params, cache, tokens, *, impl: str = "einsum"):
        """tokens: (b, n) new token ids. Returns (logits (b, n, V), cache')
        where cache' shares the input cache's tensors, updated in place."""
        cfg = self.cfg
        if isinstance(cache, PAGED_CACHE_FAMILIES):
            return self._decode_step_paged(params, cache, tokens, impl=impl)
        if isinstance(cache, (PrefixTreeCache, QuantPrefixTreeCache)):
            return self._decode_step_tree(params, cache, tokens, impl=impl)
        if isinstance(cache, (GroupedBifurcatedCache,
                              GroupedQuantBifurcatedCache)):
            return self._decode_step_forest(params, cache, tokens, impl=impl)
        if isinstance(cache, (BifurcatedCache, QuantBifurcatedCache)):
            bifurcated = True
            position = cache.context_len + cache.dec_length
            names = ("k_ctx", "v_ctx", "k_dec", "v_dec")
            if isinstance(cache, QuantBifurcatedCache):
                names += ("k_scale", "v_scale")
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
            x = x + self._ffn(layer, x, decode=True)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x)
        n = tokens.shape[1]
        if bifurcated:  # only the decode arm advances
            return logits, dataclasses.replace(
                cache, dec_length=cache.dec_length + n)
        return logits, dataclasses.replace(cache, length=cache.length + n)

    def _decode_step_forest(self, params, cache, tokens, *, impl: str):
        """Grouped-cache decode: b slots over G prefix segments, per-slot
        positions and depths. The slot table (group_ids / ctx_lens /
        dec_lens) has no layer axis and is handed to every layer;
        ``impl="kernel"`` runs every layer-step as one launch of the
        grouped CUDA kernel. The decode arms and ``dec_lens`` advance in
        place, with no host sync; the returned cache is ``cache``."""
        cfg = self.cfg
        names = ["k_ctx", "v_ctx", "k_dec", "v_dec"]
        if isinstance(cache, GroupedQuantBifurcatedCache):
            names += ["k_scale", "v_scale"]
        x = self._embed(params, tokens)
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            lcache = {name: getattr(cache, name)[i] for name in names}
            h = apply_norm(cfg, layer["ln1"], x)
            x = x + attention_decode_forest(
                cfg, layer["attn"], h, lcache, group_ids=cache.group_ids,
                ctx_lens=cache.ctx_lens, dec_lens=cache.dec_lens, impl=impl)
            x = x + self._ffn(layer, x, decode=True)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x)
        cache.dec_lens.add_(tokens.shape[1])
        return logits, cache

    def _decode_step_tree(self, params, cache, tokens, *, impl: str):
        """Prefix-trie decode: b slots over N node segments, each slot
        attending over the concatenation of the nodes on its path. The trie
        state (paths / node_lens / dec_lens and the per-slot total context
        length) has no layer axis and is handed to every layer;
        ``impl="kernel"`` runs every layer-step as one launch of the tree
        CUDA kernel. The decode arms and ``dec_lens`` advance in place,
        with no host sync; the returned cache is ``cache``."""
        cfg = self.cfg
        names = ["k_ctx", "v_ctx", "k_dec", "v_dec"]
        if isinstance(cache, QuantPrefixTreeCache):
            names += ["k_scale", "v_scale"]
        ctx_lens_b = cache.slot_context_lens()      # (b,), once per step
        x = self._embed(params, tokens)
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            lcache = {name: getattr(cache, name)[i] for name in names}
            h = apply_norm(cfg, layer["ln1"], x)
            x = x + attention_decode_tree(
                cfg, layer["attn"], h, lcache, paths=cache.paths,
                node_lens=cache.node_lens, ctx_lens_b=ctx_lens_b,
                dec_lens=cache.dec_lens, impl=impl)
            x = x + self._ffn(layer, x, decode=True)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x)
        cache.dec_lens.add_(tokens.shape[1])
        return logits, cache

    def _decode_step_paged(self, params, cache, tokens, *, impl: str):
        """Paged-store decode: b slots over a shared page POOL addressed
        through per-segment page tables — one step for the three paged
        families (single / forest / trie), which differ only in their
        adapter views ``slot_paths`` / ``slot_dec_lens`` /
        ``slot_context_lens``. The tables, lengths and paths have no layer
        axis and are handed to every layer; ``impl="kernel"`` runs every
        layer-step as one launch of the paged CUDA kernel (only live pages
        read), ``impl="einsum"`` gathers dense slabs and runs the cascade
        einsum path. The decode arms are written in place; the returned
        cache is ``cache.advance_decode(n)``."""
        cfg = self.cfg
        store = cache.store
        names = {"k_pages": store.k_pages, "v_pages": store.v_pages,
                 "k_dec": cache.k_dec, "v_dec": cache.v_dec}
        if hasattr(store, "k_scale_pages"):
            names.update(k_scale_pages=store.k_scale_pages,
                         v_scale_pages=store.v_scale_pages)
        paths = cache.slot_paths()                  # (depth, b)
        dec_lens = cache.slot_dec_lens()            # (b,)
        ctx_lens_b = cache.slot_context_lens()      # (b,), once per step
        x = self._embed(params, tokens)
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            lcache = {name: t[i] for name, t in names.items()}
            h = apply_norm(cfg, layer["ln1"], x)
            x = x + attention_decode_paged(
                cfg, layer["attn"], h, lcache, page_tables=store.page_tables,
                seg_lens=store.seg_lens, paths=paths, ctx_lens_b=ctx_lens_b,
                dec_lens=dec_lens, impl=impl)
            x = x + self._ffn(layer, x, decode=True)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = self._unembed(params, x)
        return logits, cache.advance_decode(tokens.shape[1])

    def decode_step_packed(self, params, cache, tokens, chunk_tokens, *,
                           k_fresh, v_fresh, buf_len: int, chunk_valid: int,
                           fresh_start: int, fresh_pos, fresh_path):
        """One PACKED heterogeneous step over a paged trie cache: the decode
        batch (``tokens`` (b, 1)) and ONE request's suffix-prefill chunk
        (``chunk_tokens`` (1, cp)) through every layer, each layer-step one
        launch of the packed kernel (``blocks.attention_decode_packed``).

        ``k_fresh``/``v_fresh``: the per-layer (L, F*pm, g, hd) fresh-KV
        envelopes of the pending node (its already-prefilled tokens in
        ``[:buf_len]``); the chunk's rotated K/V are written into them at
        ``buf_len``, in place, as the decode arms are. ``buf_len``,
        ``chunk_valid`` and ``fresh_start`` are host ints; ``fresh_pos``
        (cp,) and ``fresh_path`` (depth,) int32 tensors.

        Returns (logits_dec (b, 1, V), logits_chunk (1, cp, V),
        cache.advance_decode(n), k_fresh, v_fresh)."""
        cfg = self.cfg
        store = cache.store
        names = {"k_pages": store.k_pages, "v_pages": store.v_pages,
                 "k_dec": cache.k_dec, "v_dec": cache.v_dec,
                 "k_fresh": k_fresh, "v_fresh": v_fresh}
        if hasattr(store, "k_scale_pages"):
            names.update(k_scale_pages=store.k_scale_pages,
                         v_scale_pages=store.v_scale_pages)
        paths = cache.slot_paths()                  # (depth, b)
        dec_lens = cache.slot_dec_lens()            # (b,)
        ctx_lens_b = cache.slot_context_lens()      # (b,), once per step
        x = self._embed(params, tokens)
        x_c = self._embed(params, chunk_tokens)
        for i in range(cfg.n_layers):
            layer = _layer(params["layers"], i)
            lcache = {name: t[i] for name, t in names.items()}
            a, a_c = blocks.attention_decode_packed(
                cfg, layer["attn"], apply_norm(cfg, layer["ln1"], x),
                apply_norm(cfg, layer["ln1"], x_c), lcache,
                page_tables=store.page_tables, seg_lens=store.seg_lens,
                paths=paths, ctx_lens_b=ctx_lens_b, dec_lens=dec_lens,
                buf_len=buf_len, chunk_valid=chunk_valid,
                fresh_start=fresh_start, fresh_pos=fresh_pos,
                fresh_path=fresh_path)
            x = x + a
            x_c = x_c + a_c
            x = x + self._ffn(layer, x, decode=True)
            x_c = x_c + self._ffn(layer, x_c, decode=True)
        logits = self._unembed(params, apply_norm(cfg, params["final_norm"], x))
        logits_c = self._unembed(params,
                                 apply_norm(cfg, params["final_norm"], x_c))
        return (logits, logits_c, cache.advance_decode(tokens.shape[1]),
                k_fresh, v_fresh)

    def make_paged_cache(self, slots, n_segments, depth, node_capacity,
                         page_m=128, num_pages=None, dec_capacity=None,
                         ctx_quant: str = "none", *, dtype=torch.bfloat16,
                         device="cuda"):
        """An empty PagedPrefixTreeCache (the general paged family) for this
        model, on ``device`` (the counterpart of the reference's abstract
        ``make_paged_cache_spec``). ``node_capacity`` is the per-segment
        TABLE envelope (tokens); storage is ``num_pages`` pool pages of
        ``page_m`` tokens (default: the full envelope)."""
        cfg = self.cfg
        dec_capacity = dec_capacity or cfg.decode_capacity
        return PagedPrefixTreeCache.init(
            cfg.n_layers, n_segments, depth, slots, node_capacity,
            dec_capacity, cfg.n_kv_heads_padded, cfg.kq_dim, dtype=dtype,
            page_m=page_m, num_pages=num_pages, ctx_quant=ctx_quant,
            device=resolve_device(device))

    def make_tree_cache(self, slots, n_nodes, depth, node_capacity,
                        dec_capacity=None, ctx_quant: str = "none", *,
                        dtype=torch.bfloat16, device="cuda"):
        """An empty PrefixTreeCache / QuantPrefixTreeCache for this model,
        on ``device`` (the counterpart of the reference's abstract
        ``make_tree_cache_spec``: the port builds the concrete cache).
        ``depth`` is the path table's height; everything else about the
        trie is data."""
        cfg = self.cfg
        dec_capacity = dec_capacity or cfg.decode_capacity
        return tree_cache_family(ctx_quant).init(
            cfg.n_layers, n_nodes, depth, slots, node_capacity, dec_capacity,
            cfg.n_kv_heads_padded, cfg.kq_dim, dtype=dtype,
            ctx_layout=cfg.ctx_layout, device=resolve_device(device))

    def make_forest_cache(self, slots, n_groups, ctx_capacity,
                          dec_capacity=None, ctx_quant: str = "none", *,
                          dtype=torch.bfloat16, device="cuda"):
        """An empty GroupedBifurcatedCache / GroupedQuantBifurcatedCache
        for this model, on ``device`` (the counterpart of the reference's
        ``make_forest_cache_spec``: the port has no abstract specs, so it
        builds the concrete cache)."""
        cfg = self.cfg
        dec_capacity = dec_capacity or cfg.decode_capacity
        return forest_cache_family(ctx_quant).init(
            cfg.n_layers, n_groups, slots, ctx_capacity, dec_capacity,
            cfg.n_kv_heads_padded, cfg.kq_dim, dtype=dtype,
            ctx_layout=cfg.ctx_layout, device=resolve_device(device))
