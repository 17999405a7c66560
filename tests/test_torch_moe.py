"""Port parity for the mixture-of-experts (dbrx-132b, mixtral-8x7b) and
vision-language (internvl2-26b) families, on reduced configs and weights
converted from the JAX reference's own initialisation: ``apply_moe`` with
slack and tight capacity (the same dropped choices), a token count that
needs padding and the aux loss, ``moe_decode``, the models' prefill,
decode steps and greedy ``ServeEngine.generate``, reduced dbrx through the
forest, trie (synchronous and packed) and paged engines, and the VLM's
prefill with patch embeddings.

Tolerances: fp32 1e-5, bf16 2e-2 of the largest logit
(``_torch_parity``). Greedy tokens are compared in fp32: the reference
embeds to bf16, so the fp32 cases patch ``_embed`` on both models, as
``tests/test_torch_serve.py`` does, and its slot engines' stores (bf16
whatever the model) are swapped for fp32 ones on both sides."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ForestConfig as JForestConfig
from repro.configs import ServeConfig as JServeConfig
from repro.configs import TreeConfig as JTreeConfig
from repro.configs import get_config, reduced_config
from repro.core import paged as jpaged
from repro.core import quantized as jq
from repro.core.kv_cache import BifurcatedCache as JBifurcatedCache
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.runtime.serve import ForestServeEngine as JForestEngine
from repro.runtime.serve import ServeEngine as JServeEngine
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.convert import cast_weights, params_from_numpy
from repro_torch.core.kv_cache import BifurcatedCache as TBifurcatedCache
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.models import get_model as t_get_model
from repro_torch.models import moe as tmoe
from repro_torch.runtime.serve import (
    ForestServeEngine,
    ServeEngine,
    TreeServeEngine,
)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax config, port config, the reference's params as numpy)."""
    cj = reduced_config(get_config(arch))
    ct = tconfigs.reduced_config(tconfigs.get_config(arch))
    p_np = jax.tree.map(np.asarray, j_get_model(cj).init(jax.random.PRNGKey(0)))
    return cj, ct, p_np


def _models(arch, dtype):
    """(jax model, jax params, torch model, torch params) at ``dtype``."""
    cj, ct, p_np = _setup(arch)
    jm, tm = j_get_model(cj), t_get_model(ct)
    if dtype == "float32":
        jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
        tm._embed = lambda p, t: p["embed"][t]
    return (jm, jax.tree.map(jnp.asarray, p_np), tm,
            params_from_numpy(p_np, device="cpu", dtype=TORCH_DT[dtype]))


def _layer0_moe(arch="dbrx-132b"):
    _, _, p_np = _setup(arch)
    return jax.tree.map(lambda a: np.array(a[0]), p_np["layers"]["moe"])


def _reference_keep(cfg, router, x):
    """The reference's capacity mask (``repro/models/moe.py`` apply_moe,
    its routing and queue lines), which it does not return."""
    moe = cfg.moe
    b, s, d = x.shape
    sg = min(moe.group_size, s)
    xt = jnp.pad(x.reshape(b * s, d), ((0, (-b * s) % sg), (0, 0)))
    xg = xt.reshape(-1, sg, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ router, axis=-1)
    capacity = max(int(sg * moe.top_k * moe.capacity_factor / moe.n_experts), 4)
    _, gate_idx = jax.lax.top_k(probs, moe.top_k)
    onehot = jax.nn.one_hot(gate_idx, moe.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(xg.shape[0], sg * moe.top_k, moe.n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    return np.asarray(pos.reshape(xg.shape[0], sg, moe.top_k) < capacity)


def _port_keep(cfg, router, x):
    xg = tmoe.dispatch_groups(cfg.moe, x)
    _, _, gate_idx = tmoe.route(router, xg, cfg.moe.top_k)
    pos, _ = tmoe.queue_positions(gate_idx, cfg.moe.n_experts)
    return to_np(pos < tmoe.capacity(cfg.moe, xg.shape[1]))


@pytest.mark.parametrize("case", ["slack", "tight", "padded"])
def test_apply_moe_matches_reference(case):
    """One MoE layer in fp32: output within 1e-5, the aux loss, and the
    capacity mask equal to the reference's. "slack": the reduced config
    (capacity 16 of 32 choices a group: nothing dropped); "tight":
    capacity factor 0.5 (capacity 4, choices dropped); "padded": 37 tokens
    in groups of 16 (the last one padded with zero rows)."""
    cj, ct, _ = _setup("dbrx-132b")
    cf = 0.5 if case == "tight" else cj.moe.capacity_factor
    cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe,
                                                         capacity_factor=cf))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe,
                                                         capacity_factor=cf))
    p_np = _layer0_moe()
    shape = (1, 37, cj.d_model) if case == "padded" else (2, 32, cj.d_model)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    oj, aux_j = jmoe.apply_moe(cj, jax.tree.map(jnp.asarray, p_np),
                               jnp.asarray(x), None)
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    ot, aux_t = tmoe.apply_moe(ct, p_t, torch.as_tensor(x))
    assert_close(ot, oj, "float32")
    assert_close(aux_t, aux_j, "float32")
    keep_j = _reference_keep(cj, jnp.asarray(p_np["router"]), jnp.asarray(x))
    keep_t = _port_keep(ct, p_t["router"], torch.as_tensor(x))
    np.testing.assert_array_equal(keep_t, keep_j)
    if case == "tight":
        assert not keep_t.all()
    else:
        assert keep_t.all()


def test_apply_moe_bf16_and_moe_decode_match_reference():
    """bf16 activations through apply_moe (2e-2 of the largest output) and
    moe_decode in fp32 (1e-5) and bf16, on the layer's served weights
    (router fp32)."""
    cj, ct, _ = _setup("dbrx-132b")
    p_np = _layer0_moe()
    rng = np.random.RandomState(4)
    x = np.asarray(jnp.asarray(rng.randn(2, 20, cj.d_model), jnp.bfloat16))
    oj, _ = jmoe.apply_moe(cj, jax.tree.map(jnp.asarray, p_np),
                           jnp.asarray(x), None)
    p_bf = params_from_numpy(p_np, device="cpu")
    assert p_bf["router"].dtype == torch.float32
    ot, _ = tmoe.apply_moe(ct, p_bf, to_torch(x))
    assert_close_logits(ot, oj, "bfloat16")
    for dtype in ("float32", "bfloat16"):
        xd = np.asarray(jnp.asarray(rng.randn(5, 1, cj.d_model),
                                    jnp.dtype(dtype)))
        dj = jmoe.moe_decode(cj, jax.tree.map(jnp.asarray, p_np),
                             jnp.asarray(xd), None)
        p_t = params_from_numpy(p_np, device="cpu", dtype=TORCH_DT[dtype])
        dt = tmoe.moe_decode(ct, p_t, to_torch(xd))
        assert_close_logits(dt, dj, dtype)


def test_new_fp32_keys_move_no_other_leaf_and_experts_cast_as_drawn():
    """"router", "ln_x" and "enc_norm" in FP32_KEYS leave every dense,
    hybrid and xLSTM leaf's dtype as it was; a served MoE layer keeps its
    router fp32 and its experts bf16; init draws each expert leaf one
    layer at a time and casts it at once."""
    new = ("router", "ln_x", "enc_norm")
    old = tuple(k for k in convert.FP32_KEYS if k not in new)

    def dtypes(tree):
        return {k: (dtypes(v) if isinstance(v, dict) else v.dtype)
                for k, v in tree.items()}

    for arch in ("internlm2-1.8b", "stablelm-3b", "zamba2-7b", "xlstm-1.3b"):
        cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
        params = t_get_model(cfg).init(0, device="cpu", dtype=torch.float32)
        want = dtypes(cast_weights(params, torch.bfloat16))
        saved = convert.FP32_KEYS
        try:
            convert.FP32_KEYS = old
            assert dtypes(cast_weights(params, torch.bfloat16)) == want, arch
        finally:
            convert.FP32_KEYS = saved
    _, ct, _ = _setup("dbrx-132b")
    tp = t_get_model(ct).init(0, device="cpu")
    moe = tp["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (2, ct.d_model, 4)
    for name in ("experts_wi_gate", "experts_wi_up", "experts_wo"):
        assert moe[name].dtype == torch.bfloat16
        assert moe[name].shape[:2] == (2, 4)
        std = float(moe[name].float().std())
        fan_in = ct.d_model if name != "experts_wo" else ct.d_ff
        assert abs(std * fan_in**0.5 - 1) < 0.1, (name, std)
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert "mlp" not in tp["layers"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "mixtral-8x7b"])
def test_moe_prefill_decode_and_generate_match_reference(arch):
    """fp32 prefill logits and K/V, two decode steps on the kernel path
    from the bifurcated cache (mixtral's window takes the flash path, as
    in the reference), and greedy generate tokens at batch 3."""
    cj, ct, _ = _setup(arch)
    jm, jp, tm, tp = _models(arch, "float32")
    ctx = np.random.RandomState(5).randint(0, cj.vocab_size, (1, 20))
    lj, cache_j = jm.prefill(jp, jnp.asarray(ctx), None)
    lt, cache_t = tm.prefill(tp, torch.as_tensor(ctx))
    assert_close(lt, lj, "float32")
    assert_close(cache_t.k, cache_j.k, "float32")
    b, c_d = 3, 4
    cj_b = JBifurcatedCache.from_prefill(cache_j.k[:, 0], cache_j.v[:, 0], b,
                                         c_d, dtype=jnp.float32)
    ct_b = TBifurcatedCache.from_prefill(cache_t.k[:, 0], cache_t.v[:, 0], b,
                                         c_d, dtype=torch.float32)
    rng = np.random.RandomState(6)
    for _ in range(2):
        toks = rng.randint(0, cj.vocab_size, (b, 1))
        lj, cj_b = jm.decode_step(jp, cj_b, jnp.asarray(toks), None,
                                  impl="kernel")
        lt, ct_b = tm.decode_step(tp, ct_b, torch.as_tensor(toks),
                                  impl="kernel")
        assert_close(lt, lj, "float32")
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, use_kernel=True)
    je = JServeEngine(jm, cj, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=0))
    te = ServeEngine(tm, ct, tconfigs.ServeConfig(**kw),
                     policy=TPolicy(min_io_saving_bytes=0))
    rj = je.generate(jp, jnp.asarray(ctx), n_steps=5)
    rt = te.generate(tp, torch.as_tensor(ctx), n_steps=5)
    np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
    assert_close(rt.logprobs, rj.logprobs, "float32")


def test_moe_bf16_prefill_and_decode_match_reference():
    """The served bf16 dbrx: prefill and a kernel-path decode step within
    2e-2 of the largest logit."""
    cj, _, _ = _setup("dbrx-132b")
    jm, jp, tm, tp = _models("dbrx-132b", "bfloat16")
    ctx = np.random.RandomState(7).randint(0, cj.vocab_size, (1, 24))
    lj, cache_j = jm.prefill(jp, jnp.asarray(ctx), None)
    lt, cache_t = tm.prefill(tp, torch.as_tensor(ctx))
    assert_close_logits(lt, lj, "bfloat16")
    cj_b = JBifurcatedCache.from_prefill(cache_j.k[:, 0], cache_j.v[:, 0], 2, 4)
    ct_b = TBifurcatedCache.from_prefill(cache_t.k[:, 0], cache_t.v[:, 0], 2, 4)
    toks = np.array([[3], [9]])
    lj, _ = jm.decode_step(jp, cj_b, jnp.asarray(toks), None, impl="kernel")
    lt, _ = tm.decode_step(tp, ct_b, torch.as_tensor(toks), impl="kernel")
    assert_close_logits(lt, lj, "bfloat16")


# ---- reduced dbrx on the slot engines ----

PROMPT_A = np.random.RandomState(8).randint(0, 512, (1, 21))
PROMPT_B = np.random.RandomState(9).randint(0, 512, (1, 13))
SYS = np.random.RandomState(10).randint(0, 512, (1, 12))
TAIL_A = np.random.RandomState(11).randint(0, 512, (1, 7))
TAIL_B = np.random.RandomState(12).randint(0, 512, (1, 9))
ENGINE_KW = dict(slots=4, decode_capacity=16, temperature=0.0)


def _fp32_store(model, cfg, kind, ecfg, framework):
    """An fp32 store for an engine state (the reference's are bf16)."""
    quant = "int8" if ecfg.cache_dtype == "int8" else "none"
    L, g, hd = cfg.n_layers, cfg.n_kv_heads_padded, cfg.kq_dim
    if framework == "jax":
        if kind == "forest":
            return jq.forest_cache_family(quant).init(
                L, ecfg.n_groups, ecfg.slots, ecfg.ctx_capacity,
                ecfg.decode_capacity, g, hd, dtype=jnp.float32,
                ctx_layout=cfg.ctx_layout)
        if ecfg.ctx_store == "paged":
            return jpaged.PagedPrefixTreeCache.init(
                L, ecfg.n_nodes, ecfg.depth, ecfg.slots, ecfg.node_capacity,
                ecfg.decode_capacity, g, hd, dtype=jnp.float32,
                page_m=ecfg.page_size, ctx_quant=quant)
        return jq.tree_cache_family(quant).init(
            L, ecfg.n_nodes, ecfg.depth, ecfg.slots, ecfg.node_capacity,
            ecfg.decode_capacity, g, hd, dtype=jnp.float32,
            ctx_layout=cfg.ctx_layout)
    if kind == "forest":
        return model.make_forest_cache(
            ecfg.slots, ecfg.n_groups, ecfg.ctx_capacity,
            ecfg.decode_capacity, quant, dtype=torch.float32, device="cpu")
    if ecfg.ctx_store == "paged":
        return model.make_paged_cache(
            ecfg.slots, ecfg.n_nodes, ecfg.depth, ecfg.node_capacity,
            page_m=ecfg.page_size, dec_capacity=ecfg.decode_capacity,
            ctx_quant=quant, dtype=torch.float32, device="cpu")
    return model.make_tree_cache(
        ecfg.slots, ecfg.n_nodes, ecfg.depth, ecfg.node_capacity,
        ecfg.decode_capacity, quant, dtype=torch.float32, device="cpu")


ENGINES = {
    "forest": dict(kind="forest", n_groups=2, ctx_capacity=32,
                   cache_dtype="int8", use_kernel=True),
    "trie": dict(kind="trie", n_nodes=4, depth=2, node_capacity=24,
                 suffix_prefill=True, use_kernel=True),
    "trie packed paged": dict(kind="trie", n_nodes=4, depth=2,
                              node_capacity=24, suffix_prefill=True,
                              step_mode="packed", prefill_chunk=4,
                              ctx_store="paged", page_size=8,
                              use_kernel=True),
}


def _drive(case, framework):
    """Two admissions (two slots each), 5 steps, then 4 more: the forest
    over two prompts, the trie over [SYS, TAIL_A] and [SYS, TAIL_B] (the
    second reusing SYS). Returns the engine's outputs and log-probs."""
    cfg_j, cfg_t, _ = _setup("dbrx-132b")
    kw = dict(ENGINES[case])
    kind = kw.pop("kind")
    if framework == "jax":
        jm, jp, _, _ = _models("dbrx-132b", "float32")
        model, params, conv, cfg = jm, jp, jnp.asarray, cfg_j
        Eng = JForestEngine if kind == "forest" else JTreeEngine
        Cfg = JForestConfig if kind == "forest" else JTreeConfig
        st_kw = {}
    else:
        _, _, tm, tp = _models("dbrx-132b", "float32")
        model, params, conv, cfg = tm, tp, torch.as_tensor, cfg_t
        Eng = ForestServeEngine if kind == "forest" else TreeServeEngine
        Cfg = tconfigs.ForestConfig if kind == "forest" else tconfigs.TreeConfig
        st_kw = {"device": "cpu"}
    ecfg = Cfg(**ENGINE_KW, **kw)
    eng = Eng(model, cfg, ecfg)
    st = eng.init_state(**st_kw)
    st = dataclasses.replace(st, cache=_fp32_store(model, cfg, kind, ecfg,
                                                   framework))
    if kind == "forest":
        reqs = (conv(PROMPT_A), conv(PROMPT_B))
    else:
        reqs = ([conv(SYS), conv(TAIL_A)], [conv(SYS), conv(TAIL_B)])
    st, _ = eng.admit(params, st, reqs[0], 2)
    st = eng.step_chunk(params, st, 5)
    st, _ = eng.admit(params, st, reqs[1], 2)
    st = eng.step_chunk(params, st, 4)
    return eng.outputs, eng.logps


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_dbrx_slot_engines_match_reference(case):
    """Reduced dbrx in fp32 through the forest (int8 segments, grouped
    kernel path), the trie with suffix prefill (kernel path) and the
    packed trie on the paged store (the packed step's chunk rows through
    moe_decode, the synchronous suffix prefill through apply_moe): greedy
    tokens equal to the reference engine's, log-probs within 1e-5."""
    out_t, lp_t = _drive(case, "torch")
    out_j, lp_j = _drive(case, "jax")
    assert sum(len(o) for o in out_t.values()) > 8
    assert sorted(out_t) == sorted(out_j)
    for s in out_t:
        assert out_t[s] == out_j[s], s
        assert_close(torch.tensor(lp_t[s]), np.array(lp_j[s]), "float32")


def test_dbrx_paged_serve_engine_matches_reference():
    """ServeEngine with ctx_store="paged" (pages of 8) on reduced dbrx:
    greedy tokens equal to the reference's (fp32)."""
    cj, ct, _ = _setup("dbrx-132b")
    jm, jp, tm, tp = _models("dbrx-132b", "float32")
    ctx = np.random.RandomState(13).randint(0, cj.vocab_size, (1, 30))
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, use_kernel=True,
              ctx_store="paged", page_size=8)
    je = JServeEngine(jm, cj, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=0))
    te = ServeEngine(tm, ct, tconfigs.ServeConfig(**kw),
                     policy=TPolicy(min_io_saving_bytes=0))
    rj = je.generate(jp, jnp.asarray(ctx), n_steps=5)
    rt = te.generate(tp, torch.as_tensor(ctx), n_steps=5)
    np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
    assert_close(rt.logprobs, rj.logprobs, "float32")


# ---- the VLM ----

def _patches(cfg, seed):
    return (np.random.RandomState(seed).randn(1, cfg.n_image_tokens,
                                              cfg.d_model) * 0.02
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_patch_embeds_matches_reference(dtype):
    """internvl2: the projected patches before the text; prefill logits
    and K/V (fp32) over the image + text context, and without patches the
    text alone, as in the reference."""
    cj, _, _ = _setup("internvl2-26b")
    jm, jp, tm, tp = _models("internvl2-26b", dtype)
    ctx = np.random.RandomState(14).randint(0, cj.vocab_size, (1, 17))
    pe = _patches(cj, 15)
    lj, c_j = jm.prefill(jp, jnp.asarray(ctx), None,
                         patch_embeds=jnp.asarray(pe))
    lt, c_t = tm.prefill(tp, torch.as_tensor(ctx),
                         patch_embeds=torch.as_tensor(pe))
    assert c_t.length == int(c_j.length) == 17 + cj.n_image_tokens
    assert_close_logits(lt, lj, dtype)
    if dtype == "float32":
        assert_close(c_t.k, c_j.k, dtype)
    lj, _ = jm.prefill(jp, jnp.asarray(ctx), None)
    lt, c_t = tm.prefill(tp, torch.as_tensor(ctx))
    assert c_t.length == 17
    assert_close_logits(lt, lj, dtype)


def test_vlm_generate_decides_on_text_length_and_matches_reference():
    """ServeEngine.generate with patch_embeds: the policy sees the text's
    length only (a threshold between the text's and image + text's IO
    saving bifurcates neither side), the bifurcated cache's context is
    image + text, and greedy tokens equal the reference's (fp32)."""
    cj, ct, _ = _setup("internvl2-26b")
    jm, jp, tm, tp = _models("internvl2-26b", "float32")
    ctx = np.random.RandomState(16).randint(0, cj.vocab_size, (1, 12))
    pe = _patches(cj, 17)
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, use_kernel=True)
    # the policy's modelled saving: (b - 1) * m_c * g * hd * 2 (K and V)
    # * 2 bytes a layer; a threshold above the text's, below image + text
    per_key = (3 - 1) * cj.n_kv_heads_padded * cj.kq_dim * 2 * 2
    thr = per_key * (12 + cj.n_image_tokens // 2)
    te = ServeEngine(tm, ct, tconfigs.ServeConfig(**kw),
                     policy=TPolicy(min_io_saving_bytes=thr))
    je = JServeEngine(jm, cj, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=thr))
    assert not te.should_bifurcate(3, 12)
    assert te.should_bifurcate(3, 12 + cj.n_image_tokens)
    _, cache = te.prefill_shared(tp, torch.as_tensor(ctx), 3,
                                 patch_embeds=torch.as_tensor(pe))
    assert type(cache).__name__ == "DecodeCache"
    assert cache.length == 12 + cj.n_image_tokens
    for thr_ in (thr, 0):
        te.policy = TPolicy(min_io_saving_bytes=thr_)
        je.policy = JPolicy(min_io_saving_bytes=thr_)
        rj = je.generate(jp, jnp.asarray(ctx), n_steps=4,
                         patch_embeds=jnp.asarray(pe))
        rt = te.generate(tp, torch.as_tensor(ctx), n_steps=4,
                         patch_embeds=torch.as_tensor(pe))
        np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
        assert_close(rt.logprobs, rj.logprobs, "float32")
    _, cache = te.prefill_shared(tp, torch.as_tensor(ctx), 3,
                                 patch_embeds=torch.as_tensor(pe))
    assert isinstance(cache, TBifurcatedCache)
    assert cache.context_len == 12 + cj.n_image_tokens
