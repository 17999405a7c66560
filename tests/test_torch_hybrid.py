"""Port parity for the zamba2 hybrid's serving path on the reduced
zamba2-7b (5 Mamba2 layers, the shared block applied twice): the Mamba2
layer in fp32, ``HybridModel.prefill`` / ``decode_step`` with bifurcated
(bf16 and int8 context) and standard caches, ``ServeEngine.generate``, the
weights' dtypes — the port on weights converted from the JAX reference's
own initialisation, against the reference.

The reference runs the hybrid in bf16 whatever its weights (``hybrid.py``
casts the embedding to bf16), so whole-model parity is bf16 logits within
2e-2 of the largest (``_torch_parity.assert_close_logits``) and greedy
tokens; the Mamba2 layer alone is held in fp32 at 1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.core.kv_cache import BifurcatedCache as JBifurcatedCache
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.core.quantized import QuantBifurcatedCache as JQuantCache
from repro.models import get_model as j_get_model
from repro.models import linear_scan as jls
from repro.models import mamba as jmamba
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import cast_weights, params_from_numpy
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.core.quantized import QuantBifurcatedCache
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import chunked_linear as tcl
from repro_torch.models import get_model as t_get_model
from repro_torch.models import mamba as tmamba
from repro_torch.runtime.serve import ServeEngine as TServeEngine

CFG_J = reduced_config(get_config("zamba2-7b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("zamba2-7b"))
PARAMS_NP = jax.tree.map(np.asarray, j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 40))
# the leaves the reference applies in float32 (mamba.py, blocks.py)
FP32_LEAVES = ("ln", "norm_scale", "A_log", "dt_bias", "conv_w", "conv_b")


def _layer_np(i=0, j=1):
    """Mamba2 layer (i, j) of the reference's stacked params, numpy; its
    zero-initialised leaves made nonzero so that each one counts."""
    p = jax.tree.map(lambda a: np.array(a[i, j]), PARAMS_NP["mamba"])
    rng = np.random.RandomState(11)
    for name in ("conv_b", "A_log", "dt_bias", "D", "norm_scale"):
        p[name] = (p[name] + 0.3 * rng.randn(*p[name].shape)).astype(np.float32)
    p["ln"]["scale"] = (1 + 0.3 * rng.randn(*p["ln"]["scale"].shape)).astype(np.float32)
    return p


def _bf16_rounded(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("weights", ["float32", "served bf16"])
def test_mamba_layer_prefill_matches_fp32(weights):
    """One Mamba2 layer over 37 tokens (two chunks of 16 and a ragged
    third) in fp32 at 1e-5, with its final SSD and conv states. "served
    bf16": the port's weights as serving loads them (params_from_numpy at
    bf16, then widened), the reference's with the same matmul weights
    rounded and its float32 leaves exact."""
    p_np = _layer_np()
    x = np.random.RandomState(1).randn(2, 37, CFG_J.d_model).astype(np.float32)
    if weights == "float32":
        p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    else:
        p_t = cast_weights(params_from_numpy(p_np, device="cpu"), torch.float32)
        p_np = {k: (v if k in FP32_LEAVES else _bf16_rounded(v))
                for k, v in p_np.items()}
    p_j = jax.tree.map(jnp.asarray, p_np)
    y_j = jmamba.apply_mamba_train(CFG_J, p_j, jnp.asarray(x), None)
    y_t, S, conv = tmamba.apply_mamba_prefill(CFG_T, p_t, to_torch(x))
    assert_close(y_t, y_j, "float32")
    assert_close(tmamba.apply_mamba_train(CFG_T, p_t, to_torch(x)), y_j,
                 "float32")
    # the final SSD and conv states against the reference prefill's own
    # steps (hybrid.py's run_layer_with_state) on this layer
    S_j, conv_j = _reference_layer_states(p_j, jnp.asarray(x))
    assert_close(S, S_j, "float32")
    assert conv.dtype == torch.bfloat16
    assert_close(conv, conv_j, "bfloat16")   # bf16 of an fp32 matmul


def _reference_layer_states(p, x):
    """The final SSD state and conv state the reference's hybrid prefill
    keeps for one Mamba2 layer (src/repro/models/hybrid.py:181-204)."""
    cfg = CFG_J
    d_inner, nh, state = jmamba.mamba_dims(cfg)
    b, n = x.shape[:2]
    h = jmamba.rms_normalize(x, p["ln"]["scale"])
    z, xbc, dt = jmamba._mamba_inner(cfg, p, h)
    xs, B, C = jnp.split(jax.nn.silu(jmamba._causal_conv(
        xbc, p["conv_w"], p["conv_b"])), [d_inner, d_inner + state], axis=-1)
    dtf = jax.nn.softplus(dt.astype(jnp.float32) + p["dt_bias"])
    v = xs.reshape(b, n, nh, d_inner // nh) * dtf[..., None].astype(xs.dtype)
    q = jnp.broadcast_to(C[:, :, None, :], (b, n, nh, state))
    k = jnp.broadcast_to(B[:, :, None, :], (b, n, nh, state))
    _, S = jls.chunked_linear_attention(q, k, v, -jnp.exp(p["A_log"]) * dtf,
                                        chunk=cfg.ssm.chunk)
    return S, xbc[:, -(cfg.ssm.conv_width - 1):].astype(jnp.bfloat16)


def test_bf16_conv_w_misses_the_fp32_gate():
    """The gate above is the one a bf16 conv_w would fail: rounding conv_w
    (and only it) to bf16 moves the layer's fp32 output by far more than
    1e-5 of its values."""
    p_np = _layer_np()
    x = np.random.RandomState(1).randn(2, 37, CFG_J.d_model).astype(np.float32)
    y_j = jmamba.apply_mamba_train(CFG_J, jax.tree.map(jnp.asarray, p_np),
                                   jnp.asarray(x), None)
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    p_t["conv_w"] = p_t["conv_w"].bfloat16().float()
    err = np.max(np.abs(to_np(tmamba.apply_mamba_train(CFG_T, p_t, to_torch(x)))
                        - np.asarray(y_j)))
    assert err > 100 * 1e-5, err


@pytest.mark.parametrize("leaf", FP32_LEAVES)
def test_served_weights_keep_the_reference_fp32_leaves(leaf):
    """params_from_numpy at bf16 casts the matmul weights and keeps the
    leaves the reference applies in float32."""
    tp = params_from_numpy(PARAMS_NP, device="cpu")
    for stack in ("mamba", "mamba_tail"):
        node = tp[stack][leaf]
        node = node["scale"] if leaf == "ln" else node
        assert node.dtype == torch.float32, (stack, leaf)
        assert tp[stack]["in_proj"].dtype == torch.bfloat16
        assert tp[stack]["D"].dtype == torch.bfloat16   # cast at use there
    assert tp["shared_attn"]["ln1"]["scale"].dtype == torch.float32
    assert tp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


def test_mamba_layer_decode_matches_fp32():
    """Four decode steps from a random state, fp32: outputs at 1e-5, the
    SSD state (updated in place) at 1e-5 and the bf16 conv state at bf16's
    tolerance."""
    p_np = _layer_np()
    p_j = jax.tree.map(jnp.asarray, p_np)
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(2)
    spec = jmamba.mamba_state_spec(CFG_J, 1, 3)
    init = tmamba.mamba_state_init(CFG_T, 1, 3)     # the port's spec, zeros
    for name, (shape, dtype) in tmamba.mamba_state_spec(CFG_T, 1, 3).items():
        assert shape == spec[name].shape == tuple(init[name].shape)
        assert str(dtype).split(".")[-1] == str(spec[name].dtype)
    st_j = {"ssm": jnp.asarray(rng.randn(*spec["ssm"].shape[1:]), jnp.float32),
            "conv": jnp.asarray(rng.randn(*spec["conv"].shape[1:]), jnp.bfloat16)}
    st_t = {k: init[k][0].copy_(to_torch(np.asarray(v)))
            for k, v in st_j.items()}
    ssm_t = st_t["ssm"]
    for _ in range(4):
        x = rng.randn(3, 1, CFG_J.d_model).astype(np.float32)
        y_j, st_j = jmamba.apply_mamba_decode(CFG_J, p_j, jnp.asarray(x), st_j,
                                              None)
        y_t, st_t = tmamba.apply_mamba_decode(CFG_T, p_t, to_torch(x), st_t)
        assert st_t["ssm"] is ssm_t
        assert_close(y_t, y_j, "float32")
        assert_close(st_t["ssm"], st_j["ssm"], "float32")
        # bf16 of an fp32 matmul: the two frameworks' sums may round it apart
        assert_close(st_t["conv"], st_j["conv"], "bfloat16")


def _models():
    jm, tm = j_get_model(CFG_J), t_get_model(CFG_T)
    return (jm, jax.tree.map(jnp.asarray, PARAMS_NP), tm,
            params_from_numpy(PARAMS_NP, device="cpu"))


# (bifurcated, ctx_quant, port's decode impl)
MODEL_CASES = [(True, "none", "kernel"), (True, "int8", "kernel"),
               (True, "none", "einsum"), (False, "none", "kernel")]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_prefill_and_decode_steps_match(case):
    """prefill, then three decode steps of three samples (the cache
    broadcast as the serve engine does), against the reference's einsum
    path: bf16 logits every step, the cache families and lengths."""
    bifurcated, ctx_quant, impl = case
    jm, jp, tm, tp = _models()
    l_j, c_j = jax.jit(functools.partial(
        jm.prefill, rules=None, dec_capacity=8, bifurcated=bifurcated,
        ctx_quant=ctx_quant))(jp, jnp.asarray(CTX))
    l_t, c_t = tm.prefill(tp, torch.as_tensor(CTX), dec_capacity=8,
                          bifurcated=bifurcated, ctx_quant=ctx_quant)
    assert_close_logits(l_t, l_j, "bfloat16")
    fam = {(True, "none"): BifurcatedCache, (True, "int8"): QuantBifurcatedCache,
           (False, "none"): DecodeCache}[(bifurcated, ctx_quant)]
    assert type(c_t["attn"]) is fam and c_t["position"] == CTX.shape[1]
    assert c_t["mamba"]["ssm"].shape == c_j["mamba"]["ssm"].shape
    assert c_t["mamba"]["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(c_t["mamba"]["ssm"]),
                               to_np(c_j["mamba"]["ssm"]),
                               atol=2e-2 * np.abs(to_np(c_j["mamba"]["ssm"])).max())
    b = 3
    je = JServeEngine(jm, CFG_J, JServeConfig(batch=b))
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(batch=b))
    c_j, c_t = je._broadcast_state(c_j, b), te._broadcast_state(c_t, b)
    toks = np.random.RandomState(4).randint(0, CFG_J.vocab_size, (3, b, 1))
    n0 = tcl.chunked_linear_attention.launches
    j_step = jax.jit(functools.partial(jm.decode_step, rules=None))
    for t in range(3):
        l_j, c_j = j_step(jp, c_j, jnp.asarray(toks[t]))
        l_t, c_t = tm.decode_step(tp, c_t, torch.as_tensor(toks[t]), impl=impl)
        assert_close_logits(l_t, l_j, "bfloat16")
    assert c_t["position"] == int(c_j["position"]) == CTX.shape[1] + 3
    length = (c_t["attn"].dec_length if bifurcated else c_t["attn"].length)
    assert length == (3 if bifurcated else CTX.shape[1] + 3)
    assert tcl.chunked_linear_attention.launches == n0    # CPU: no launch


def _engines(temperature, cache_dtype="bfloat16", use_kernel=True,
             ctx_store="dense", min_io=0):
    """The two engines on the same decode path: the fused kernels (the
    reference's Pallas kernels in interpret mode, the port's plain
    versions, which round where they do) or the einsums. bf16 sampled
    tokens can differ across the two paths of either framework."""
    jm, jp, tm, tp = _models()
    kw = dict(batch=3, decode_capacity=8, temperature=temperature, top_p=0.9,
              use_kernel=use_kernel, cache_dtype=cache_dtype,
              ctx_store=ctx_store)
    je = JServeEngine(jm, CFG_J, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=min_io))
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw),
                      policy=TPolicy(min_io_saving_bytes=min_io))
    return je, jp, te, tp


def _reference_noise(seed, n_steps, shape):
    """The Gumbel draws the reference's generate makes: one key split per
    step, ``categorical(sub, l) == argmax(l + gumbel(sub))``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


# (temperature, cache_dtype, use_kernel on both sides, policy threshold)
GENERATE_CASES = [(0.0, "bfloat16", True, 0), (0.0, "int8", True, 0),
                  (0.0, "bfloat16", False, 0), (0.8, "bfloat16", True, 0),
                  (0.0, "bfloat16", True, 1 << 40)]


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_generate_matches_jax(case):
    """ServeEngine.generate, 5 steps of 3 samples: greedy tokens equal the
    reference's (bf16 and int8 context, fused-kernel and einsum paths, and
    the policy's fallback to the standard cache), sampled ones under the
    reference's own Gumbel draws; log-probs within 2e-2 of the largest
    |log-prob| (bf16 logits)."""
    temperature, cache_dtype, use_kernel, min_io = case
    je, jp, te, tp = _engines(temperature, cache_dtype, use_kernel,
                              min_io=min_io)
    assert te.should_bifurcate(3, CTX.shape[1]) == (min_io == 0)
    n_steps = 5
    r_j = je.generate(jp, jnp.asarray(CTX), n_steps=n_steps,
                      key=jax.random.PRNGKey(7))
    noise = (None if temperature == 0.0 else torch.as_tensor(
        _reference_noise(7, n_steps, (3, CFG_J.padded_vocab))))
    n0 = [k.launches for k in tbd.KERNELS]
    r_t = te.generate(tp, torch.as_tensor(CTX), n_steps=n_steps, noise=noise)
    assert [k.launches for k in tbd.KERNELS] == n0     # CPU: plain versions
    np.testing.assert_array_equal(to_np(r_t.tokens), np.asarray(r_j.tokens))
    lp_j = np.asarray(r_j.logprobs)
    np.testing.assert_allclose(to_np(r_t.logprobs), lp_j,
                               atol=2e-2 * np.abs(lp_j).max())


def test_int8_cache_not_ignored():
    """The port's twin of the reference's
    test_hybrid_serve_engine_int8_cache_not_ignored: cache_dtype="int8"
    reaches the hybrid, prefill_shared builds the quantized family with the
    decode arm sized from the serve config and broadcast to the batch."""
    _, _, te, tp = _engines(0.0, "int8")
    te.scfg = dataclasses.replace(te.scfg, decode_capacity=24)
    _, cache = te.prefill_shared(tp, torch.as_tensor(CTX[:, :12]), 3)
    assert isinstance(cache["attn"], QuantBifurcatedCache)
    assert cache["attn"].k_ctx.dtype == torch.int8
    assert cache["attn"].k_dec.shape[1] == 3
    assert cache["attn"].decode_capacity == 24
    assert cache["mamba"]["ssm"].shape[1] == 3
    r = te.generate(tp, torch.as_tensor(CTX[:, :12]), n_steps=3)
    assert tuple(r.tokens.shape) == (3, 3)
    assert torch.isfinite(r.logprobs).all()


def test_ctx_store_is_not_read_for_the_hybrid():
    """The reference's hybrid branch never reads ctx_store: with
    ctx_store="paged" both engines keep the dense bifurcated cache, and the
    port's tokens equal the reference's (and its own dense run's)."""
    je, jp, te, tp = _engines(0.0, ctx_store="paged")
    _, c_j = je.prefill_shared(jp, jnp.asarray(CTX), 3)
    _, c_t = te.prefill_shared(tp, torch.as_tensor(CTX), 3)
    assert isinstance(c_j["attn"], JBifurcatedCache)
    assert not isinstance(c_j["attn"], JQuantCache)
    assert type(c_t["attn"]) is BifurcatedCache
    r_j = je.generate(jp, jnp.asarray(CTX), n_steps=4)
    r_t = te.generate(tp, torch.as_tensor(CTX), n_steps=4)
    np.testing.assert_array_equal(to_np(r_t.tokens), np.asarray(r_j.tokens))
    _, _, te_dense, _ = _engines(0.0)
    np.testing.assert_array_equal(
        to_np(te_dense.generate(tp, torch.as_tensor(CTX), n_steps=4).tokens),
        to_np(r_t.tokens))
