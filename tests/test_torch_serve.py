"""Port parity for the whole slice on reduced internlm2-1.8b: prefill
logits, one decode step on the kernel path, greedy tokens from
``ServeEngine.generate``, sampled tokens under shared Gumbel noise, and the
policy's fallback to the standard cache — the port on weights converted
from the JAX reference's own initialisation, against the reference.

The reference embeds to bf16; the fp32 cases patch ``_embed`` on BOTH
models to keep float32, so the whole forward runs in fp32 and token
identity is a sound gate. bf16 is gated on logits only: the reference
itself does not keep bf16 tokens identical across its own kernel paths
(see ``_torch_parity.assert_close_logits`` for the bf16 logits gate)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.core.kv_cache import BifurcatedCache as JBifurcatedCache
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.models import get_model as j_get_model
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.kv_cache import BifurcatedCache as TBifurcatedCache
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import ServeEngine as TServeEngine

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray, j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 24))
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _models(dtype):
    """(jax model, jax params, torch model, torch params) at ``dtype``."""
    jm, tm = j_get_model(CFG_J), t_get_model(CFG_T)
    if dtype == "float32":
        jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
        tm._embed = lambda p, t: p["embed"][t]
    jp = jax.tree.map(jnp.asarray, PARAMS_NP)
    tp = params_from_numpy(PARAMS_NP, device="cpu", dtype=TORCH_DT[dtype])
    return jm, jp, tm, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_kv_match(dtype):
    jm, jp, tm, tp = _models(dtype)
    lj, cj = jm.prefill(jp, jnp.asarray(CTX), None)
    lt, ct = tm.prefill(tp, torch.as_tensor(CTX))
    assert_close_logits(lt, lj, dtype)
    assert ct.length == int(cj.length)
    if dtype == "float32":  # bf16: one rounding flip upstream can move a
        assert_close(ct.k, cj.k, dtype)   # rotated key by more than 2e-2
        assert_close(ct.v, cj.v, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_kernel_path_matches(dtype):
    """Two decode steps on the kernel path from the same bifurcated cache:
    logits (and, in fp32, the decode arm written in place) agree with the
    reference."""
    jm, jp, tm, tp = _models(dtype)
    rng = np.random.RandomState(1)
    b, c_d = 3, 6
    k = np.asarray(jnp.asarray(rng.randn(2, 24, 2, 16), jnp.dtype(dtype)))
    v = np.asarray(jnp.asarray(rng.randn(2, 24, 2, 16), jnp.dtype(dtype)))
    cj = JBifurcatedCache.from_prefill(jnp.asarray(k), jnp.asarray(v), b, c_d,
                                       dtype=jnp.dtype(dtype))
    ct = TBifurcatedCache.from_prefill(to_torch(k), to_torch(v), b, c_d,
                                       dtype=TORCH_DT[dtype])
    for step in range(2):
        toks = rng.randint(0, CFG_J.vocab_size, (b, 1))
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks), None, impl="kernel")
        lt, ct = tm.decode_step(tp, ct, torch.as_tensor(toks), impl="kernel")
        assert_close_logits(lt, lj, dtype)
        if dtype == "float32":
            assert_close(ct.k_dec, cj.k_dec, dtype)
        assert ct.dec_length == int(cj.dec_length) == step + 1


def _engines(temperature, bifurcated=True, min_io=0):
    jm, jp, tm, tp = _models("float32")
    kw = dict(batch=3, decode_capacity=8, temperature=temperature, top_p=0.9,
              bifurcated=bifurcated, use_kernel=True)
    je = JServeEngine(jm, CFG_J, JServeConfig(**kw),
                      policy=JPolicy(enabled=bifurcated,
                                     min_io_saving_bytes=min_io))
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw),
                      policy=TPolicy(enabled=bifurcated,
                                     min_io_saving_bytes=min_io))
    return je, jp, te, tp


def _check_result(rt, rj):
    np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
    assert_close(rt.logprobs, rj.logprobs, "float32")
    assert_close(rt.mean_logprob, rj.mean_logprob, "float32")


def test_greedy_generate_matches_fp32():
    je, jp, te, tp = _engines(temperature=0.0)
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=5)
    tbd.fused_bifurcated_decode.launches = 0
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=5)
    _check_result(rt, rj)
    assert te.decode_dispatches == je.decode_dispatches == 1
    # CPU tensors take the plain version: no kernel launch is counted
    assert tbd.fused_bifurcated_decode.launches == 0


def _reference_noise(seed, n_steps, shape):
    """The Gumbel draws the reference's generate makes: one key split per
    step, ``categorical(sub, l) == argmax(l + gumbel(sub))``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return np.stack(out)


def test_sampled_generate_matches_under_shared_noise():
    je, jp, te, tp = _engines(temperature=0.8)
    n_steps = 5
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=n_steps,
                     key=jax.random.PRNGKey(7))
    noise = _reference_noise(7, n_steps, (3, CFG_J.padded_vocab))
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=n_steps,
                     noise=torch.as_tensor(noise), loop="python")
    _check_result(rt, rj)
    assert te.decode_dispatches == n_steps - 1
    # without noise the engine draws its own, reproducibly from the seed
    r1 = te.generate(tp, torch.as_tensor(CTX), n_steps=3)
    r2 = te.generate(tp, torch.as_tensor(CTX), n_steps=3)
    assert torch.equal(r1.tokens, r2.tokens)


def test_policy_falls_back_to_standard_cache():
    """Under the production threshold the reduced workload stays on the
    standard batched cache, on both sides, with the same tokens."""
    je, jp, te, tp = _engines(temperature=0.0, min_io=1 << 20)
    assert not te.should_bifurcate(3, CTX.shape[1])
    assert te.should_bifurcate(32, 8192) == je.should_bifurcate(32, 8192)
    _, cache = te.prefill_shared(tp, torch.as_tensor(CTX), 3)
    assert type(cache).__name__ == "DecodeCache"
    assert tuple(cache.k.shape) == (2, 3, 24 + 8, 2, 16)
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=4)
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=4)
    _check_result(rt, rj)


def test_unported_paths_raise():
    from repro_torch.core.errors import DecodeCapacityExceeded
    tm = t_get_model(CFG_T)
    with pytest.raises(NotImplementedError):
        TServeEngine(tm, CFG_T, tconfigs.ServeConfig(ctx_store="paged"))
    with pytest.raises(NotImplementedError):
        t_get_model(dataclasses.replace(CFG_T, family="moe"))
    with pytest.raises(KeyError):       # configs of unported families
        tconfigs.get_config("mixtral-8x7b")
    with pytest.raises(RuntimeError):   # no CUDA device here: never the CPU
        tm.init(0)
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(decode_capacity=4))
    with pytest.raises(DecodeCapacityExceeded):
        te.generate(None, torch.as_tensor(CTX), n_steps=6)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen1.5-32b",
                                  "stablelm-3b"])
def test_dense_variants_prefill_and_decode_fp32(arch):
    """The dense family's other branches: sliding window (the decode step
    leaves the kernel for the flash path, as in the reference), qkv bias,
    layernorm. fp32 through the bifurcated cache built from the prefill."""
    cj = reduced_config(get_config(arch))
    ct = tconfigs.reduced_config(tconfigs.get_config(arch))
    jm, tm = j_get_model(cj), t_get_model(ct)
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    tm._embed = lambda p, t: p["embed"][t]
    p_np = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    if cj.qkv_bias:  # the reference inits biases to zero: make them count
        rng = np.random.RandomState(2)
        for name in ("bq", "bk", "bv"):
            a = p_np["layers"]["attn"][name]
            p_np["layers"]["attn"][name] = (0.1 * rng.randn(*a.shape)).astype(a.dtype)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    ctx = np.random.RandomState(3).randint(0, cj.vocab_size, (1, 20))
    lj, cache_j = jm.prefill(jp, jnp.asarray(ctx), None)
    lt, cache_t = tm.prefill(tp, torch.as_tensor(ctx))
    assert_close(lt, lj, "float32")
    b, c_d = 2, 4
    cj_b = JBifurcatedCache.from_prefill(cache_j.k[:, 0], cache_j.v[:, 0], b,
                                         c_d, dtype=jnp.float32)
    ct_b = TBifurcatedCache.from_prefill(cache_t.k[:, 0], cache_t.v[:, 0], b,
                                         c_d, dtype=torch.float32)
    toks = np.array([[5], [7]])
    lj, _ = jm.decode_step(jp, cj_b, jnp.asarray(toks), None, impl="kernel")
    lt, _ = tm.decode_step(tp, ct_b, torch.as_tensor(toks), impl="kernel")
    assert_close(lt, lj, "float32")
