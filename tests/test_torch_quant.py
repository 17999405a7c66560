"""Port parity for the int8 context arm: quantization bit for bit, the q8
caches, the einsum paths, the fused q8 kernel's plain version against the
Pallas kernel in interpret mode, the q8 dispatcher, and one int8 decode
step plus a greedy int8 generate on the reduced internlm2 model with
converted weights — each against the JAX reference on the same inputs.

Tolerances: the int8 values and f32 scales are bit-equal (the same f32
ops, round half to even); fp32 results agree to 1e-5 (the reference's own
int8-vs-einsum tolerance), bf16 to 2e-2 (``_torch_parity``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.core import quantized as jq
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.kernels import bifurcated_decode as jbd
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantized as tq
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import ServeEngine as TServeEngine

DTYPES = ["float32", "bfloat16"]
G, HD = 2, 16


def _rand(rng, shape, dtype="float32"):
    return np.asarray(jnp.asarray(rng.randn(*shape), dtype))


def _bit_equal(got, want):
    """The same dtype and the same bytes (bf16 through its 2-byte view)."""
    got, want = got.detach().cpu(), np.asarray(want)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(np.int16)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---- quantization, bit for bit ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fold", [1.0, HD**-0.5])
def test_quantize_ctx_is_bit_equal(dtype, fold):
    rng = np.random.RandomState(0)
    x = _rand(rng, (3, 40, G, HD), dtype) * 3
    x[0, 0, 0] = 0                     # an all-zero row: the 1e-8 floor
    x[1, 2, 1, :4] = [1.5, -2.5, 0.5, -0.5]   # ties at a scale of 1/127
    kq_t, ks_t = tq.quantize_ctx(to_torch(x), fold_scale=fold)
    kq_j, ks_j = jq.quantize_ctx(jnp.asarray(x), fold_scale=fold)
    _bit_equal(kq_t, kq_j)
    _bit_equal(ks_t, ks_j)
    back_t = tq.dequantize_ctx(kq_t, ks_t)
    assert_close(back_t, jq.dequantize_ctx(kq_j, ks_j), "float32")


@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_quant_cache_from_prefill_is_bit_equal(layout):
    rng = np.random.RandomState(1)
    k, v = _rand(rng, (2, 9, G, HD), "bfloat16"), _rand(rng, (2, 9, G, HD),
                                                         "bfloat16")
    cj = jq.QuantBifurcatedCache.from_prefill(
        jnp.asarray(k), jnp.asarray(v), 3, 5, ctx_layout=layout)
    ct = tq.QuantBifurcatedCache.from_prefill(
        to_torch(k), to_torch(v), 3, 5, ctx_layout=layout)
    for name in ("k_ctx", "v_ctx", "k_scale", "v_scale", "k_dec", "v_dec"):
        _bit_equal(getattr(ct, name), getattr(cj, name))
    assert (ct.context_len, ct.decode_capacity, ct.dec_length) == (9, 5, 0)
    assert tq.ctx_cache_family("int8") is tq.QuantBifurcatedCache
    assert tq.ctx_cache_family("none").__name__ == "BifurcatedCache"
    with pytest.raises(ValueError):
        tq.ctx_cache_family("fp8")


@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_grouped_quant_write_context_is_bit_equal(layout):
    """Two admissions, then a shorter context over the first segment (its
    stale tail zeroed), then a slot assignment — the same bits as the
    reference's functional updates, written in place."""
    rng = np.random.RandomState(2)
    L, n_groups, slots, cap, c_d = 2, 3, 4, 24, 5
    cj = jq.GroupedQuantBifurcatedCache.init(L, n_groups, slots, cap, c_d, G,
                                             HD, ctx_layout=layout)
    ct = tq.GroupedQuantBifurcatedCache.init(L, n_groups, slots, cap, c_d, G,
                                             HD, ctx_layout=layout,
                                             device="cpu")
    ptrs = {n: getattr(ct, n).data_ptr() for n in ("k_ctx", "k_scale",
                                                   "k_dec", "ctx_lens")}
    for m_new, gidx in ((20, 0), (7, 2), (11, 0)):
        k = _rand(rng, (L, m_new, G, HD), "bfloat16")
        v = _rand(rng, (L, m_new, G, HD), "bfloat16")
        cj = cj.write_context(jnp.asarray(k), jnp.asarray(v), gidx)
        ct.write_context(to_torch(k), to_torch(v), gidx)
    mask = np.array([True, False, True, False])
    cj = cj.assign_slots(jnp.asarray(mask), 2)
    ct.assign_slots(torch.as_tensor(mask), 2)
    for name in ("k_ctx", "v_ctx", "k_scale", "v_scale", "ctx_lens",
                 "group_ids", "dec_lens", "k_dec"):
        _bit_equal(getattr(ct, name), getattr(cj, name))
    assert {n: getattr(ct, n).data_ptr() for n in ptrs} == ptrs
    with pytest.raises(ValueError):
        ct.write_context(torch.zeros(L, cap + 1, G, HD),
                         torch.zeros(L, cap + 1, G, HD), 1)


# ---- the q8 kernel's plain version against the Pallas kernel ----

# (b, p, n, m_c, c_d, block_m): ragged m_c, masked arm, p > 1, n > 1
Q8_CASES = [(3, 2, 1, 300, 5, 128), (2, 2, 2, 77, 4, 512),
            (4, 1, 2, 200, 3, 128)]


def _q8_inputs(b, p, n, m_c, c_d, dtype, seed=0):
    rng = np.random.RandomState(seed)
    rows, ld = b * p * n, b * c_d
    kq, ks = jq.quantize_ctx(jnp.asarray(rng.randn(G, m_c, HD), jnp.float32),
                             fold_scale=HD**-0.5)
    vq, vs = jq.quantize_ctx(jnp.asarray(rng.randn(G, m_c, HD), jnp.float32))
    lens = rng.randint(1, c_d + 1, size=b)
    live = (np.arange(c_d)[None, :] < lens[:, None]).reshape(1, ld)
    return {"q": _rand(rng, (G, rows, HD), dtype), "kq": np.asarray(kq),
            "vq": np.asarray(vq), "ks": np.asarray(ks), "vs": np.asarray(vs),
            "kd": _rand(rng, (G, ld, HD), dtype),
            "vd": _rand(rng, (G, ld, HD), dtype),
            "bias": np.where(live, 0.0, -1e30).astype(np.float32)}


Q8_KEYS = ("q", "kq", "vq", "ks", "vs", "kd", "vd", "bias")


@pytest.mark.parametrize("case", Q8_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_q8_plain_matches_pallas(case, dtype):
    b, p, n, m_c, c_d, block_m = case
    a = _q8_inputs(b, p, n, m_c, c_d, dtype)
    kw = dict(scale=HD**-0.5, c_d=c_d, pn=p * n)
    want = jbd.fused_bifurcated_decode_q8(
        *(jnp.asarray(a[k]) for k in Q8_KEYS), block_m=block_m,
        interpret=True, **kw)
    got = tbd.fused_bifurcated_decode_q8_plain(
        *(to_torch(a[k]) for k in Q8_KEYS), block_m=block_m, **kw)
    assert got.dtype == to_torch(a["q"]).dtype
    assert_close(got, want, dtype)
    # the wrapper takes CPU tensors to the plain version, counting nothing
    n0 = tbd.fused_bifurcated_decode_q8.launches
    same = tbd.fused_bifurcated_decode_q8(*(to_torch(a[k]) for k in Q8_KEYS),
                                          **kw)
    assert tbd.fused_bifurcated_decode_q8.launches == n0
    assert_close(same, want, dtype)


# ---- einsum paths and the dispatcher ----

def _attn_case(dtype, layout, rng, b=3, p=2, n=1, m_c=50, c_d=6):
    ctx = (G, m_c, HD) if layout == "gmk" else (m_c, G, HD)
    q = _rand(rng, (b, G, p, n, HD), dtype)
    kq, ks = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32),
                             fold_scale=HD**-0.5)
    vq, vs = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32))
    kd = _rand(rng, (b, c_d, G, HD), dtype)
    vd = _rand(rng, (b, c_d, G, HD), dtype)
    mask = np.arange(c_d)[None, :] < rng.randint(1, c_d + 1, size=b)[:, None]
    return [q] + [np.asarray(x) for x in (kq, vq, ks, vs)] + [kd, vd, mask]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_bifurcated_attention_q8_matches(dtype, layout):
    rng = np.random.RandomState(3)
    arrs = _attn_case(dtype, layout, rng)
    ctx_mask = np.arange(50) > 7
    want = jq.bifurcated_attention_q8(
        *(jnp.asarray(x) for x in arrs[:7]), decode_mask=jnp.asarray(arrs[7]),
        context_mask=jnp.asarray(ctx_mask), ctx_layout=layout)
    got = tq.bifurcated_attention_q8(
        *(to_torch(x) for x in arrs[:7]),
        decode_mask=torch.as_tensor(arrs[7]),
        context_mask=torch.as_tensor(ctx_mask), ctx_layout=layout)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_q8_dispatch_matches_reference(dtype, layout):
    rng = np.random.RandomState(4)
    arrs = _attn_case(dtype, layout, rng, b=3, p=2, n=2, m_c=700, c_d=6)
    want = jops.bifurcated_decode_attention_q8(
        *(jnp.asarray(x) for x in arrs), interpret=True, ctx_layout=layout)
    got = tops.bifurcated_decode_attention_q8(
        *(to_torch(x) for x in arrs), ctx_layout=layout)
    assert got.shape == want.shape
    assert_close(got, want, dtype)
    # the einsum path computes the same function (the reference's 1e-5
    # int8-vs-oracle gate in fp32)
    ein = tq.bifurcated_attention_q8(
        *(to_torch(x) for x in arrs[:7]), decode_mask=torch.as_tensor(arrs[7]),
        ctx_layout=layout)
    assert_close(ein, got, dtype)


# ---- the model: one int8 decode step, and an int8 generate ----

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray, j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 24))
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _models(dtype):
    jm, tm = j_get_model(CFG_J), t_get_model(CFG_T)
    if dtype == "float32":  # keep the whole forward in fp32 on both sides
        jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
        tm._embed = lambda p, t: p["embed"][t]
    jp = jax.tree.map(jnp.asarray, PARAMS_NP)
    tp = params_from_numpy(PARAMS_NP, device="cpu", dtype=TORCH_DT[dtype])
    return jm, jp, tm, tp


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_decode_step_matches(impl, dtype):
    jm, jp, tm, tp = _models(dtype)
    rng = np.random.RandomState(5)
    b, c_d = 3, 6
    k = _rand(rng, (2, 24, 2, 16), dtype)
    v = _rand(rng, (2, 24, 2, 16), dtype)
    cj = jq.QuantBifurcatedCache.from_prefill(
        jnp.asarray(k), jnp.asarray(v), b, c_d, dtype=jnp.dtype(dtype))
    ct = tq.QuantBifurcatedCache.from_prefill(
        to_torch(k), to_torch(v), b, c_d, dtype=TORCH_DT[dtype])
    for step in range(2):
        toks = rng.randint(0, CFG_J.vocab_size, (b, 1))
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks), None, impl=impl)
        lt, ct = tm.decode_step(tp, ct, torch.as_tensor(toks), impl=impl)
        assert_close_logits(lt, lj, dtype)
        if dtype == "float32":
            assert_close(ct.k_dec, cj.k_dec, dtype)
        assert ct.dec_length == int(cj.dec_length) == step + 1


def test_int8_greedy_generate_matches_fp32():
    jm, jp, tm, tp = _models("float32")
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, use_kernel=True,
              cache_dtype="int8")
    je = JServeEngine(jm, CFG_J, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=0))
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw),
                      policy=TPolicy(min_io_saving_bytes=0))
    _, cache = te.prefill_shared(tp, torch.as_tensor(CTX), 3)
    assert isinstance(cache, tq.QuantBifurcatedCache)
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=5)
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=5)
    np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
    assert_close(rt.logprobs, rj.logprobs, "float32")
    # the policy's fallback ignores cache_dtype, as in the reference
    te_small = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw))
    _, cache = te_small.prefill_shared(tp, torch.as_tensor(CTX), 3)
    assert type(cache).__name__ == "DecodeCache"
    # the einsum path gives the same greedy tokens
    te_e = TServeEngine(tm, CFG_T, dataclasses.replace(
        tconfigs.ServeConfig(**kw), use_kernel=False),
        policy=TPolicy(min_io_saving_bytes=0))
    re_ = te_e.generate(tp, torch.as_tensor(CTX), n_steps=5)
    assert torch.equal(re_.tokens, rt.tokens)
