"""Port parity for multi-prefix FOREST serving: the grouped caches' write
and assign semantics, the forest einsum paths, the grouped kernels' plain
versions against the Pallas kernels in interpret mode, the grouped
dispatchers, and ``ForestServeEngine`` on the reduced internlm2 model with
converted weights — greedy tokens identical to the JAX engine and to
per-group single-prefix runs, plus the engine's lifecycle (EOS, readmission,
the capacity guard, typed rejections, no reallocation).

Tolerances: fp32 1e-5, bf16 2e-2 (``_torch_parity``); greedy tokens are
compared in fp32 (the whole forward patched to fp32 on both sides), where
token identity is a sound gate."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_np, to_torch
from repro.configs import ForestConfig as JForestConfig
from repro.configs import get_config, reduced_config
from repro.core import bifurcated as jbif
from repro.core import grouped as jgrp
from repro.core import quantized as jq
from repro.core.kv_cache import GroupedBifurcatedCache as JGrouped
from repro.kernels import bifurcated_decode as jbd
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.runtime.serve import ForestServeEngine as JForestEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import bifurcated as tbif
from repro_torch.core import grouped as tgrp
from repro_torch.core import quantized as tq
from repro_torch.core.errors import (
    CapacityError,
    DecodeCapacityExceeded,
    SegmentCapacityExceeded,
    SegmentsExhausted,
    SlotsExhausted,
)
from repro_torch.core.kv_cache import GroupedBifurcatedCache as TGrouped
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import ForestServeEngine, ServeEngine

DTYPES = ["float32", "bfloat16"]
G_KV, HD = 2, 16


def _rand(rng, shape, dtype="float32"):
    return np.asarray(jnp.asarray(rng.randn(*shape), dtype))


def test_forest_config_defaults_match():
    assert (dataclasses.asdict(JForestConfig())
            == dataclasses.asdict(tconfigs.ForestConfig()))


# ---- the grouped cache ----

@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_grouped_cache_write_and_assign_match(layout):
    """Admissions (one overwriting a longer segment), then slot assignment
    over slots whose decode arms hold stale KVs: the same tensors as the
    reference's functional updates, with the stale arms wiped and no tensor
    reallocated."""
    rng = np.random.RandomState(0)
    L, n_groups, slots, cap, c_d = 2, 3, 5, 20, 4
    cj = JGrouped.init(L, n_groups, slots, cap, c_d, G_KV, HD,
                       dtype=jnp.float32, ctx_layout=layout)
    ct = TGrouped.init(L, n_groups, slots, cap, c_d, G_KV, HD,
                       dtype=torch.float32, ctx_layout=layout, device="cpu")
    stale = _rand(rng, (L, slots, c_d, G_KV, HD))
    cj = dataclasses.replace(cj, k_dec=jnp.asarray(stale),
                             v_dec=jnp.asarray(stale),
                             dec_lens=jnp.full((slots,), 3, jnp.int32))
    ct.k_dec.copy_(to_torch(stale))
    ct.v_dec.copy_(to_torch(stale))
    ct.dec_lens.fill_(3)
    ptrs = [t.data_ptr() for t in (ct.k_ctx, ct.v_ctx, ct.ctx_lens,
                                   ct.group_ids, ct.k_dec, ct.dec_lens)]
    for m_new, gidx in ((17, 1), (20, 0), (6, 1)):
        k, v = _rand(rng, (L, m_new, G_KV, HD)), _rand(rng, (L, m_new, G_KV, HD))
        cj = cj.write_context(jnp.asarray(k), jnp.asarray(v), gidx)
        assert ct.write_context(to_torch(k), to_torch(v), gidx) is ct
    mask = np.array([False, True, True, False, True])
    cj = cj.assign_slots(jnp.asarray(mask), 1)
    ct.assign_slots(torch.as_tensor(mask), 1)
    for name in ("k_ctx", "v_ctx", "ctx_lens", "group_ids", "k_dec", "v_dec",
                 "dec_lens"):
        np.testing.assert_array_equal(to_np(getattr(ct, name)),
                                      np.asarray(getattr(cj, name)))
    assert not ct.k_dec[:, torch.as_tensor(mask)].any()     # wiped
    assert [t.data_ptr() for t in (ct.k_ctx, ct.v_ctx, ct.ctx_lens,
                                   ct.group_ids, ct.k_dec, ct.dec_lens)] == ptrs
    assert (ct.n_groups, ct.context_capacity, ct.n_slots,
            ct.decode_capacity) == (cj.n_groups, cj.context_capacity,
                                    cj.n_slots, cj.decode_capacity)
    assert tq.forest_cache_family("none") is TGrouped
    assert tq.forest_cache_family("int8") is tq.GroupedQuantBifurcatedCache


# ---- einsum paths ----

def _forest_case(dtype, layout, rng, n_groups=3, b=5, p=2, n=1, m_c=30,
                 c_d=4, quant=False):
    ctx = ((n_groups, G_KV, m_c, HD) if layout == "gmk"
           else (n_groups, m_c, G_KV, HD))
    q = _rand(rng, (b, G_KV, p, n, HD), dtype)
    if quant:
        kq, ks = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32),
                                 fold_scale=HD**-0.5)
        vq, vs = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32))
        ctx_arrs = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        ctx_arrs = [_rand(rng, ctx, dtype), _rand(rng, ctx, dtype)]
    # rows shuffled across groups; group 1 has no rows; a 0-length segment
    group_ids = np.array([2, 0, 2, 0, 2][:b], np.int32)
    ctx_lens = np.array([m_c, 11, 0][:n_groups], np.int32)
    if n_groups == 1:
        group_ids[:] = 0
    kd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    vd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    mask = np.arange(c_d)[None, :] < rng.randint(1, c_d + 1, size=b)[:, None]
    return [q] + ctx_arrs + [group_ids, ctx_lens, kd, vd, mask]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["gmk", "mgk"])
@pytest.mark.parametrize("quant", [False, True])
def test_forest_attention_matches(dtype, layout, quant):
    rng = np.random.RandomState(1)
    arrs = _forest_case(dtype, layout, rng, quant=quant)
    fj = jq.forest_bifurcated_attention_q8 if quant else jbif.forest_bifurcated_attention
    ft = tq.forest_bifurcated_attention_q8 if quant else tbif.forest_bifurcated_attention
    want = fj(*(jnp.asarray(x) for x in arrs[:-1]),
              decode_mask=jnp.asarray(arrs[-1]), ctx_layout=layout)
    got = ft(*(to_torch(x) for x in arrs[:-1]),
             decode_mask=torch.as_tensor(arrs[-1]), ctx_layout=layout)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_attention_oracle_matches(dtype):
    rng = np.random.RandomState(2)
    n_groups, s, m_c, m_d = 2, 3, 12, 4
    arrs = [_rand(rng, (n_groups, s, G_KV, 2, 1, HD), dtype),
            _rand(rng, (n_groups, m_c, G_KV, HD), dtype),
            _rand(rng, (n_groups, m_c, G_KV, HD), dtype),
            _rand(rng, (n_groups, s, m_d, G_KV, HD), dtype),
            _rand(rng, (n_groups, s, m_d, G_KV, HD), dtype)]
    lens = np.array([12, 5], np.int32)
    dmask = rng.rand(n_groups, s, m_d) < 0.7
    dmask[..., 0] = True
    want = jgrp.grouped_bifurcated_attention(
        *map(jnp.asarray, arrs), context_lengths=jnp.asarray(lens),
        decode_mask=jnp.asarray(dmask))
    got = tgrp.grouped_bifurcated_attention(
        *map(to_torch, arrs), context_lengths=torch.as_tensor(lens),
        decode_mask=torch.as_tensor(dmask))
    assert_close(got, want, dtype)


# ---- the grouped kernels' plain versions against the Pallas kernels ----

def _kernel_operands(arrs, quant, p, n):
    """Framework-layout ("gmk") forest case -> the kernels' operands, for
    the Pallas kernel (lane-replicated (rows, 128) map, (G, m_c) bias) and
    for the port ((rows,) map, ctx_lens)."""
    q, ctx, (group_ids, ctx_lens, kd, vd, mask) = (
        arrs[0], arrs[1:-5], arrs[-5:])
    b, c_d = kd.shape[:2]
    m_c = ctx[0].shape[2]
    qk = np.ascontiguousarray(q.transpose(1, 0, 2, 3, 4).reshape(G_KV, -1, HD))
    rows = np.repeat(group_ids, p * n).astype(np.int32)
    kdk = np.ascontiguousarray(kd.transpose(2, 0, 1, 3).reshape(G_KV, -1, HD))
    vdk = np.ascontiguousarray(vd.transpose(2, 0, 1, 3).reshape(G_KV, -1, HD))
    bias = np.where(mask.reshape(1, b * c_d), 0.0, -1e30).astype(np.float32)
    cbias = np.where(np.arange(m_c)[None, :] < ctx_lens[:, None], 0.0,
                     -1e30).astype(np.float32)
    jax_in = [qk, *ctx, np.broadcast_to(rows[:, None], (rows.size, 128)),
              cbias, kdk, vdk, bias]
    torch_in = [qk, *ctx, rows, ctx_lens, kdk, vdk, bias]
    return jax_in, torch_in


@pytest.mark.parametrize("n_groups", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_grouped_plain_matches_pallas(n_groups, dtype, quant):
    rng = np.random.RandomState(3)
    p, n, c_d = 2, 2, 4
    arrs = _forest_case(dtype, "gmk", rng, n_groups=n_groups, p=p, n=n,
                        m_c=300, c_d=c_d, quant=quant)
    jax_in, torch_in = _kernel_operands(arrs, quant, p, n)
    kw = dict(scale=HD**-0.5, c_d=c_d, pn=p * n)
    jk = jbd.grouped_fused_bifurcated_decode_q8 if quant else jbd.grouped_fused_bifurcated_decode
    tk = tbd.grouped_fused_bifurcated_decode_q8 if quant else tbd.grouped_fused_bifurcated_decode
    want = jk(*map(jnp.asarray, jax_in), block_m=128, interpret=True, **kw)
    launches = tk.launches
    got = tk(*map(to_torch, torch_in), **kw)   # CPU tensors: the plain version
    assert tk.launches == launches
    assert_close(got, want, dtype)
    if n_groups == 1:   # G = 1: exactly the single-prefix plain version
        t = [to_torch(x) for x in torch_in]
        if quant:
            one = tbd.fused_bifurcated_decode_q8_plain(
                t[0], t[1][0], t[2][0], t[3][0], t[4][0], *t[-3:], **kw)
        else:
            one = tbd.fused_bifurcated_decode_plain(t[0], t[1][0], t[2][0],
                                                    *t[-3:], **kw)
        assert torch.equal(got, one)


def test_grouped_plain_writes_nan_for_ids_outside_the_segments():
    rng = np.random.RandomState(4)
    arrs = _forest_case("float32", "gmk", rng, p=1, n=1)
    arrs[3] = np.array([2, 3, -1, 0, 2], np.int32)     # ids 3 and -1: none
    _, t_in = _kernel_operands(arrs, False, 1, 1)
    out = tbd.grouped_fused_bifurcated_decode(*map(to_torch, t_in),
                                              scale=0.25, c_d=4, pn=1)
    bad = torch.tensor([False, True, True, False, False])
    assert torch.isnan(out[:, bad]).all() and torch.isfinite(out[:, ~bad]).all()


@pytest.mark.parametrize("layout", ["gmk", "mgk"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
def test_grouped_dispatch_matches_reference(layout, dtype, quant):
    rng = np.random.RandomState(5)
    arrs = _forest_case(dtype, layout, rng, p=2, n=2, m_c=260, quant=quant)
    fj = (jops.grouped_bifurcated_decode_attention_q8 if quant
          else jops.grouped_bifurcated_decode_attention)
    ft = (tops.grouped_bifurcated_decode_attention_q8 if quant
          else tops.grouped_bifurcated_decode_attention)
    want = fj(*map(jnp.asarray, arrs), interpret=True, ctx_layout=layout)
    got = ft(*map(to_torch, arrs), ctx_layout=layout)
    assert got.shape == want.shape
    assert_close(got, want, dtype)


# ---- ForestServeEngine on the reduced model ----

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray, j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
RNG = np.random.RandomState(0)
CTX_A = RNG.randint(0, CFG_J.vocab_size, (1, 24))
CTX_B = RNG.randint(0, CFG_J.vocab_size, (1, 17))
CTX_C = RNG.randint(0, CFG_J.vocab_size, (1, 9))


def _torch_model():
    tm = t_get_model(CFG_T)
    tm._embed = lambda p, t: p["embed"][t]      # the forward in fp32
    return tm, params_from_numpy(PARAMS_NP, device="cpu", dtype=torch.float32)


TM, TP = _torch_model()


def _forest(cache_dtype="bfloat16", use_kernel=False, n_groups=2, slots=5,
            **kw):
    fcfg = tconfigs.ForestConfig(
        n_groups=n_groups, slots=slots, ctx_capacity=32, decode_capacity=16,
        cache_dtype=cache_dtype, use_kernel=use_kernel, **kw)
    eng = ForestServeEngine(TM, CFG_T, fcfg)
    st = eng.init_state(device="cpu")
    quant = "int8" if cache_dtype == "int8" else "none"
    # an fp32 cache, as _jax_forest builds the reference's
    return eng, dataclasses.replace(st, cache=TM.make_forest_cache(
        slots, n_groups, 32, 16, quant, dtype=torch.float32, device="cpu"))


def _single(ctx, batch, cache_dtype, use_kernel, n_steps=8):
    scfg = tconfigs.ServeConfig(batch=batch, decode_capacity=16,
                                temperature=0.0, top_p=1.0,
                                use_kernel=use_kernel, cache_dtype=cache_dtype)
    eng = ServeEngine(TM, CFG_T, scfg,
                      policy=TPolicy(min_io_saving_bytes=0, min_batch=1))
    return eng.generate(TP, torch.as_tensor(ctx), n_steps=n_steps).tokens


def _jax_forest(cache_dtype, use_kernel):
    """The reference engine in fp32: its forward patched to fp32 and its
    cache built in fp32 (its init_state stores bf16)."""
    jm = j_get_model(CFG_J)
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    fcfg = JForestConfig(n_groups=2, slots=5, ctx_capacity=32,
                         decode_capacity=16, cache_dtype=cache_dtype,
                         use_kernel=use_kernel)
    eng = JForestEngine(jm, CFG_J, fcfg)
    st = eng.init_state()
    quant = "int8" if cache_dtype == "int8" else "none"
    st = dataclasses.replace(st, cache=jq.forest_cache_family(quant).init(
        CFG_J.n_layers, 2, 5, 32, 16, CFG_J.n_kv_heads_padded, CFG_J.kq_dim,
        dtype=jnp.float32, ctx_layout=CFG_J.ctx_layout))
    return eng, st, jax.tree.map(jnp.asarray, PARAMS_NP)


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", False), ("bfloat16", True), ("int8", False), ("int8", True)])
def test_forest_matches_reference_and_per_group_single_prefix(cache_dtype,
                                                              use_kernel):
    """For G > 1 each group's greedy fp32 tokens are identical to the JAX
    ForestServeEngine's and to a per-group single-prefix ServeEngine run
    (bf16 and int8 segments, kernel and einsum paths)."""
    eng, st = _forest(cache_dtype, use_kernel)
    st, slots_a = eng.admit(TP, st, torch.as_tensor(CTX_A), 3)
    st, slots_b = eng.admit(TP, st, torch.as_tensor(CTX_B), 2)
    st = eng.step_chunk(TP, st, 7)
    je, jst, jp = _jax_forest(cache_dtype, use_kernel)
    jst, ja = je.admit(jp, jst, jnp.asarray(CTX_A), 3)
    jst, jb = je.admit(jp, jst, jnp.asarray(CTX_B), 2)
    jst = je.step_chunk(jp, jst, 7)
    assert (slots_a, slots_b) == (ja, jb)
    for s in range(5):
        assert eng.outputs[s] == je.outputs[s], s
        assert_close(torch.tensor(eng.logps[s]), np.array(je.logps[s]),
                     "float32")
    for ctx, slots in ((CTX_A, slots_a), (CTX_B, slots_b)):
        want = _single(ctx, len(slots), cache_dtype, use_kernel)
        got = torch.tensor([eng.outputs[s] for s in slots])
        assert torch.equal(got, want)
    assert eng.decode_dispatches == 1
    assert eng.occupancy(st) == {"live_slots": 5, "slots": 5}
    assert int(st.steps.sum()) == 5 * 7
    res = eng.result(slots_a[0])
    assert res.tokens.shape == (1, 8) and res.logprobs.shape == (1, 8)


def test_forest_readmission_reuses_slots_without_reallocation():
    """Retire a group, admit a new request into its segment and slots: the
    readmitted slots decode as a fresh engine does (stale decode arms are
    wiped), the other group is untouched, and no cache tensor is
    reallocated or reshaped."""
    eng, st = _forest(use_kernel=True)
    c = st.cache
    before = [(t.data_ptr(), tuple(t.shape)) for t in (
        c.k_ctx, c.v_ctx, c.ctx_lens, c.group_ids, c.k_dec, c.v_dec,
        c.dec_lens, st.tokens, st.active, st.steps)]
    st, slots_a = eng.admit(TP, st, torch.as_tensor(CTX_A), 2)
    st, slots_b = eng.admit(TP, st, torch.as_tensor(CTX_B), 2)
    st = eng.step_chunk(TP, st, 5)
    st = eng.cancel_group(st, eng.slot_group[slots_a[0]])
    assert eng.retire_groups(st) == [0]
    assert eng.release_retired(st) is st
    st, slots_c = eng.admit(TP, st, torch.as_tensor(CTX_C), 2)
    assert set(slots_c) == set(slots_a)
    st = eng.step_chunk(TP, st, 7)
    assert torch.equal(torch.tensor([eng.outputs[s] for s in slots_c]),
                       _single(CTX_C, 2, "bfloat16", True))
    assert torch.equal(torch.tensor([eng.outputs[s] for s in slots_b]),
                       _single(CTX_B, 2, "bfloat16", True, n_steps=13))
    c = st.cache
    after = [(t.data_ptr(), tuple(t.shape)) for t in (
        c.k_ctx, c.v_ctx, c.ctx_lens, c.group_ids, c.k_dec, c.v_dec,
        c.dec_lens, st.tokens, st.active, st.steps)]
    assert after == before


def test_forest_eos_inside_a_chunk_and_at_step_zero():
    eng0, st0 = _forest()
    st0, s0 = eng0.admit(TP, st0, torch.as_tensor(CTX_A), 2)
    st0 = eng0.step_chunk(TP, st0, 6)
    stream = eng0.outputs[s0[0]]
    eos = stream[3]
    k_eos = stream.index(eos)        # first emission of that token
    eng, st = _forest(eos_token=int(eos), pad_token=-7)
    st, slots = eng.admit(TP, st, torch.as_tensor(CTX_A), 2)
    st = eng.step_chunk(TP, st, 6)
    for s in slots:   # emits up to and including the EOS, then stops
        assert eng.outputs[s] == stream[:k_eos + 1]
    assert not bool(st.active.any())
    assert int(st.steps[slots[0]]) == k_eos
    # EOS at step 0: the first token retires the slot before it decodes
    eng2, st2 = _forest(eos_token=int(stream[0]))
    st2, slots2 = eng2.admit(TP, st2, torch.as_tensor(CTX_A), 2)
    assert not bool(st2.active[slots2].any())
    st2 = eng2.step_chunk(TP, st2, 3)
    assert all(eng2.outputs[s] == [stream[0]] for s in slots2)
    assert eng2.retire_groups(st2) == [0]


def test_forest_capacity_guard_and_typed_rejections():
    eng, st = _forest(n_groups=1, slots=3)
    with pytest.raises(SegmentCapacityExceeded) as e:
        eng.admit(TP, st, torch.zeros(1, 33, dtype=torch.long), 1)
    assert isinstance(e.value, ValueError) and not e.value.retryable
    with pytest.raises(SlotsExhausted) as e:
        eng.admit(TP, st, torch.as_tensor(CTX_C), 4)
    assert isinstance(e.value, RuntimeError) and e.value.retryable
    assert eng.group_live == [False] and eng.slot_group == [-1] * 3
    st, slots = eng.admit(TP, st, torch.as_tensor(CTX_C), 2)
    with pytest.raises(SegmentsExhausted) as e:
        eng.admit(TP, st, torch.as_tensor(CTX_C), 1)
    assert isinstance(e.value, CapacityError) and e.value.reason == "segments_exhausted"
    st = eng.step_chunk(TP, st, 10)
    with pytest.raises(DecodeCapacityExceeded):
        eng.step_chunk(TP, st, 7)        # 10 + 7 > 16
    assert eng.decode_dispatches == 1
    st = eng.step_chunk(TP, st, 6)       # exactly to capacity
    st = eng.deactivate_slots(st, slots)
    st = eng.step_chunk(TP, st, 7)       # no live slot: nothing to guard
    assert all(len(eng.outputs[s]) == 17 for s in slots)
    with pytest.raises(ValueError, match="ctx_store"):   # dense or paged
        ForestServeEngine(TM, CFG_T, tconfigs.ForestConfig(ctx_store="ring"))


def test_forest_non_finite_sentinel_stops_collecting_a_slot():
    eng, st = _forest()
    st, slots = eng.admit(TP, st, torch.as_tensor(CTX_A), 2)
    toks = torch.tensor([[5, 6], [7, 8]])
    lps = torch.tensor([[-1.0, float("nan")], [-2.0, -3.0]])
    eng._collect_emitted(toks, lps, torch.ones(2, 2, dtype=torch.bool))
    assert eng.corrupt_slots == {slots[1]}
    assert eng.outputs[slots[0]][1:] == [5, 7]
    assert eng.outputs[slots[1]][1:] == []
