"""Port parity for prefix-TRIE (cascade) serving: the trie caches' write,
assign and length semantics, the cascade einsum paths, the tree kernels'
plain versions and dispatchers against the reference's Pallas kernels in
interpret mode, the set semantics of a node repeated on one path, the NaN
rule for ids outside the node table, one decode step on a trie cache, and
``TreeServeEngine`` on the reduced internlm2 model with converted weights:
greedy tokens, trie refcounts and path tables equal to the JAX engine's
across admits with prefix reuse, a chunk, a cancel, a retire and a
readmit; a depth-1 trie equal to the port's forest engine; typed
rejections that mutate nothing.

Tolerances: fp32 1e-5, bf16 2e-2 (``_torch_parity``); the int8 node
values and scales are bit-equal; greedy tokens are compared in fp32 (the
whole forward patched to fp32 on both sides). Comparisons with the
reference use node ids in [-1, N) only: for an id outside, the reference's
einsum path clips it to node N - 1 and its Pallas kernel ignores the
level, while the port writes NaN (tested on the port alone)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import TreeConfig as JTreeConfig
from repro.configs import get_config, reduced_config
from repro.core import bifurcated as jbif
from repro.core import io_model as jio
from repro.core import quantized as jq
from repro.core.kv_cache import PrefixTreeCache as JTree
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import bifurcated as tbif
from repro_torch.core import io_model as tio
from repro_torch.core import quantized as tq
from repro_torch.core.errors import (
    SegmentCapacityExceeded,
    SegmentsExhausted,
    SlotsExhausted,
)
from repro_torch.core.kv_cache import PrefixTreeCache as TTree
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import ForestServeEngine, TreeServeEngine

DTYPES = ["float32", "bfloat16"]
G_KV, HD = 2, 16


def _rand(rng, shape, dtype="float32"):
    return np.asarray(jnp.asarray(rng.randn(*shape), dtype))


def test_tree_config_defaults_match():
    assert (dataclasses.asdict(JTreeConfig())
            == dataclasses.asdict(tconfigs.TreeConfig()))


# ---- the trie caches ----

@pytest.mark.parametrize("layout", ["gmk", "mgk"])
@pytest.mark.parametrize("quant", [False, True])
def test_tree_cache_write_assign_and_lens_match(layout, quant):
    """Node writes (one overwriting a longer node), then a path assignment
    over slots whose decode arms hold stale KVs: the same tensors as the
    reference's functional updates (int8 values and scales bit-equal), the
    stale arms wiped, the per-slot context lengths equal, and no tensor
    reallocated."""
    rng = np.random.RandomState(0)
    L, n_nodes, depth, slots, cap, c_d = 2, 4, 3, 5, 20, 4
    jfam = jq.tree_cache_family("int8" if quant else "none")
    tfam = tq.tree_cache_family("int8" if quant else "none")
    cj = jfam.init(L, n_nodes, depth, slots, cap, c_d, G_KV, HD,
                   dtype=jnp.float32, ctx_layout=layout)
    ct = tfam.init(L, n_nodes, depth, slots, cap, c_d, G_KV, HD,
                   dtype=torch.float32, ctx_layout=layout, device="cpu")
    stale = _rand(rng, (L, slots, c_d, G_KV, HD))
    cj = dataclasses.replace(cj, k_dec=jnp.asarray(stale),
                             v_dec=jnp.asarray(stale),
                             dec_lens=jnp.full((slots,), 3, jnp.int32))
    ct.k_dec.copy_(to_torch(stale))
    ct.v_dec.copy_(to_torch(stale))
    ct.dec_lens.fill_(3)
    names = ["k_ctx", "v_ctx", "node_lens", "paths", "k_dec", "v_dec",
             "dec_lens"] + (["k_scale", "v_scale"] if quant else [])
    ptrs = [getattr(ct, n).data_ptr() for n in names]
    for m_new, nid in ((17, 1), (20, 0), (6, 1), (11, 3)):
        k = _rand(rng, (L, m_new, G_KV, HD)) * 2
        v = _rand(rng, (L, m_new, G_KV, HD))
        cj = cj.write_node(jnp.asarray(k), jnp.asarray(v), nid)
        assert ct.write_node(to_torch(k), to_torch(v), nid) is ct
    for mask, col in (([True, True, False, False, True], [0, 1, -1]),
                      ([False, True, False, True, False], [0, 3, 1])):
        cj = cj.assign_paths(jnp.asarray(mask), jnp.asarray(col, jnp.int32))
        assert ct.assign_paths(torch.as_tensor(mask),
                               torch.tensor(col, dtype=torch.int32)) is ct
    for name in names:
        np.testing.assert_array_equal(to_np(getattr(ct, name)),
                                      np.asarray(getattr(cj, name)), name)
    np.testing.assert_array_equal(to_np(ct.slot_context_lens()),
                                  np.asarray(cj.slot_context_lens()))
    assert ct.slot_context_lens().tolist() == [20 + 6, 20 + 11 + 6, 0,
                                               20 + 11 + 6, 20 + 6]
    assert not ct.k_dec[:, [0, 1, 3, 4]].any()               # wiped
    assert [getattr(ct, n).data_ptr() for n in names] == ptrs
    assert (ct.n_nodes, ct.depth, ct.node_capacity, ct.n_slots,
            ct.decode_capacity) == (cj.n_nodes, cj.depth, cj.node_capacity,
                                    cj.n_slots, cj.decode_capacity)
    with pytest.raises(ValueError, match="capacity"):
        ct.write_node(torch.zeros(L, cap + 1, G_KV, HD),
                      torch.zeros(L, cap + 1, G_KV, HD), 0)
    assert tfam is (tq.QuantPrefixTreeCache if quant else TTree)


# ---- the cascade: einsum paths, plain versions, dispatchers ----

N_NODES, CAP = 5, 96
# a depth-3 trie: node 0 the shared root, 1 and 2 templates under it, 4 a
# leaf of length 0 under 2, 3 a standalone depth-1 prefix; slots 0/3 share
# the path (0, 1), slot 2 a level-3 path, slot 4 a depth-1 path
NODE_LENS = np.array([64, 96, 37, 50, 0], np.int32)
PATHS = np.array([[0, 0, 0, 0, 3, 0],
                  [1, 2, 2, 1, -1, 2],
                  [-1, 4, -1, -1, -1, -1]], np.int32)


def _trie_case(dtype, layout, rng, p=2, n=1, c_d=4, quant=False,
               paths=PATHS):
    b = paths.shape[1]
    ctx = ((N_NODES, G_KV, CAP, HD) if layout == "gmk"
           else (N_NODES, CAP, G_KV, HD))
    q = _rand(rng, (b, G_KV, p, n, HD), dtype)
    if quant:
        kq, ks = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32),
                                 fold_scale=HD**-0.5)
        vq, vs = jq.quantize_ctx(jnp.asarray(rng.randn(*ctx), jnp.float32))
        ctx_arrs = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        ctx_arrs = [_rand(rng, ctx, dtype), _rand(rng, ctx, dtype)]
    kd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    vd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    mask = np.arange(c_d)[None, :] < rng.randint(1, c_d + 1, size=b)[:, None]
    return [q] + ctx_arrs + [paths, NODE_LENS, kd, vd, mask]


def _einsum(quant, framework):
    if framework == "jax":
        return (jq.tree_bifurcated_attention_q8 if quant
                else jbif.tree_bifurcated_attention)
    return (tq.tree_bifurcated_attention_q8 if quant
            else tbif.tree_bifurcated_attention)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["gmk", "mgk"])
@pytest.mark.parametrize("quant", [False, True])
def test_tree_attention_matches(dtype, layout, quant):
    rng = np.random.RandomState(1)
    arrs = _trie_case(dtype, layout, rng, quant=quant)
    want = _einsum(quant, "jax")(*map(jnp.asarray, arrs[:-1]),
                                 decode_mask=jnp.asarray(arrs[-1]),
                                 ctx_layout=layout)
    got = _einsum(quant, "torch")(*map(to_torch, arrs[:-1]),
                                  decode_mask=torch.as_tensor(arrs[-1]),
                                  ctx_layout=layout)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["gmk", "mgk"])
@pytest.mark.parametrize("quant", [False, True])
def test_tree_dispatch_matches_reference(dtype, layout, quant):
    """The port's dispatcher, through the tree kernels' plain versions (CPU
    tensors), against the reference's dispatcher through its Pallas tree
    kernels in interpret mode, two fresh positions per slot; and the
    port's kernel path against its own einsum path."""
    rng = np.random.RandomState(2)
    arrs = _trie_case(dtype, layout, rng, n=2, quant=quant)
    fj = (jops.tree_bifurcated_decode_attention_q8 if quant
          else jops.tree_bifurcated_decode_attention)
    ft = (tops.tree_bifurcated_decode_attention_q8 if quant
          else tops.tree_bifurcated_decode_attention)
    kern = (tbd.tree_fused_bifurcated_decode_q8 if quant
            else tbd.tree_fused_bifurcated_decode)
    want = fj(*map(jnp.asarray, arrs), block_m=128, interpret=True,
              ctx_layout=layout)
    launches = kern.launches
    got = ft(*map(to_torch, arrs), ctx_layout=layout)
    assert kern.launches == launches          # CPU: the plain version
    assert got.shape == want.shape
    assert_close(got, want, dtype)
    t = [to_torch(x) for x in arrs]
    ein = _einsum(quant, "torch")(*t[:-1], decode_mask=t[-1],
                                  ctx_layout=layout)
    assert_close(got, ein, dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_tree_plain_at_depth_one_is_the_grouped_kernel(quant):
    """At depth 1 a row reads one node: the tree plain version equals the
    reference's grouped Pallas kernel (interpret mode) and computes the
    port's grouped plain version's bits."""
    from repro.kernels import bifurcated_decode as jbd

    rng = np.random.RandomState(3)
    paths = np.array([[2, 0, 2, 3, 0, 1]], np.int32)
    arrs = _trie_case("float32", "gmk", rng, quant=quant, paths=paths)
    q, ctx, (pth, lens, kd, vd, mask) = arrs[0], arrs[1:-5], arrs[-5:]
    kw = dict(scale=HD**-0.5, c_d=kd.shape[1], pn=2)
    qk, path_rows, kdk, vdk, bias = tops._slot_operands(
        to_torch(q), torch.as_tensor(pth), to_torch(kd), to_torch(vd),
        torch.as_tensor(mask))
    ctx_t = [to_torch(x) for x in ctx]
    lens_t = torch.as_tensor(lens)
    tree = (tbd.tree_fused_bifurcated_decode_q8 if quant
            else tbd.tree_fused_bifurcated_decode)
    grp = (tbd.grouped_fused_bifurcated_decode_q8 if quant
           else tbd.grouped_fused_bifurcated_decode)
    jgrp = (jbd.grouped_fused_bifurcated_decode_q8 if quant
            else jbd.grouped_fused_bifurcated_decode)
    got = tree(qk, *ctx_t, path_rows, lens_t, kdk, vdk, bias, **kw)
    row_group = path_rows[0].contiguous()
    assert torch.equal(got, grp(qk, *ctx_t, row_group, lens_t, kdk, vdk,
                                bias, **kw))
    cbias = np.where(np.arange(CAP)[None, :] < lens[:, None], 0.0,
                     -1e30).astype(np.float32)
    want = jgrp(jnp.asarray(to_np(qk)), *map(jnp.asarray, ctx),
                jnp.broadcast_to(jnp.asarray(to_np(row_group))[:, None],
                                 (row_group.numel(), 128)),
                jnp.asarray(cbias), jnp.asarray(to_np(kdk)),
                jnp.asarray(to_np(vdk)), jnp.asarray(to_np(bias)),
                block_m=128, interpret=True, **kw)
    assert_close(got, want, "float32")


def test_tree_duplicate_node_in_path_set_semantics():
    """A node id repeated at several levels of one path contributes ONCE:
    the port's plain kernel path and einsum path equal the single-
    occurrence path exactly, and the reference's kernel."""
    rng = np.random.RandomState(4)
    dup = np.array([[0, 0, 0, 0, 3, 2], [0, 1, 0, 0, 3, 2],
                    [0, 0, 0, 1, -1, 2]], np.int32)
    single = np.array([[0, 0, 0, 0, 3, 2], [-1, 1, -1, -1, -1, -1],
                       [-1, -1, -1, 1, -1, -1]], np.int32)
    arrs = _trie_case("float32", "gmk", rng, paths=dup)
    t = [to_torch(x) for x in arrs]
    one = t[:3] + [torch.as_tensor(single)] + t[4:]
    k_dup = tops.tree_bifurcated_decode_attention(*t)
    assert torch.equal(k_dup, tops.tree_bifurcated_decode_attention(*one))
    e_dup = tbif.tree_bifurcated_attention(*t[:-1], decode_mask=t[-1])
    assert torch.equal(e_dup, tbif.tree_bifurcated_attention(
        *one[:-1], decode_mask=one[-1]))
    want = jops.tree_bifurcated_decode_attention(
        *map(jnp.asarray, arrs), block_m=128, interpret=True)
    assert_close(k_dup, want, "float32")
    assert_close(e_dup, want, "float32")


@pytest.mark.parametrize("quant", [False, True])
def test_tree_paths_outside_the_node_table_give_nan(quant):
    rng = np.random.RandomState(5)
    paths = PATHS.copy()
    paths[1, 1] = N_NODES          # past the table
    paths[0, 4] = -2               # below -1
    arrs = _trie_case("float32", "gmk", rng, quant=quant, paths=paths)
    t = [to_torch(x) for x in arrs]
    bad = torch.tensor([False, True, False, False, True, False])
    outs = (tops.tree_bifurcated_decode_attention_q8 if quant
            else tops.tree_bifurcated_decode_attention)(*t), \
        _einsum(quant, "torch")(*t[:-1], decode_mask=t[-1])
    for out in outs:
        assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()


def test_tree_kernel_wrappers_check_their_operands():
    rng = np.random.RandomState(6)
    t = [to_torch(x) for x in _trie_case("float32", "gmk", rng)]
    qk, path_rows, kd, vd, bias = tops._slot_operands(t[0], t[3], t[5], t[6],
                                                      t[7])
    args = [qk, t[1], t[2], path_rows, t[4], kd, vd, bias]
    kw = dict(scale=0.25, c_d=4, pn=2)
    with pytest.raises(TypeError, match="int32"):
        tbd.tree_fused_bifurcated_decode(
            *args[:3], path_rows.long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="do not fit"):
        tbd.tree_fused_bifurcated_decode(
            *args[:3], path_rows[:, :-2].contiguous(), *args[4:], **kw)
    with pytest.raises(ValueError, match="depth"):
        tbd.tree_fused_bifurcated_decode(
            *args[:3], path_rows.repeat(12, 1), *args[4:], **kw)


# ---- the model's decode step on a trie cache ----

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray,
                         j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
RNG = np.random.RandomState(0)
SYS = RNG.randint(0, CFG_J.vocab_size, (1, 12))      # shared root
TPL = RNG.randint(0, CFG_J.vocab_size, (1, 6))       # template
REQ_A = RNG.randint(0, CFG_J.vocab_size, (1, 9))
REQ_B = RNG.randint(0, CFG_J.vocab_size, (1, 7))
REQ_C = RNG.randint(0, CFG_J.vocab_size, (1, 5))


def _torch_model():
    tm = t_get_model(CFG_T)
    tm._embed = lambda p, t: p["embed"][t]      # the forward in fp32
    return tm, params_from_numpy(PARAMS_NP, device="cpu", dtype=torch.float32)


TM, TP = _torch_model()
# the served model: bf16 weights and activations
TM_BF16 = t_get_model(CFG_T)
TP_BF16 = params_from_numpy(PARAMS_NP, device="cpu")


def _jax_model():
    jm = j_get_model(CFG_J)
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    return jm, jax.tree.map(jnp.asarray, PARAMS_NP)


@pytest.mark.parametrize("impl,quant,dtype", [
    ("einsum", False, "float32"), ("kernel", False, "float32"),
    ("einsum", True, "float32"), ("kernel", True, "float32"),
    ("kernel", False, "bfloat16")])
def test_decode_step_on_a_tree_cache_matches(impl, quant, dtype):
    """One decode step of the model over a depth-3 trie cache with random
    nodes and decode arms at per-slot depths: logits and the written decode
    arms equal the reference's (its einsum path), and dec_lens advance."""
    rng = np.random.RandomState(7)
    L, hd, g = CFG_J.n_layers, CFG_J.kq_dim, CFG_J.n_kv_heads_padded
    b, cap, c_d = PATHS.shape[1], 40, 8
    jfam = jq.tree_cache_family("int8" if quant else "none")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cj = jfam.init(L, N_NODES, 3, b, cap, c_d, g, hd, dtype=jdt)
    ct = TM.make_tree_cache(b, N_NODES, 3, cap, c_d,
                            "int8" if quant else "none", dtype=tdt,
                            device="cpu")
    for nid, m in enumerate([30, 40, 17, 25, 0]):
        if m:
            k, v = (_rand(rng, (L, m, g, hd), dtype) for _ in range(2))
            cj = cj.write_node(jnp.asarray(k), jnp.asarray(v), nid)
            ct.write_node(to_torch(k), to_torch(v), nid)
    dec_lens = np.array([3, 0, 5, 1, 2, 4], np.int32)
    kd, vd = (_rand(rng, (L, b, c_d, g, hd), dtype) for _ in range(2))
    cj = dataclasses.replace(cj, paths=jnp.asarray(PATHS),
                             k_dec=jnp.asarray(kd), v_dec=jnp.asarray(vd),
                             dec_lens=jnp.asarray(dec_lens))
    for name, x in (("paths", PATHS), ("k_dec", kd), ("v_dec", vd),
                    ("dec_lens", dec_lens)):
        getattr(ct, name).copy_(to_torch(x))
    tokens = rng.randint(0, CFG_J.vocab_size, (b, 1))
    jm, jp = _jax_model()
    if dtype == "bfloat16":
        jm, jp = j_get_model(CFG_J), jax.tree.map(jnp.asarray, PARAMS_NP)
        tm, tp = t_get_model(CFG_T), params_from_numpy(PARAMS_NP,
                                                       device="cpu")
    else:
        tm, tp = TM, TP
    lj, cj2 = jm.decode_step(jp, cj, jnp.asarray(tokens), None)
    lt, ct2 = tm.decode_step(tp, ct, torch.as_tensor(tokens), impl=impl)
    assert ct2 is ct
    assert_close_logits(lt, lj, dtype)
    assert ct.dec_lens.tolist() == (dec_lens + 1).tolist()
    if dtype == "float32":
        assert_close(ct.k_dec, cj2.k_dec, dtype)
        assert_close(ct.v_dec, cj2.v_dec, dtype)


# ---- TreeServeEngine ----

def _tree(cache_dtype="bfloat16", use_kernel=False, n_nodes=6, depth=3,
          slots=6, fp32=True, **kw):
    """A tree engine on the CPU: the fp32 model with an fp32 cache (as
    _jax_tree builds the reference's), or the served bf16 model with its
    bf16 cache."""
    tcfg = tconfigs.TreeConfig(
        n_nodes=n_nodes, depth=depth, slots=slots, node_capacity=32,
        decode_capacity=16, cache_dtype=cache_dtype, use_kernel=use_kernel,
        **kw)
    eng = TreeServeEngine(TM if fp32 else TM_BF16, CFG_T, tcfg)
    st = eng.init_state(device="cpu")
    if fp32:
        quant = "int8" if cache_dtype == "int8" else "none"
        st = dataclasses.replace(st, cache=TM.make_tree_cache(
            slots, n_nodes, depth, 32, 16, quant, dtype=torch.float32,
            device="cpu"))
    return eng, st


def _segs(*segs, framework="torch"):
    conv = torch.as_tensor if framework == "torch" else jnp.asarray
    return [conv(s) for s in segs]


def _lifecycle(eng, st, params, framework):
    """Admit [SYS,TPL,REQ_A], [SYS,REQ_B], [SYS,TPL,REQ_B] (2 slots each),
    a chunk of 5, cancel and retire request 0, readmit [SYS,TPL,REQ_C],
    a chunk of 4; returns (state, slots per admit, io bytes per step and
    the trie mirrors after each phase)."""
    f = framework
    snaps, slots = [], []
    for path in ((SYS, TPL, REQ_A), (SYS, REQ_B), (SYS, TPL, REQ_B)):
        st, s = eng.admit(params, st, _segs(*path, framework=f), 2)
        slots.append(s)
    st = eng.step_chunk(params, st, 5)
    snaps.append((eng.step_io_bytes(st), list(eng.node_refs),
                  list(eng.node_live), np.asarray(to_np(st.cache.paths))))
    st = eng.cancel_request(st, 0)
    assert eng.retire_requests(st) == [0]
    snaps.append((list(eng.node_refs), list(eng.node_live),
                  eng.request_sharing(1), eng.request_sharing(2)))
    st, s = eng.admit(params, st, _segs(SYS, TPL, REQ_C, framework=f), 2)
    slots.append(s)
    st = eng.step_chunk(params, st, 4)
    snaps.append((eng.step_io_bytes(st), list(eng.node_refs),
                  list(eng.node_live), np.asarray(to_np(st.cache.paths)),
                  dict(eng.prefix_stats), eng.occupancy(st)))
    return st, slots, snaps


@functools.lru_cache(maxsize=None)
def _jax_tree(cache_dtype):
    """The reference engine's lifecycle in fp32: its forward patched to
    fp32 and its cache built in fp32 (its init_state stores bf16)."""
    jm, jp = _jax_model()
    tcfg = JTreeConfig(n_nodes=6, depth=3, slots=6, node_capacity=32,
                       decode_capacity=16, cache_dtype=cache_dtype)
    eng = JTreeEngine(jm, CFG_J, tcfg)
    st = eng.init_state()
    quant = "int8" if cache_dtype == "int8" else "none"
    st = dataclasses.replace(st, cache=jq.tree_cache_family(quant).init(
        CFG_J.n_layers, 6, 3, 6, 32, 16, CFG_J.n_kv_heads_padded,
        CFG_J.kq_dim, dtype=jnp.float32, ctx_layout=CFG_J.ctx_layout))
    _, slots, snaps = _lifecycle(eng, st, jp, "jax")
    return eng.outputs, eng.logps, slots, snaps


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", False), ("bfloat16", True), ("int8", False), ("int8", True)])
def test_tree_engine_matches_reference(cache_dtype, use_kernel):
    """fp32 greedy tokens and log-probs equal to the JAX TreeServeEngine's
    across three admits with prefix reuse, a chunk, a cancel and retire of
    one request and a readmit that reuses two levels; node refcounts, live
    nodes, path tables, prefix statistics and step IO bytes equal too; no
    cache tensor is reallocated."""
    eng, st = _tree(cache_dtype, use_kernel)
    c = st.cache
    ptrs = [t.data_ptr() for t in (c.k_ctx, c.v_ctx, c.node_lens, c.paths,
                                   c.k_dec, c.v_dec, c.dec_lens)]
    st, slots, snaps = _lifecycle(eng, st, TP, "torch")
    j_out, j_logps, j_slots, j_snaps = _jax_tree(cache_dtype)
    assert slots == j_slots
    for s in range(6):
        assert eng.outputs[s] == j_out[s], s
        assert_close(torch.tensor(eng.logps[s]), np.array(j_logps[s]),
                     "float32")
    for got, want in zip(snaps, j_snaps):
        for a, b in zip(got, want):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (a, b)
    assert snaps[0][1][:5] == [3, 2, 1, 1, 1]       # root shared by three
    assert snaps[2][4]["partial_hits"] == 3 and snaps[2][4]["admits"] == 4
    c = st.cache
    assert [t.data_ptr() for t in (c.k_ctx, c.v_ctx, c.node_lens, c.paths,
                                   c.k_dec, c.v_dec, c.dec_lens)] == ptrs
    assert eng.decode_dispatches == 2


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", False), ("bfloat16", True), ("int8", False), ("int8", True)])
def test_depth_one_trie_matches_the_forest(cache_dtype, use_kernel):
    """With every request a single segment the trie serves the flat
    forest's workload: greedy tokens identical to ForestServeEngine's (bf16
    model and caches as served, bf16 and int8 nodes, einsum and kernel
    paths)."""
    eng, st = _tree(cache_dtype, use_kernel, n_nodes=2, depth=1, slots=5,
                    fp32=False)
    st, ta = eng.admit(TP_BF16, st, _segs(REQ_A), 3)
    st, tb = eng.admit(TP_BF16, st, _segs(REQ_B), 2)
    st = eng.step_chunk(TP_BF16, st, 7)
    feng = ForestServeEngine(TM_BF16, CFG_T, tconfigs.ForestConfig(
        n_groups=2, slots=5, ctx_capacity=32, decode_capacity=16,
        cache_dtype=cache_dtype, use_kernel=use_kernel))
    fs = feng.init_state(device="cpu")
    fs, fa = feng.admit(TP_BF16, fs, torch.as_tensor(REQ_A), 3)
    fs, fb = feng.admit(TP_BF16, fs, torch.as_tensor(REQ_B), 2)
    fs = feng.step_chunk(TP_BF16, fs, 7)
    assert ta + tb == fa + fb
    for s in ta + tb:
        assert eng.outputs[s] == feng.outputs[s]
        assert eng.logps[s] == feng.logps[s]


def test_tree_engine_typed_rejections_mutate_nothing():
    eng, st = _tree(n_nodes=2, depth=2, slots=3)
    st, _ = eng.admit(TP, st, _segs(SYS, REQ_A), 2)
    c = st.cache
    before = (list(eng.node_live), list(eng.node_refs), dict(eng.node_index),
              list(eng.slot_request), dict(eng.requests), eng.next_rid,
              dict(eng.prefix_stats), c.paths.clone(), c.node_lens.clone(),
              st.active.clone())
    with pytest.raises(SegmentsExhausted, match="free trie node") as e:
        eng.admit(TP, st, _segs(SYS, REQ_B), 1)     # root reused, no leaf
    assert e.value.retryable
    with pytest.raises(SlotsExhausted, match="free slots"):
        eng.admit(TP, st, _segs(SYS, REQ_A), 2)     # full hit, no slots
    with pytest.raises(ValueError, match="levels"):
        eng.admit(TP, st, _segs(SYS, TPL, REQ_A), 1)
    with pytest.raises(SegmentCapacityExceeded, match="node capacity") as e:
        eng.admit(TP, st, [torch.zeros(1, 33, dtype=torch.long)], 1)
    assert isinstance(e.value, ValueError) and not e.value.retryable
    after = (list(eng.node_live), list(eng.node_refs), dict(eng.node_index),
             list(eng.slot_request), dict(eng.requests), eng.next_rid,
             dict(eng.prefix_stats), c.paths.clone(), c.node_lens.clone(),
             st.active.clone())
    for a, b in zip(before, after):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    # a full-path hit admits without a free node and writes nothing
    assert eng.peek_prefix(_segs(SYS, REQ_A)) == ([0, 1], 2, 12 + 9)
    st, s = eng.admit(TP, st, _segs(SYS, REQ_A), 1)
    assert eng.node_refs == [2, 2] and eng.prefix_stats["full_hits"] == 1
    # the prefix-cache knobs construct an engine with an empty cache
    for knob in (dict(ctx_store="paged", prefix_cache=True),
                 dict(prefix_cache=True),
                 dict(evict_policy="sharing")):
        assert TreeServeEngine(
            TM, CFG_T, tconfigs.TreeConfig(**knob)).cached_nodes() == []


def test_tree_engine_retire_frees_shared_root_last():
    eng, st = _tree(n_nodes=4, depth=2, slots=4)
    st, sa = eng.admit(TP, st, _segs(SYS, REQ_A), 2)
    st, sb = eng.admit(TP, st, _segs(SYS, REQ_B), 2)
    st = eng.deactivate_slots(st, sa)
    assert eng.retire_requests(st) == [0]
    assert eng.node_live[0] and not eng.node_live[1]   # root still held
    assert eng.release_retired(st) is st
    st = eng.cancel_request(st, 1)
    assert eng.cancel_request(st, 0) is st              # retired: no-op
    assert eng.retire_requests(st) == [1]
    assert not any(eng.node_live) and eng.node_index == {}
    assert eng.requests.keys() == {0, 1}                # slots still read
    st, s = eng.admit(TP, st, _segs(REQ_B), 2)
    assert s == sa and 0 not in eng.requests            # compacted
    assert eng.request_live(2) and not eng.request_live(0)


def test_tree_io_bytes_match_reference():
    paths = [(0, 1 + i % 4) for i in range(16)] + [(5,), (0, 2, 6)]
    lens = [2048, 1000, 700, 300, 33, 512, 64]
    want = jio.tree_decode_io_bytes(paths=paths, node_lens=lens, c_d=32,
                                    g=8, hd=128)
    got = tio.tree_decode_io_bytes(paths=paths, node_lens=lens, c_d=32,
                                   g=8, hd=128)
    assert got == {k: want[k] for k in ("per_node", "total")}
