"""Port parity for the PAGED context store: the page stores' in-place writes
with shuffled page ids, ``PageAllocator`` on one scripted sequence, the
live-page list and ``gather_pages``, the paged kernels' plain versions and
dispatchers against the reference's Pallas paged kernels in interpret
mode (page sizes that do and do not divide 64, holes, free segments,
oversubscribed pools), one decode step on each paged family, and the
three engines with ``ctx_store="paged"`` on the reduced internlm2 model
with converted weights against the reference's paged engines: greedy
tokens, page tables, ``free_count``, ``node_pages`` and refcounts across
admit, retire, ``release_retired`` and readmit; typed rejections that
mutate nothing.

Tolerances: fp32 1e-5, bf16 2e-2 of max |ref| (``_torch_parity``); the
stores' bf16 and int8 values and scales are bit-equal; tokens are compared
in fp32 only (the whole forward patched to fp32 on both sides, fp32 pools
on both sides): the reference's own bf16 paged and dense kernel paths
disagree on tokens (ROADMAP Queue 3). Comparisons with the reference use
ids in [-1, N) and page ids in [-1, P) only; outside them the port writes
NaN rows (tested on the port alone)."""
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
from repro.core.errors import AllocatorCorruption as JAllocatorCorruption
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.runtime.serve import ForestServeEngine as JForestEngine
from repro.runtime.serve import ServeEngine as JServeEngine
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import paged as tpaged
from repro_torch.core.errors import (
    AllocatorCorruption,
    PoolExhausted,
    SegmentCapacityExceeded,
)
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import (
    ForestServeEngine,
    ServeEngine,
    TreeServeEngine,
)

G_KV, HD = 2, 16


def _rand(rng, shape, dtype="float32"):
    return np.asarray(jnp.asarray(rng.randn(*shape), dtype))


# ---- the stores ----

@pytest.mark.parametrize("quant", [False, True])
def test_store_writes_match_in_place(quant):
    """Writes onto shuffled page ids (one overwriting a segment with a
    shorter context), a clear, and a write of 0 tokens: the same pools,
    scales, tables and lengths as the reference's functional updates (bf16
    values and int8 values and scales bit-equal), and no tensor
    reallocated."""
    rng = np.random.RandomState(0)
    L, n_seg, ppn, P, pm = 2, 4, 3, 9, 8
    jfam = jpaged.paged_store_family("int8" if quant else "none")
    tfam = tpaged.paged_store_family("int8" if quant else "none")
    sj = jfam.init(L, n_seg, ppn, P, G_KV, HD, page_m=pm)
    st = tfam.init(L, n_seg, ppn, P, G_KV, HD, page_m=pm, device="cpu")
    names = ["k_pages", "v_pages", "page_tables", "seg_lens"] + (
        ["k_scale_pages", "v_scale_pages"] if quant else [])
    ptrs = [getattr(st, n).data_ptr() for n in names]
    for m_new, seg, ids in ((20, 1, [7, 2, 5]), (8, 0, [0]),
                            (17, 3, [3, 8, 1]), (5, 1, [6]), (0, 2, [])):
        k = _rand(rng, (L, m_new, G_KV, HD), "bfloat16")
        v = _rand(rng, (L, m_new, G_KV, HD), "bfloat16")
        sj = sj.write_segment(jnp.asarray(k), jnp.asarray(v), seg, ids)
        assert st.write_segment(to_torch(k), to_torch(v), seg, ids) is st
    sj, _ = sj.clear_segment(3), st.clear_segment(3)
    for name in names:
        np.testing.assert_array_equal(to_np(getattr(st, name)),
                                      to_np(getattr(sj, name)), name)
    assert [getattr(st, n).data_ptr() for n in names] == ptrs
    for got, want in zip(st.dense_ctx(), sj.dense_ctx()):
        np.testing.assert_array_equal(to_np(got), to_np(want))
    assert (st.num_pages, st.n_segments, st.pages_per_segment,
            st.segment_capacity) == (sj.num_pages, sj.n_segments,
                                     sj.pages_per_segment,
                                     sj.segment_capacity)
    with pytest.raises(SegmentCapacityExceeded):
        st.write_segment(torch.zeros(L, 25, G_KV, HD),
                         torch.zeros(L, 25, G_KV, HD), 0, [0, 1, 2, 3])
    with pytest.raises(ValueError, match="needs 2 pages"):
        st.write_segment(torch.zeros(L, 9, G_KV, HD),
                         torch.zeros(L, 9, G_KV, HD), 0, [0])


def test_page_allocator_matches_reference():
    """One scripted sequence of alloc / share / release / plan_eviction /
    audit on both allocators: the same results and state after every
    step, the same typed errors, each atomic (the state unchanged), and
    planted corruption caught by both audits."""
    ja, ta = jpaged.PageAllocator(6), tpaged.PageAllocator(6)

    def both(fn):
        outs = []
        for a, err in ((ja, JAllocatorCorruption),
                       (ta, AllocatorCorruption)):
            before = a.state_dict()
            try:
                outs.append(("ok", fn(a)))
            except (err, PoolExhausted, jpaged.PoolExhausted) as e:
                assert a.state_dict() == before     # atomic
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1], outs
        assert ja.state_dict() == ta.state_dict()
        return outs[1]

    assert both(lambda a: a.alloc(3)) == ("ok", [0, 1, 2])
    assert both(lambda a: a.alloc(4))[0] == "PoolExhausted"
    assert both(lambda a: a.share([1, np.int64(2)]))[0] == "ok"
    assert both(lambda a: a.share([4]))[0] == "AllocatorCorruption"
    assert both(lambda a: a.release([0, 1])) == ("ok", [0])
    assert both(lambda a: a.release([2, 2, 2]))[0] == "AllocatorCorruption"
    assert both(lambda a: a.release([9]))[0] == "AllocatorCorruption"
    assert both(lambda a: a.alloc(4)) == ("ok", [3, 4, 5, 0])
    assert both(lambda a: a.plan_eviction(3, [(7, 1), (8, 2), (9, 5)])) \
        == ("ok", [7, 8])
    assert both(lambda a: a.plan_eviction(0, [(7, 1)])) == ("ok", [])
    assert both(lambda a: a.plan_eviction(9, [(7, 1)])) == ("ok", None)
    rows = [[3, 4, -1], [5, 0, -1], [1, 2, -1]]
    tracked = [3, 4, 5, 0, 1, 2, 2]
    assert both(lambda a: a.audit(rows=rows, tracked=tracked)) == ("ok",
                                                                  True)
    assert both(lambda a: a.audit(rows=[[3, 4], [4, 0]]))[0] \
        == "AllocatorCorruption"                   # aliased rows
    assert both(lambda a: a.audit(tracked=tracked[:-1]))[0] \
        == "AllocatorCorruption"                   # refcount drift
    state = ta.state_dict()
    assert tpaged.PageAllocator(6).load_state_dict(state).state_dict() \
        == state
    for a in (ja, ta):                             # a page freed twice
        a._free.append(3)
    assert both(lambda a: a.audit())[0] == "AllocatorCorruption"
    with pytest.raises(AllocatorCorruption):
        tpaged.PageAllocator(6).load_state_dict(state | {"num_pages": 5})


# ---- the live-page list, gather_pages ----

# 5 segments over a pool of 13 pages of 8: segment 0 full, 1 ragged with a
# hole at its second page, 2 free (-1 row, length 0), 3 one page, 4 of
# length 0 holding a stale page; an entry past 3's live length
TABLES = np.array([[4, 11, 0, 7], [9, -1, 2, -1], [-1, -1, -1, -1],
                   [12, 5, -1, -1], [6, -1, -1, -1]], np.int32)
LENS = np.array([32, 21, 0, 3, 0], np.int32)


def test_live_page_list_and_gather_pages_match():
    got = tops.live_page_list(torch.as_tensor(TABLES),
                              torch.as_tensor(LENS), 8)
    want = jops.live_page_list(jnp.asarray(TABLES), jnp.asarray(LENS), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert int(got[2][0]) == 4 + 2 + 1
    pages = np.random.RandomState(1).randn(2, 13, G_KV, 8, HD).astype(
        np.float32)
    for seg_axis, x in ((1, pages), (0, pages[0]), (1, pages[..., 0])):
        np.testing.assert_array_equal(
            to_np(tpaged.gather_pages(torch.as_tensor(x),
                                      torch.as_tensor(TABLES), seg_axis)),
            np.asarray(jpaged.gather_pages(jnp.asarray(x),
                                           jnp.asarray(TABLES), seg_axis)))


# ---- the paged kernels' plain versions and dispatchers ----

CAP, N_SEG = 96, 5
SEG_LENS = np.array([64, 96, 37, 50, 0], np.int32)
PATHS = np.array([[0, 0, 0, 0, 3, 0],
                  [1, 2, 2, 1, -1, 2],
                  [-1, 4, -1, -1, -1, -1]], np.int32)


def _paged_case(dtype, rng, pm, p=2, n=1, c_d=4, quant=False, spare=3,
                hole=False, paths=PATHS):
    """A trie of 5 segments stored on shuffled pool pages of ``pm`` tokens,
    ``spare`` pool pages more than the live ones (free pages and the live
    pages' tails hold finite garbage): [q, pool arrays, tables, lens,
    paths, k_dec, v_dec, dec_mask] as numpy."""
    b = paths.shape[1]
    ppn = -(-CAP // pm)
    need = [-(-int(m) // pm) for m in SEG_LENS]
    n_pages = sum(need) + spare
    perm = rng.permutation(n_pages)
    tables = np.full((N_SEG, ppn), -1, np.int32)
    at = 0
    for s, k in enumerate(need):
        tables[s, :k] = perm[at:at + k]
        at += k
    if hole:
        tables[1, 1] = -1          # inside segment 1's 96 live keys
    shape = (n_pages, G_KV, pm, HD)
    q = _rand(rng, (b, G_KV, p, n, HD), dtype)
    if quant:
        kq, ks = jpaged.quantize_ctx(jnp.asarray(rng.randn(*shape),
                                                 jnp.float32),
                                     fold_scale=HD**-0.5)
        vq, vs = jpaged.quantize_ctx(jnp.asarray(rng.randn(*shape),
                                                 jnp.float32))
        pool = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        pool = [_rand(rng, shape, dtype), _rand(rng, shape, dtype)]
    kd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    vd = _rand(rng, (b, c_d, G_KV, HD), dtype)
    mask = np.arange(c_d)[None, :] < rng.randint(1, c_d + 1, size=b)[:, None]
    return [q] + pool + [tables, SEG_LENS, paths, kd, vd, mask]


def _dispatchers(quant):
    if quant:
        return (jops.paged_bifurcated_decode_attention_q8,
                tops.paged_bifurcated_decode_attention_q8)
    return (jops.paged_bifurcated_decode_attention,
            tops.paged_bifurcated_decode_attention)


@pytest.mark.parametrize("dtype,quant,pm,hole", [
    ("float32", False, 16, False), ("float32", False, 48, True),
    ("float32", True, 32, True), ("float32", True, 100, False),
    ("bfloat16", False, 64, False), ("bfloat16", True, 48, True)])
def test_paged_dispatch_matches_reference(dtype, quant, pm, hole):
    """The port's paged dispatcher, through the kernels' plain versions
    (CPU tensors), against the reference's through its Pallas paged
    kernels in interpret mode, two fresh positions per slot; page sizes
    that divide 64 and that do not, a hole inside a live length; and,
    without a hole, against the port's tree dispatcher on the gathered
    dense slabs."""
    rng = np.random.RandomState(2)
    arrs = _paged_case(dtype, rng, pm, n=2, quant=quant, hole=hole)
    fj, ft = _dispatchers(quant)
    kern = (tbd.paged_fused_bifurcated_decode_q8 if quant
            else tbd.paged_fused_bifurcated_decode)
    want = fj(*map(jnp.asarray, arrs), interpret=True)
    launches = kern.launches
    t = [to_torch(x) for x in arrs]
    got = ft(*t)
    assert kern.launches == launches          # CPU: the plain version
    assert got.shape == want.shape
    if dtype == "float32":
        assert_close(got, want, dtype)
    else:
        g, w = to_np(got), to_np(want)
        assert np.max(np.abs(g - w)) <= 2e-2 * np.max(np.abs(w))
    if not hole:
        n_pool = 4 if quant else 2
        dense = [tpaged.gather_pages(x, t[1 + n_pool]) for x in
                 t[1:1 + n_pool]]
        tree = (tops.tree_bifurcated_decode_attention_q8 if quant
                else tops.tree_bifurcated_decode_attention)
        lens, paths = t[2 + n_pool], t[3 + n_pool]
        ref = tree(t[0], *dense, paths, lens, *t[4 + n_pool:])
        assert_close(got, ref, dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_rows_outside_the_tables_give_nan(quant):
    """Rows whose path holds an id outside [-1, N), or a segment whose
    live pages name an id outside [-1, P), come out NaN in the plain
    versions (as in the kernels); the other rows equal a run without the
    bad ids, and a bad id past a segment's live length changes nothing."""
    rng = np.random.RandomState(3)
    arrs = _paged_case("float32", rng, 32, quant=quant)
    n_pool = 4 if quant else 2
    ti, pi = 1 + n_pool, 3 + n_pool
    t = [to_torch(x) for x in arrs]
    f = _dispatchers(quant)[1]
    clean = f(*t)
    paths = t[pi].clone()
    paths[1, 1] = N_SEG            # past the segment table
    paths[0, 4] = -2               # below -1
    tables = t[ti].clone()
    tables[2, 0] = 10_000          # a live page of segment 2, outside the pool
    tables[3, 2] = 10_000          # past segment 3's live length: not read
    t2 = list(t)
    t2[ti], t2[pi] = tables, paths
    out = f(*t2)
    bad = torch.tensor([False, True, True, False, True, True])   # 2 on paths
    assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()
    assert torch.equal(out[~bad], clean[~bad])


def test_paged_free_pages_are_never_read():
    """NaN in every pool page no table entry names (and in the live pages'
    tails past their segment's length) leaves the output bit-identical."""
    rng = np.random.RandomState(4)
    arrs = _paged_case("float32", rng, 16, spare=4)
    t = [to_torch(x) for x in arrs]
    clean = tops.paged_bifurcated_decode_attention(*t)
    tables, lens = t[3], t[4]
    used = set(tables[tables >= 0].tolist())
    k, v = t[1].clone(), t[2].clone()
    for pid in range(k.shape[0]):
        if pid not in used:
            k[pid] = float("nan")
            v[pid] = float("nan")
    for s in range(N_SEG):
        m = int(lens[s])
        if m % 16:
            pid = int(tables[s, m // 16])
            k[pid, :, m % 16:] = float("nan")
            v[pid, :, m % 16:] = float("nan")
    out = tops.paged_bifurcated_decode_attention(t[0], k, v, *t[3:])
    assert torch.equal(out, clean)


def test_paged_kernel_wrappers_check_their_operands():
    rng = np.random.RandomState(5)
    t = [to_torch(x) for x in _paged_case("float32", rng, 32)]
    qk, path_rows, kd, vd, bias = tops._slot_operands(t[0], t[5], t[6], t[7],
                                                      t[8])
    args = [qk, t[1], t[2], t[3], t[4], path_rows, kd, vd, bias]
    kw = dict(scale=0.25, c_d=4, pn=2)
    fn = tbd.paged_fused_bifurcated_decode
    with pytest.raises(TypeError, match="int32"):
        fn(*args[:3], t[3].long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="do not fit"):
        fn(*args[:5], path_rows[:, :-2].contiguous(), *args[6:], **kw)
    with pytest.raises(ValueError, match="depth"):
        fn(*args[:5], path_rows.repeat(12, 1), *args[6:], **kw)
    with pytest.raises(ValueError, match="page pool"):
        fn(qk, t[1][:, :1], t[2][:, :1], *args[3:], **kw)
    with pytest.raises(TypeError, match="dtype"):
        fn(qk, t[1].double(), t[2].double(), *args[3:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fn(qk, t[1].transpose(0, 1).contiguous().transpose(0, 1), *args[2:],
           **kw)


# ---- the model's decode step on the paged families ----

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
CTX_A = RNG.randint(0, CFG_J.vocab_size, (1, 20))
CTX_B = RNG.randint(0, CFG_J.vocab_size, (1, 17))
CTX_C = RNG.randint(0, CFG_J.vocab_size, (1, 30))


def _torch_model():
    tm = t_get_model(CFG_T)
    tm._embed = lambda p, t: p["embed"][t]      # the forward in fp32
    return tm, params_from_numpy(PARAMS_NP, device="cpu", dtype=torch.float32)


def _jax_model():
    jm = j_get_model(CFG_J)
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    return jm, jax.tree.map(jnp.asarray, PARAMS_NP)


TM, TP = _torch_model()


@pytest.mark.parametrize("family,quant,impl", [
    ("tree", False, "kernel"), ("tree", True, "kernel"),
    ("tree", False, "einsum"), ("tree", True, "einsum"),
    ("forest", False, "kernel"), ("single", True, "kernel")])
def test_decode_step_on_paged_caches_matches(family, quant, impl):
    """One fp32 decode step over a paged trie / forest / single-prefix
    cache (contents written onto shuffled pages of 8, decode arms at
    per-slot depths): logits and the written decode arms equal the
    reference's (its einsum path), and equal the port's own dense trie
    cache on the same logical contents; the decode lengths advance."""
    rng = np.random.RandomState(7)
    L, hd, g = CFG_J.n_layers, CFG_J.kq_dim, CFG_J.n_kv_heads_padded
    ctx_quant = "int8" if quant else "none"
    b, cap, c_d, pm = 6, 40, 8, 8
    lens = {"tree": [30, 40, 17, 25, 0], "forest": [30, 17, 25],
            "single": [33]}[family]
    paths = {"tree": PATHS, "forest": np.array([[2, 0, 1, 1, 0, 2]],
                                               np.int32),
             "single": np.zeros((1, b), np.int32)}[family]
    n_seg, depth = len(lens), paths.shape[0]
    dec_lens = (np.full(b, 3, np.int32) if family == "single"
                else np.array([3, 0, 5, 1, 2, 4], np.int32))
    kv = [[_rand(rng, (L, m, g, hd)) for _ in range(2)] for m in lens]
    kd, vd = (_rand(rng, (L, b, c_d, g, hd)) for _ in range(2))
    tokens = rng.randint(0, CFG_J.vocab_size, (b, 1))
    perm = list(rng.permutation(sum(-(-m // pm) for m in lens) + 2))
    ids = []
    for m in lens:
        k = -(-m // pm)
        ids.append([int(i) for i in perm[:k]])
        del perm[:k]
    if family == "single":
        ids = [list(range(-(-lens[0] // pm)))]
        cj = jpaged.PagedBifurcatedCache.from_prefill(
            jnp.asarray(kv[0][0]), jnp.asarray(kv[0][1]), b, c_d,
            dtype=jnp.float32, page_m=pm, ctx_quant=ctx_quant)
        cj = dataclasses.replace(cj, k_dec=jnp.asarray(kd),
                                 v_dec=jnp.asarray(vd),
                                 dec_length=jnp.asarray(3, jnp.int32))
        ct = tpaged.PagedBifurcatedCache.from_prefill(
            to_torch(kv[0][0]), to_torch(kv[0][1]), b, c_d,
            dtype=torch.float32, page_m=pm, ctx_quant=ctx_quant)
        ct.k_dec.copy_(to_torch(kd))
        ct.v_dec.copy_(to_torch(vd))
        ct = dataclasses.replace(ct, dec_length=3)
    else:
        n_pages = sum(len(i) for i in ids) + 2
        if family == "tree":
            cj = jpaged.PagedPrefixTreeCache.init(
                L, n_seg, depth, b, cap, c_d, g, hd, dtype=jnp.float32,
                page_m=pm, num_pages=n_pages, ctx_quant=ctx_quant)
            ct = TM.make_paged_cache(b, n_seg, depth, cap, page_m=pm,
                                     num_pages=n_pages, dec_capacity=c_d,
                                     ctx_quant=ctx_quant,
                                     dtype=torch.float32, device="cpu")
        else:
            cj = jpaged.PagedGroupedBifurcatedCache.init(
                L, n_seg, b, cap, c_d, g, hd, dtype=jnp.float32, page_m=pm,
                num_pages=n_pages, ctx_quant=ctx_quant)
            ct = tpaged.PagedGroupedBifurcatedCache.init(
                L, n_seg, b, cap, c_d, g, hd, dtype=torch.float32, page_m=pm,
                num_pages=n_pages, ctx_quant=ctx_quant, device="cpu")
        write = "write_node" if family == "tree" else "write_context"
        for s, ((k, v), pids) in enumerate(zip(kv, ids)):
            if pids:
                cj = getattr(cj, write)(jnp.asarray(k), jnp.asarray(v), s,
                                        pids)
                getattr(ct, write)(to_torch(k), to_torch(v), s, pids)
        table = ("paths", paths) if family == "tree" else (
            "group_ids", paths[0])
        cj = dataclasses.replace(cj, **{table[0]: jnp.asarray(table[1])},
                                 k_dec=jnp.asarray(kd),
                                 v_dec=jnp.asarray(vd),
                                 dec_lens=jnp.asarray(dec_lens))
        for name, x in (table, ("k_dec", kd), ("v_dec", vd),
                        ("dec_lens", dec_lens)):
            getattr(ct, name).copy_(to_torch(x))
    jm, jp = _jax_model()
    lj, cj2 = jm.decode_step(jp, cj, jnp.asarray(tokens), None)
    k_dec0, v_dec0 = ct.k_dec.clone(), ct.v_dec.clone()
    lt, ct2 = TM.decode_step(TP, ct, torch.as_tensor(tokens), impl=impl)
    assert_close_logits(lt, lj, "float32")
    assert_close(ct2.k_dec, cj2.k_dec, "float32")
    assert_close(ct2.v_dec, cj2.v_dec, "float32")
    if family == "single":
        assert ct2.dec_length == 4
    else:
        assert ct2 is ct and ct.dec_lens.tolist() == (dec_lens + 1).tolist()
    # the port's dense trie cache over the same logical contents
    dense = TM.make_tree_cache(b, n_seg, depth, cap, c_d, ctx_quant,
                               dtype=torch.float32, device="cpu")
    for s, (k, v) in enumerate(kv):
        if k.shape[1]:
            dense.write_node(to_torch(k), to_torch(v), s)
    dense.paths.copy_(torch.as_tensor(paths))
    dense.k_dec.copy_(k_dec0)
    dense.v_dec.copy_(v_dec0)
    dense.dec_lens.copy_(torch.as_tensor(dec_lens))
    ld, _ = TM.decode_step(TP, dense, torch.as_tensor(tokens), impl=impl)
    assert_close(lt, ld, "float32")


# ---- the engines with ctx_store="paged" ----

def _forest_cfg(cls, cache_dtype, use_kernel):
    return cls(n_groups=3, slots=6, ctx_capacity=32, decode_capacity=16,
               cache_dtype=cache_dtype, use_kernel=use_kernel,
               ctx_store="paged", page_size=8, num_pages=9)


def _forest_lifecycle(eng, st, params, conv):
    """Admit A (20 tokens, 3 pages) and B (17, 3 pages) on a 9-page pool,
    a chunk of 4; C (30 tokens, 4 pages) is rejected with PoolExhausted;
    cancel and retire A, release, readmit C, a chunk of 4. Returns the
    state and snapshots of the pool after each phase."""
    snaps = []
    st, sa = eng.admit(params, st, conv(CTX_A), 2)
    st, sb = eng.admit(params, st, conv(CTX_B), 2)
    st = eng.step_chunk(params, st, 4)
    snaps.append((sa, sb, eng.page_alloc.free_count(), dict(eng.group_pages),
                  to_np(st.cache.store.page_tables).copy(),
                  eng.occupancy(st)))
    with pytest.raises(PoolExhausted if conv is torch.as_tensor
                       else jpaged.PoolExhausted):
        eng.admit(params, st, conv(CTX_C), 2)
    snaps.append((eng.page_alloc.free_count(), list(eng.group_live),
                  to_np(st.cache.store.page_tables).copy()))
    st = eng.cancel_group(st, 0)
    assert eng.retire_groups(st) == [0]
    snaps.append((eng.page_alloc.free_count(), dict(eng.group_pages)))
    st = eng.release_retired(st)
    st, sc = eng.admit(params, st, conv(CTX_C), 2)
    st = eng.step_chunk(params, st, 4)
    snaps.append((sc, eng.page_alloc.free_count(), dict(eng.group_pages),
                  to_np(st.cache.store.page_tables).copy(),
                  to_np(st.cache.store.seg_lens).copy()))
    return st, snaps


@functools.lru_cache(maxsize=None)
def _jax_forest(cache_dtype):
    jm, jp = _jax_model()
    fcfg = _forest_cfg(JForestConfig, cache_dtype, False)
    eng = JForestEngine(jm, CFG_J, fcfg)
    st = eng.init_state()
    st = dataclasses.replace(st, cache=jpaged.PagedGroupedBifurcatedCache.init(
        CFG_J.n_layers, 3, 6, 32, 16, CFG_J.n_kv_heads_padded, CFG_J.kq_dim,
        dtype=jnp.float32, page_m=8, num_pages=9,
        ctx_quant="int8" if cache_dtype == "int8" else "none"))
    _, snaps = _forest_lifecycle(eng, st, jp, jnp.asarray)
    return eng.outputs, eng.logps, snaps


def _assert_snaps_equal(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, np.asarray(y))
            else:
                assert x == y, (x, y)


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", True), ("int8", True), ("bfloat16", False)])
def test_forest_engine_paged_matches_reference(cache_dtype, use_kernel):
    """fp32 greedy tokens and log-probs, page tables, group pages and the
    allocator's free count equal the JAX paged ForestServeEngine's across
    two admits on an oversubscribed pool, a rejected admit, a cancel and
    retire, ``release_retired`` and a readmit into the freed pages; the
    rejection mutates nothing, the released pages leave the live-page
    list, and no cache tensor is reallocated."""
    eng = ForestServeEngine(TM, CFG_T, _forest_cfg(
        tconfigs.ForestConfig, cache_dtype, use_kernel))
    st = eng.init_state(device="cpu")
    quant = "int8" if cache_dtype == "int8" else "none"
    st = dataclasses.replace(st, cache=tpaged.PagedGroupedBifurcatedCache.init(
        CFG_T.n_layers, 3, 6, 32, 16, CFG_T.n_kv_heads_padded, CFG_T.kq_dim,
        dtype=torch.float32, page_m=8, num_pages=9, ctx_quant=quant,
        device="cpu"))
    store = st.cache.store
    ptrs = [t.data_ptr() for t in (store.k_pages, store.page_tables,
                                   store.seg_lens, st.cache.k_dec)]
    n_live = []
    orig = eng.release_retired

    def release(state):
        n_live.append(int(tops.live_page_list(
            store.page_tables, store.seg_lens, 8)[2][0]))
        out = orig(state)
        n_live.append(int(tops.live_page_list(
            store.page_tables, store.seg_lens, 8)[2][0]))
        return out

    eng.release_retired = release
    st, snaps = _forest_lifecycle(eng, st, TP, torch.as_tensor)
    j_out, j_logps, j_snaps = _jax_forest(cache_dtype)
    for s in range(6):
        assert eng.outputs[s] == j_out[s], s
        assert_close(torch.tensor(eng.logps[s]), np.array(j_logps[s]),
                     "float32")
    _assert_snaps_equal(snaps, j_snaps)
    assert snaps[0][2] == 3 and snaps[2][0] == 6 and snaps[3][1] == 2
    assert snaps[0][5]["pages_free"] == 3 and snaps[0][5]["pages_total"] == 9
    # the explicit release_retired after the retire drops A's 3 pages
    assert n_live[-4:-2] == [3 + 3, 3]
    assert [t.data_ptr() for t in (store.k_pages, store.page_tables,
                                   store.seg_lens, st.cache.k_dec)] == ptrs
    eng.page_alloc.audit(rows=[to_np(store.page_tables)[g] for g in range(3)
                               if eng.group_live[g]],
                         tracked=sum(eng.group_pages.values(), []))


def _tree_cfg(cls, cache_dtype, use_kernel):
    return cls(n_nodes=6, depth=3, slots=7, node_capacity=32,
               decode_capacity=16, cache_dtype=cache_dtype,
               use_kernel=use_kernel, ctx_store="paged", page_size=8,
               num_pages=8)


def _segs(*segs, framework="torch"):
    conv = torch.as_tensor if framework == "torch" else jnp.asarray
    return [conv(s) for s in segs]


def _tree_lifecycle(eng, st, params, framework):
    """Admit [SYS,TPL,REQ_A] (5 pages), [SYS,REQ_B] (1 new page),
    [SYS,TPL,REQ_B] (1) on an 8-page pool, a chunk of 5; [SYS,REQ_A] (2
    pages) is rejected with PoolExhausted; cancel and retire request 0
    (its leaf's 2 pages return), readmit [SYS,TPL,REQ_C] (1 page), a chunk
    of 4. Returns snapshots of the trie's and the pool's state."""
    f = framework
    exc = PoolExhausted if f == "torch" else jpaged.PoolExhausted
    snaps = []
    for path in ((SYS, TPL, REQ_A), (SYS, REQ_B), (SYS, TPL, REQ_B)):
        st, _ = eng.admit(params, st, _segs(*path, framework=f), 2)
        snaps.append((eng.page_alloc.free_count(), dict(eng.node_pages)))
    st = eng.step_chunk(params, st, 5)
    with pytest.raises(exc):
        eng.admit(params, st, _segs(SYS, REQ_A, framework=f), 1)
    snaps.append((list(eng.node_refs), list(eng.node_live),
                  eng.page_alloc.free_count(),
                  to_np(st.cache.store.page_tables).copy()))
    st = eng.cancel_request(st, 0)
    assert eng.retire_requests(st) == [0]
    snaps.append((list(eng.node_refs), eng.page_alloc.free_count(),
                  dict(eng.node_pages)))
    st = eng.release_retired(st)
    snaps.append((to_np(st.cache.store.page_tables).copy(),
                  to_np(st.cache.store.seg_lens).copy()))
    st, _ = eng.admit(params, st, _segs(SYS, TPL, REQ_C, framework=f), 2)
    st = eng.step_chunk(params, st, 4)
    snaps.append((list(eng.node_refs), eng.page_alloc.free_count(),
                  dict(eng.node_pages),
                  to_np(st.cache.store.page_tables).copy(),
                  to_np(st.cache.paths).copy(), dict(eng.prefix_stats),
                  eng.page_alloc.state_dict()))
    return st, snaps


@functools.lru_cache(maxsize=None)
def _jax_tree(cache_dtype):
    jm, jp = _jax_model()
    eng = JTreeEngine(jm, CFG_J, _tree_cfg(JTreeConfig, cache_dtype, False))
    st = eng.init_state()
    st = dataclasses.replace(st, cache=jpaged.PagedPrefixTreeCache.init(
        CFG_J.n_layers, 6, 3, 7, 32, 16, CFG_J.n_kv_heads_padded,
        CFG_J.kq_dim, dtype=jnp.float32, page_m=8, num_pages=8,
        ctx_quant="int8" if cache_dtype == "int8" else "none"))
    _, snaps = _tree_lifecycle(eng, st, jp, "jax")
    return eng.outputs, eng.logps, snaps


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", True), ("int8", True), ("int8", False)])
def test_tree_engine_paged_matches_reference(cache_dtype, use_kernel):
    """fp32 greedy tokens and log-probs, node refcounts, node pages, page
    tables, path tables, the allocator's state and the prefix statistics
    equal the JAX paged TreeServeEngine's: reused ancestors allocate no
    pages, a rejected admission mutates nothing, a retired leaf's pages
    return while its shared ancestors keep theirs."""
    eng = TreeServeEngine(TM, CFG_T, _tree_cfg(tconfigs.TreeConfig,
                                               cache_dtype, use_kernel))
    st = eng.init_state(device="cpu")
    st = dataclasses.replace(st, cache=TM.make_paged_cache(
        7, 6, 3, 32, page_m=8, num_pages=8, dec_capacity=16,
        ctx_quant="int8" if cache_dtype == "int8" else "none",
        dtype=torch.float32, device="cpu"))
    st, snaps = _tree_lifecycle(eng, st, TP, "torch")
    j_out, j_logps, j_snaps = _jax_tree(cache_dtype)
    for s in range(7):
        assert eng.outputs[s] == j_out[s], s
        assert_close(torch.tensor(eng.logps[s]), np.array(j_logps[s]),
                     "float32")
    _assert_snaps_equal(snaps, j_snaps)
    assert [s[0] for s in snaps[:3]] == [3, 2, 1]       # 5, then 1 and 1
    assert snaps[6][1] == 2 and snaps[4][1] == 3
    occ = eng.occupancy(st)
    assert occ["pages_free"] == 2 and occ["pages_cached"] == 0
    rows = [to_np(st.cache.store.page_tables)[n] for n in range(6)
            if eng.node_live[n]]
    assert eng.page_alloc.audit(rows=rows, tracked=sum(
        eng.node_pages.values(), []))


@pytest.mark.parametrize("cache_dtype,use_kernel", [
    ("bfloat16", True), ("int8", True), ("bfloat16", False)])
def test_serve_engine_paged_matches_reference(cache_dtype, use_kernel):
    """ServeEngine.generate with ctx_store="paged" (pages of 8 over a
    24-token context, fp32): greedy tokens equal the JAX paged engine's
    and the port's dense engine's."""
    ctx = CTX_A[:, :19]
    kw = dict(batch=3, decode_capacity=16, temperature=0.0, top_p=1.0,
              cache_dtype=cache_dtype, page_size=8)
    jm, jp = _jax_model()
    je = JServeEngine(jm, CFG_J, JServeConfig(
        use_kernel=False, ctx_store="paged", **kw),
        policy=JPolicy(min_io_saving_bytes=0, min_batch=1))
    want = np.asarray(je.generate(jp, jnp.asarray(ctx), n_steps=6).tokens)
    toks = {}
    for store in ("paged", "dense"):
        te = ServeEngine(TM, CFG_T, tconfigs.ServeConfig(
            use_kernel=use_kernel, ctx_store=store, **kw),
            policy=TPolicy(min_io_saving_bytes=0, min_batch=1))
        _, cache = te.prefill_shared(TP, torch.as_tensor(ctx), 3)
        assert (type(cache).__name__ == "PagedBifurcatedCache") == (
            store == "paged")
        toks[store] = te.generate(TP, torch.as_tensor(ctx), n_steps=6).tokens
    np.testing.assert_array_equal(toks["paged"].numpy(), want)
    assert torch.equal(toks["paged"], toks["dense"])


def test_paged_typed_rejections_mutate_nothing():
    """PoolExhausted (too few free pages) and SegmentCapacityExceeded
    (longer than the envelope) are raised before any mutation: the
    allocator, the host mirrors and the device tables are unchanged."""
    eng = ForestServeEngine(TM, CFG_T, tconfigs.ForestConfig(
        n_groups=2, slots=4, ctx_capacity=24, decode_capacity=8,
        ctx_store="paged", page_size=8, num_pages=4))
    st = eng.init_state(device="cpu")
    st, _ = eng.admit(TP, st, torch.as_tensor(CTX_B), 2)     # 3 pages
    store = st.cache.store

    def snapshot():
        return (eng.page_alloc.state_dict(), list(eng.group_live),
                dict(eng.group_pages), list(eng.slot_group),
                store.page_tables.clone(), store.seg_lens.clone(),
                st.active.clone())

    before = snapshot()
    with pytest.raises(PoolExhausted) as e:
        eng.admit(TP, st, torch.as_tensor(CTX_A), 1)        # 3 > 1 free
    assert isinstance(e.value, RuntimeError) and e.value.retryable
    with pytest.raises(SegmentCapacityExceeded) as e:
        eng.admit(TP, st, torch.as_tensor(CTX_C), 1)        # 30 > 24
    assert isinstance(e.value, ValueError) and not e.value.retryable
    teng = TreeServeEngine(TM, CFG_T, tconfigs.TreeConfig(
        n_nodes=4, depth=2, slots=4, node_capacity=16, decode_capacity=8,
        ctx_store="paged", page_size=8, num_pages=2))
    tst = teng.init_state(device="cpu")
    tst, _ = teng.admit(TP, tst, _segs(SYS), 1)             # 2 pages
    tb = (teng.page_alloc.state_dict(), list(teng.node_live),
          dict(teng.node_pages), dict(teng.prefix_stats))
    with pytest.raises(PoolExhausted):
        teng.admit(TP, tst, _segs(SYS, REQ_B), 1)           # root reused
    with pytest.raises(SegmentCapacityExceeded):
        teng.admit(TP, tst, _segs(SYS, CTX_B), 1)
    after = snapshot()
    for a, b in zip(before, after):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    assert tb == (teng.page_alloc.state_dict(), list(teng.node_live),
                  dict(teng.node_pages), dict(teng.prefix_stats))
