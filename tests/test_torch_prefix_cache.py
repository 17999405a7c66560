"""Port parity for the trie engine's cross-request PREFIX CACHE
(``TreeConfig(prefix_cache=True, evict_policy=...)``): the reference's
``tests/test_prefix_cache.py`` cases, each run on the port's
``TreeServeEngine`` and on the reference's on the same admissions, with
the integrity surface (``audit_state(verify_checksums=True)``,
``host_state`` / ``load_host_state``) on both sides where the reference's
case uses it. After
every admission, step and retirement the two engines must hold the same
cache entries and LRU stamps (``cached_nodes()``, ``node_cached``,
``lru_clock``), the same trie (live bits, refcounts, lengths, index), the
same ``prefix_stats`` and ``occupancy``, and the same free nodes and free
pool pages; each case also asserts what the reference's test asserts.

Both engines run in fp32 (the forward patched to fp32, fp32 stores in
place of the reference's bf16 ones), so greedy tokens are compared
exactly. Log-probs: 1e-5, and 1e-3 for int8 nodes (a K/V value at a
round-half-even boundary may quantize to neighbouring int8 values on the
two sides, as in ``tests/test_torch_packed.py``). The acceptance case runs
the cached engine under ``train_attn="flash"`` (kernel #12's plain version
on the CPU) against the evict-eagerly baseline."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TreeConfig as JTreeConfig
from repro.configs import get_config, reduced_config
from repro.core import paged as jpaged
from repro.core import quantized as jq
from repro.models import get_model as j_get_model
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.errors import SegmentsExhausted
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import TreeServeEngine

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray,
                         j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
JP = jax.tree.map(jnp.asarray, PARAMS_NP)
TP = params_from_numpy(PARAMS_NP, device="cpu", dtype=torch.float32)
RNG = np.random.RandomState(7)                  # the reference test's prompts
SYS = RNG.randint(0, CFG_J.vocab_size, (1, 12))
TPL = RNG.randint(0, CFG_J.vocab_size, (1, 6))
REQ_A = RNG.randint(0, CFG_J.vocab_size, (1, 9))
REQ_B = RNG.randint(0, CFG_J.vocab_size, (1, 7))
SEGS = [RNG.randint(0, CFG_J.vocab_size, (1, 10)) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _models(train_attn):
    """The JAX and torch models of the reduced config, forward in fp32."""
    jm = j_get_model(dataclasses.replace(CFG_J, train_attn=train_attn))
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    tm = t_get_model(dataclasses.replace(CFG_T, train_attn=train_attn))
    tm._embed = lambda p, t: p["embed"][t]
    return jm, tm


def _jax_state(eng, tcfg):
    st = eng.init_state()
    quant = "int8" if tcfg.cache_dtype == "int8" else "none"
    dims = (CFG_J.n_layers, tcfg.n_nodes, tcfg.depth, tcfg.slots,
            tcfg.node_capacity, tcfg.decode_capacity,
            CFG_J.n_kv_heads_padded, CFG_J.kq_dim)
    if tcfg.ctx_store == "paged":
        cache = jpaged.PagedPrefixTreeCache.init(
            *dims, dtype=jnp.float32, page_m=tcfg.page_size,
            num_pages=eng.num_pages, ctx_quant=quant)
    else:
        cache = jq.tree_cache_family(quant).init(
            *dims, dtype=jnp.float32, ctx_layout=CFG_J.ctx_layout)
    return dataclasses.replace(st, cache=cache)


def _torch_state(eng, tm, tcfg):
    st = eng.init_state(device="cpu")
    quant = "int8" if tcfg.cache_dtype == "int8" else "none"
    if tcfg.ctx_store == "paged":
        cache = tm.make_paged_cache(
            tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
            page_m=tcfg.page_size, num_pages=eng.num_pages,
            dec_capacity=tcfg.decode_capacity, ctx_quant=quant,
            dtype=torch.float32, device="cpu")
    else:
        cache = tm.make_tree_cache(
            tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
            tcfg.decode_capacity, quant, dtype=torch.float32, device="cpu")
    return dataclasses.replace(st, cache=cache)


class Pair:
    """The reference's engine and the port's on one config, driven with the
    same calls; ``check`` holds their host state equal."""

    def __init__(self, train_attn="chunked", **kw):
        kw = {**dict(n_nodes=6, depth=3, slots=6, node_capacity=32,
                     decode_capacity=16, temperature=0.0), **kw}
        jm, tm = _models(train_attn)
        jcfg, tcfg = JTreeConfig(**kw), tconfigs.TreeConfig(**kw)
        self.j = JTreeEngine(jm, dataclasses.replace(CFG_J,
                                                     train_attn=train_attn),
                             jcfg)
        self.t = TreeServeEngine(tm, dataclasses.replace(
            CFG_T, train_attn=train_attn), tcfg)
        self.js, self.ts = _jax_state(self.j, jcfg), _torch_state(self.t, tm,
                                                                   tcfg)
        self.check()

    def admit(self, segs, n):
        self.js, sj = self.j.admit(JP, self.js,
                                   [jnp.asarray(s) for s in segs], n)
        self.ts, st = self.t.admit(TP, self.ts,
                                   [torch.as_tensor(s) for s in segs], n)
        assert st == sj and self.t.last_rid == self.j.last_rid
        self.check()
        return st

    def step(self, n):
        self.js = self.j.step_chunk(JP, self.js, n)
        self.ts = self.t.step_chunk(TP, self.ts, n)
        self.check()

    def retire(self, slots):
        """Deactivate ``slots`` on both and run retirement, as a serve loop
        does."""
        self.js = dataclasses.replace(self.js, active=self.js.active & ~jnp.isin(
            jnp.arange(self.j.tcfg.slots), jnp.asarray(slots)))
        rj = self.j.retire_requests(self.js)
        self.ts = self.t.deactivate_slots(self.ts, slots)
        assert self.t.retire_requests(self.ts) == rj
        self.check()

    def check(self):
        j, t = self.j, self.t
        assert t.cached_nodes() == j.cached_nodes()
        assert t.node_cached == j.node_cached and t.lru_clock == j.lru_clock
        assert t.prefix_stats == j.prefix_stats
        assert t.occupancy(self.ts) == j.occupancy(self.js)
        assert t.free_nodes() == j.free_nodes()
        assert (t.node_live, t.node_refs, t.node_len, t.node_key) == (
            j.node_live, j.node_refs, j.node_len, j.node_key)
        assert t.node_index == j.node_index
        assert t.requests == j.requests and t.next_rid == j.next_rid
        if t.paged:
            assert t.page_alloc.free_pages() == j.page_alloc.free_pages()
            assert t.node_pages == j.node_pages

    def assert_outputs(self, slots, tol=1e-5):
        for s in slots:
            assert self.t.outputs[s] == self.j.outputs[s], s
            np.testing.assert_allclose(self.t.logps[s], self.j.logps[s],
                                       rtol=tol, atol=tol)


def _node_of(eng, seg, parent=-1):
    return eng.node_index[(parent, tuple(int(t) for t in seg[0]))]


def _clone(st):
    """A disjoint copy of a port state (its tensors change in place)."""
    def cl(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if dataclasses.is_dataclass(x) and not isinstance(
                x, torch.Generator):
            return dataclasses.replace(x, **{
                f.name: cl(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "generator"})
        return x

    gen = torch.Generator().set_state(st.generator.get_state())
    return dataclasses.replace(cl(st), generator=gen)


def _host_equal(t, j):
    """The port's and the reference's host state agree on everything but
    log-probs (1e-5) and the checksums (fp32 K/V bytes differ in their last
    bits between the frameworks)."""
    dt, dj = t.host_state(), j.host_state()
    for d in (dt, dj):
        d.pop("seg_checksums")
    lt, lj = dt.pop("logps"), dj.pop("logps")
    assert dt == dj
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert sorted(t.seg_checksums) == sorted(j.seg_checksums)


# ---- request-table compaction ----

def test_request_table_stays_bounded_under_churn():
    pr = Pair(n_nodes=2, depth=1, slots=2, prefix_cache=True)
    for i in range(5):
        slots = pr.admit([SEGS[i % len(SEGS)]], 1)
        assert pr.t.last_rid == i
        pr.retire(slots)
        assert len(pr.t.requests) <= pr.t.tcfg.slots
    assert pr.t.next_rid == 5
    assert not pr.t.request_live(0) and pr.t.request_sharing(0) == 0
    assert pr.t.cancel_request(pr.ts, 0) is pr.ts


# ---- live -> cached -> revived / evicted ----

def test_retire_caches_nodes_and_readmit_revives_zero_prefill():
    """Retirement caches the path's three nodes (resident, indexed, K/V
    untouched); the same path admitted again is a full hit that revives
    them: every token reused, one recomputed, greedy tokens as before."""
    pr = Pair(prefix_cache=True, suffix_prefill=True)
    slots = pr.admit([SYS, TPL, REQ_A], 2)
    pr.step(4)
    pr.assert_outputs(slots)
    baseline = [list(pr.t.outputs[s]) for s in slots]
    path = list(pr.t.requests[pr.t.last_rid]["path"])
    kv = [pr.t._node_kv(pr.ts.cache, n, pr.t.node_len[n]) for n in path]
    pr.retire(slots)
    assert len(pr.t.node_cached) == 3 and len(pr.t.node_index) == 3
    assert all(pr.t.node_live[n] for n in pr.t.cached_nodes())
    pre = dict(pr.t.prefix_stats)
    slots2 = pr.admit([SYS, TPL, REQ_A], 2)
    ps = pr.t.prefix_stats
    assert ps["full_hits"] == pre["full_hits"] + 1
    assert ps["reused_tokens"] - pre["reused_tokens"] == 12 + 6 + 9
    assert ps["computed_tokens"] - pre["computed_tokens"] == 1
    assert pr.t.node_cached == {}
    for n, (k, v) in zip(path, kv):
        k2, v2 = pr.t._node_kv(pr.ts.cache, n, pr.t.node_len[n])
        assert torch.equal(k, k2) and torch.equal(v, v2)
    pr.step(4)
    pr.assert_outputs(slots2)
    assert [pr.t.outputs[s] for s in slots2] == baseline


def test_lru_eviction_order_under_node_pressure():
    pr = Pair(n_nodes=3, depth=1, slots=4, prefix_cache=True)
    stamps = []
    for seg in SEGS[:3]:
        slots = pr.admit([seg], 1)
        stamps.append(pr.t.requests[pr.t.last_rid]["path"][0])
        pr.retire(slots)
    assert sorted(pr.t.node_cached) == sorted(stamps)
    slots = pr.admit([SEGS[3]], 1)                # the oldest entry evicts
    assert pr.t.prefix_stats["evictions"] == 1
    assert stamps[0] not in pr.t.node_cached
    assert stamps[1] in pr.t.node_cached and stamps[2] in pr.t.node_cached
    pr.retire(slots)
    pr.admit([SEGS[1]], 1)                        # the survivor revives
    assert pr.t.prefix_stats["full_hits"] >= 1


@pytest.mark.parametrize("policy,evicted_is_private", [
    ("sharing", True), ("lru", False)])
def test_sharing_eviction_prefers_cold_private_tails(policy,
                                                     evicted_is_private):
    """Under "sharing" a cached leaf under a hot ancestor (a live sibling
    pins it) outlives a cold private path though its stamp is older; plain
    LRU evicts by stamp."""
    pr = Pair(n_nodes=4, depth=2, slots=4, prefix_cache=True,
              evict_policy=policy)
    sa = pr.admit([SYS, REQ_A], 1)
    pr.admit([SYS, REQ_B], 1)                     # B stays live
    pr.retire(sa)                                 # A cached, oldest
    sp = pr.admit([SEGS[0]], 1)
    pr.retire(sp)                                 # P cached, younger
    sys_id = _node_of(pr.t, SYS)
    a_id = _node_of(pr.t, REQ_A, parent=sys_id)
    p_id = _node_of(pr.t, SEGS[0])
    order = pr.t._eviction_order()
    assert order == pr.j._eviction_order()
    assert (order == [p_id, a_id]) == evicted_is_private
    assert pr.t._ancestor_shared_bytes(a_id) == pr.j._ancestor_shared_bytes(
        a_id) > 0
    pr.admit([SEGS[1]], 1)
    assert pr.t.prefix_stats["evictions"] == 1
    gone, kept = (p_id, a_id) if evicted_is_private else (a_id, p_id)
    assert gone not in pr.t.node_cached and kept in pr.t.node_cached


def test_sharing_eviction_soak_reuse_does_not_regress():
    """Seeded soak under node pressure (the reference's): alternating
    hot-ancestor re-admissions and one-off private prompts. Both packages
    evict alike at every step; "sharing" reuses at least as many prefix
    tokens as plain LRU, and the checksums of every resident node verify
    at the end."""
    lrng = np.random.RandomState(3)
    kids = [lrng.randint(0, CFG_J.vocab_size, (1, 8)) for _ in range(3)]
    privs = [lrng.randint(0, CFG_J.vocab_size, (1, 10)) for _ in range(6)]

    def run(policy):
        pr = Pair(n_nodes=5, depth=2, slots=4, prefix_cache=True,
                  evict_policy=policy)
        for i in range(9):
            pr.retire(pr.admit([SYS, kids[i % 3]], 1))
            pr.retire(pr.admit([privs[i % 6]], 1))
        assert pr.t.audit_state(pr.ts, verify_checksums=True)
        assert pr.j.audit_state(pr.js, verify_checksums=True)
        return pr.t.prefix_stats

    sharing, lru = run("sharing"), run("lru")
    assert sharing["reused_tokens"] >= lru["reused_tokens"]
    assert sharing["reused_tokens"] > 0


def test_page_pressure_evicts_lru():
    """A full pool of two cached nodes: a two-page demand evicts exactly
    the LRU entry (its table row cleared before its pages return), and the
    occupancy reports the cache."""
    pr = Pair(n_nodes=4, depth=1, slots=4, node_capacity=16,
              ctx_store="paged", page_size=8, num_pages=4, prefix_cache=True)
    rng = np.random.RandomState(11)
    seg_a, seg_b, seg_c = (rng.randint(0, CFG_J.vocab_size, (1, 12))
                           for _ in range(3))
    pr.retire(pr.admit([seg_a], 1))
    pr.retire(pr.admit([seg_b], 1))
    assert pr.t.page_alloc.free_count() == 0 and len(pr.t.node_cached) == 2
    # cached nodes stay audited: allocator invariants and checksums hold
    assert pr.t.audit_state(pr.ts, verify_checksums=True)
    assert pr.j.audit_state(pr.js, verify_checksums=True)
    occ = pr.t.occupancy(pr.ts)
    assert occ["nodes_cached"] == 2 and occ["pages_cached"] == 4
    nid_a = _node_of(pr.t, seg_a)
    pr.admit([seg_c], 1)
    assert pr.t.prefix_stats["evictions"] == 1
    assert not pr.t.node_live[nid_a] and len(pr.t.node_cached) == 1
    # the evicted node's row is empty; the admitted node took its pages
    rows = pr.ts.cache.store.page_tables
    assert int(pr.ts.cache.store.seg_lens[nid_a]) == 0
    assert (rows[nid_a] == -1).all()
    assert sorted(pr.t.node_pages[_node_of(pr.t, seg_c)]) == [0, 1]
    assert pr.t.audit_state(pr.ts, verify_checksums=True)
    assert pr.j.audit_state(pr.js, verify_checksums=True)
    assert nid_a not in pr.t.seg_checksums


def test_unsatisfiable_demand_evicts_nothing_and_raises():
    pr = Pair(n_nodes=3, depth=2, slots=4, prefix_cache=True)
    pr.admit([SYS, REQ_A], 1)                     # pins two nodes
    pr.retire(pr.admit([TPL], 1))
    assert len(pr.t.node_cached) == 1
    before = (dict(pr.t.node_cached), dict(pr.t.prefix_stats))
    with pytest.raises(RuntimeError, match="free trie node"):
        pr.j.admit(JP, pr.js, [jnp.asarray(REQ_B), jnp.asarray(REQ_A)], 1)
    with pytest.raises(SegmentsExhausted, match="free trie node"):
        pr.t.admit(TP, pr.ts, [torch.as_tensor(REQ_B),
                               torch.as_tensor(REQ_A)], 1)
    pr.check()
    assert (pr.t.node_cached, pr.t.prefix_stats) == before
    assert pr.t.prefix_stats["evictions"] == 0
    assert all(pr.t.node_live[n] for n in pr.t.cached_nodes())


def test_matched_path_protected_from_eviction():
    pr = Pair(n_nodes=2, depth=2, slots=2, prefix_cache=True)
    pr.retire(pr.admit([SYS, REQ_A], 1))
    root = _node_of(pr.t, SYS)
    pr.admit([SYS, REQ_B], 1)           # the leaf evicts, the root revives
    assert pr.t.prefix_stats["evictions"] == 1
    assert pr.t.node_live[root] and pr.t.node_refs[root] == 1
    assert pr.t.prefix_stats["partial_hits"] == 1


# ---- host state (snapshot / recovery surface) ----

def test_host_state_roundtrip_with_cached_nodes():
    """The cached-node set, LRU clock, lengths, request table and stats
    survive ``host_state`` -> JSON -> ``load_host_state`` on a fresh port
    engine; on a copy of the same device state its checksums verify and
    the cached path revives exactly as on the original engine (and as on
    the reference's)."""
    kw = dict(ctx_store="paged", page_size=8, num_pages=8, prefix_cache=True,
              suffix_prefill=True)
    pr = Pair(**kw)
    slots = pr.admit([SYS, TPL, REQ_A], 2)
    pr.step(4)
    pr.retire(slots)
    _host_equal(pr.t, pr.j)
    blob = json.loads(json.dumps(pr.t.host_state()))
    eng2 = TreeServeEngine(pr.t.model, pr.t.cfg, pr.t.tcfg)
    eng2.load_host_state(blob)
    for name in ("node_cached", "lru_clock", "node_len", "requests",
                 "next_rid", "prefix_stats", "seg_checksums", "node_pages"):
        assert getattr(eng2, name) == getattr(pr.t, name), name
    assert eng2.page_alloc.free_pages() == pr.t.page_alloc.free_pages()
    st_b = _clone(pr.ts)
    assert eng2.audit_state(st_b, verify_checksums=True)
    st_b, slots2 = eng2.admit(TP, st_b, [torch.as_tensor(s) for s in
                                         (SYS, TPL, REQ_A)], 2)
    assert eng2.prefix_stats["full_hits"] == pr.t.prefix_stats[
        "full_hits"] + 1
    eng2.step_chunk(TP, st_b, 4)
    slots1 = pr.admit([SYS, TPL, REQ_A], 2)
    pr.step(4)
    pr.assert_outputs(slots1)
    for s2, s1 in zip(slots2, slots1):
        assert eng2.outputs[s2] == pr.t.outputs[s1]


def test_prefix_stats_survive_host_state_roundtrip_and_continue():
    pr = Pair(prefix_cache=True, suffix_prefill=True)
    pr.retire(pr.admit([SYS, TPL], 1))
    pr.retire(pr.admit([SYS, TPL, REQ_A], 1))
    _host_equal(pr.t, pr.j)
    eng2 = TreeServeEngine(pr.t.model, pr.t.cfg, pr.t.tcfg)
    eng2.load_host_state(json.loads(json.dumps(pr.t.host_state())))
    assert eng2.prefix_stats == pr.t.prefix_stats
    # both sides of the round-trip keep counting identically
    st_b = _clone(pr.ts)
    pr.admit([SYS, REQ_B], 1)
    eng2.admit(TP, st_b, [torch.as_tensor(SYS), torch.as_tensor(REQ_B)], 1)
    assert eng2.prefix_stats == pr.t.prefix_stats
    assert eng2.prefix_stats["partial_hits"] == 2


# ---- prefix_stats edge cases ----

def test_token_accounting_across_revive_evict_readmit_cycle():
    pr = Pair(n_nodes=2, depth=2, slots=2, prefix_cache=True,
              suffix_prefill=True)

    def stats():
        ps = pr.t.prefix_stats
        return (ps["reused_tokens"], ps["new_tokens"],
                ps["computed_tokens"], ps["evictions"])

    s1 = pr.admit([SYS, REQ_A], 1)
    assert stats() == (0, 21, 21, 0)
    pr.retire(s1)
    s2 = pr.admit([SYS, REQ_A], 1)
    assert pr.t.prefix_stats["full_hits"] == 1 and stats() == (21, 21, 22, 0)
    pr.retire(s2)
    s3 = pr.admit([TPL, REQ_B], 1)
    assert stats() == (21, 34, 35, 2)
    pr.retire(s3)
    pr.admit([SYS, REQ_A], 1)
    assert stats() == (21, 55, 56, 4)
    assert pr.t.prefix_stats["full_hits"] == 1
    assert pr.t.prefix_stats["admits"] == 4


def test_partial_vs_full_hit_counter_boundaries():
    pr = Pair(prefix_cache=True, suffix_prefill=True)
    pr.retire(pr.admit([SYS, TPL], 1))
    ps0 = dict(pr.t.prefix_stats)
    assert (ps0["full_hits"], ps0["partial_hits"]) == (0, 0)
    s = pr.admit([SYS, TPL, REQ_A], 1)
    ps1 = dict(pr.t.prefix_stats)
    assert (ps1["full_hits"], ps1["partial_hits"]) == (0, 1)
    assert ps1["reused_tokens"] - ps0["reused_tokens"] == 18
    assert ps1["computed_tokens"] - ps0["computed_tokens"] == 9
    pr.retire(s)
    pr.admit([SYS], 1)
    ps2 = dict(pr.t.prefix_stats)
    assert (ps2["full_hits"], ps2["partial_hits"]) == (1, 1)
    assert ps2["reused_tokens"] - ps1["reused_tokens"] == 12
    assert ps2["new_tokens"] == ps1["new_tokens"]
    assert ps2["computed_tokens"] - ps1["computed_tokens"] == 1


def test_full_hit_without_suffix_prefill_recomputes_the_path():
    pr = Pair(prefix_cache=True, suffix_prefill=False)
    s = pr.admit([SYS], 1)
    pr.retire(s)
    s2 = pr.admit([SYS], 1)
    ps = pr.t.prefix_stats
    assert (ps["full_hits"], ps["reused_tokens"], ps["computed_tokens"]) == (
        1, 12, 24)
    pr.assert_outputs(s + s2)


def test_packed_admission_revives_and_evicts():
    """Packed mode: an admission with new levels revives its matched cached
    ancestors and evicts under node pressure in ``_admit_packed``'s order,
    as the reference does; the chunks then land over the revived K/V."""
    pr = Pair(n_nodes=3, depth=2, slots=4, prefix_cache=True,
              suffix_prefill=True, step_mode="packed", prefill_chunk=5)
    s1 = pr.admit([SYS, REQ_A], 1)
    pr.step(6)                                    # 12 + 9 tokens in 5s
    pr.retire(s1)
    s2 = pr.admit([TPL], 1)
    pr.step(3)
    pr.retire(s2)
    assert len(pr.t.node_cached) == 3
    s3 = pr.admit([SYS, REQ_B], 1)          # SYS revives, REQ_A evicts
    assert pr.t.prefix_stats["evictions"] == 1
    assert pr.t.prefix_stats["partial_hits"] == 1
    pr.step(4)
    pr.assert_outputs(s1 + s3)


# ---- acceptance: greedy identity against the evict-eagerly baseline ----

@functools.lru_cache(maxsize=None)
def _accept(store, dtype, cached):
    kw = dict(cache_dtype=dtype, ctx_store=store)
    if store == "paged":
        kw.update(page_size=8, num_pages=12)
    if cached:
        kw.update(prefix_cache=True, suffix_prefill=True)
    pr = Pair(train_attn="flash" if cached else "chunked", **kw)
    s1 = pr.admit([SYS, TPL, REQ_A], 2)
    pr.step(4)
    out1 = [list(pr.t.outputs[s]) for s in s1]
    pr.retire(s1)
    s2 = pr.admit([SYS, TPL, REQ_B], 2)
    pr.step(4)
    pr.assert_outputs(s1 + s2, 1e-3 if dtype == "int8" else 1e-5)
    return pr, out1, [list(pr.t.outputs[s]) for s in s2]


@pytest.mark.parametrize("store,dtype", [
    ("dense", "bfloat16"), ("dense", "int8"),
    ("paged", "bfloat16"), ("paged", "int8")])
def test_greedy_identity_vs_evict_eager_baseline(store, dtype):
    """The cached engine (prefix cache, suffix prefill, flash prefill) and
    the evict-eagerly baseline (chunked prefill), each equal to the
    reference's on every step, emit the same greedy tokens; the second
    request revives [SYS, TPL] and prefills only REQ_B."""
    base, b1, b2 = _accept(store, dtype, False)
    cached, c1, c2 = _accept(store, dtype, True)
    ps = base.t.prefix_stats
    assert ps["full_hits"] + ps["partial_hits"] == 0
    assert cached.t.prefix_stats["partial_hits"] == 1
    assert cached.t.prefix_stats["reused_tokens"] == 12 + 6
    assert b1 == c1 and b2 == c2
