"""Port parity for the admission policies (``runtime/scheduler.py``) and
their byte model (``core.io_model.tree_admit_bytes_delta``): the
deterministic cases of ``tests/test_scheduler.py``, each run on the port
and on the reference over the same hand-built trie. A model-less
``TreeServeEngine`` carries only its host mirrors, the policies' whole
input: ``admit_order`` and ``victim_key`` must give the reference's
results, and those must be what the reference's test asserts. A seeded
workload x policy run over the tiny model ends as the reference's does
(statuses, counters, tokens, and the modelled context bytes/step)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_serving import Twin, assert_same_run
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TreeConfig as JTreeConfig
from repro.core.io_model import tree_admit_bytes_delta as j_delta
from repro.core.io_model import tree_decode_io_bytes as j_tree_io
from repro.runtime import frontend as jfe
from repro.runtime import scheduler as jsched
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import TreeConfig as TTreeConfig
from repro_torch.core.io_model import tree_admit_bytes_delta as t_delta
from repro_torch.core.io_model import tree_decode_io_bytes as t_tree_io
from repro_torch.runtime import frontend as tfe
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.serve import TreeServeEngine as TTreeEngine

UNIT = dict(name="sched-unit", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
            vocab_pad_multiple=16, decode_capacity=8)
PER_TOK = 2 * 1 * 16 * 2
SYS = tuple(range(1, 11))
TPL = tuple(range(20, 26))
OTH = (40, 41, 42)
OTH2 = (50, 51, 52, 53)

SIDES = {
    "jax": (JTreeEngine, JTreeConfig, JModelConfig(**UNIT), jfe, jsched,
            lambda lv: jnp.asarray([list(lv)], jnp.int32), {}),
    "torch": (TTreeEngine, TTreeConfig, TModelConfig(**UNIT), tfe, tsched,
              lambda lv: torch.tensor([list(lv)], dtype=torch.int32),
              {"device": "cpu"}),
}


class Side:
    """One package's engine (host mirrors only), frontend and tickets."""

    def __init__(self, which, policy="sharing", **kw):
        (eng_cls, tcfg_cls, cfg, self.fe_mod, self.sched, self.seg,
         dev_kw) = SIDES[which]
        base = dict(n_nodes=8, depth=3, slots=8, node_capacity=32,
                    decode_capacity=8, temperature=0.0)
        self.eng = eng_cls(None, cfg, tcfg_cls(**{**base, **kw}))
        self.fe = self.fe_mod.ServeFrontend(self.eng, policy=policy, **dev_kw)

    def grow(self, parent, toks, refs=0):
        eng = self.eng
        nid = eng.node_live.index(False)
        key = (parent, tuple(toks))
        eng.node_index[key] = nid
        eng.node_key[nid] = key
        eng.node_live[nid] = True
        eng.node_len[nid] = len(toks)
        eng.node_refs[nid] = refs
        return nid

    def tk(self, tid, levels, *, n_samples=1, priority=0, deadline=None,
           submitted=0, handle=-1):
        return self.fe_mod.Ticket(
            tid=tid, segments=[self.seg(lv) for lv in levels],
            n_samples=n_samples, max_new_tokens=4, priority=priority,
            deadline_round=deadline, submitted_round=submitted,
            handle=handle)

    def order(self, tickets, policy=None):
        pol = policy or self.fe.policy
        return [t.tid for t in pol.admit_order(self.fe, tickets)]


def both(build, policy="sharing", **kw):
    """``build(side)`` on the reference's side and the port's; returns the
    two results, which must be equal."""
    j = build(Side("jax", policy, **kw))
    t = build(Side("torch", policy, **kw))
    assert t == j
    return t


def test_make_policy_resolution():
    assert isinstance(tsched.make_policy(None), tsched.FifoPolicy)
    assert isinstance(tsched.make_policy("fifo"), tsched.FifoPolicy)
    assert isinstance(tsched.make_policy("sharing"), tsched.SharingPolicy)
    custom = tsched.SharingPolicy(tsched.SharingPolicyConfig(age_bound=3))
    assert tsched.make_policy(custom) is custom
    assert tsched.SharingPolicyConfig() == tsched.SharingPolicyConfig(
        **vars(jsched.SharingPolicyConfig()))
    with pytest.raises(ValueError, match="unknown admission policy"):
        tsched.make_policy("lifo")
    for p in ("fifo", "sharing"):
        assert Side("torch", p).fe.policy.name == p


def test_fifo_orders_by_priority_then_submission():
    def build(s):
        ts = [s.tk(0, [OTH], priority=0), s.tk(1, [OTH], priority=2),
              s.tk(2, [OTH], priority=1), s.tk(3, [OTH], priority=2)]
        first = s.order(ts)
        s.grow(-1, SYS, refs=3)
        return first, s.order(ts + [s.tk(4, [SYS, OTH])])

    assert both(build, "fifo") == ([1, 3, 2, 0], [1, 3, 2, 0, 4])


@pytest.mark.parametrize("case", ["deeper", "chain", "per_slot", "cached"])
def test_greedy_sharing_order(case):
    def build(s):
        if case == "deeper":
            sys_id = s.grow(-1, SYS, refs=1)
            s.grow(sys_id, TPL, refs=1)
            ts = [s.tk(0, [OTH]), s.tk(1, [SYS, OTH]),
                  s.tk(2, [SYS, TPL, OTH])]
        elif case == "chain":
            ts = [s.tk(5, [SYS, OTH], priority=2),
                  s.tk(6, [SYS, OTH2], priority=0),
                  s.tk(7, [OTH], priority=1)]
        elif case == "per_slot":
            s.grow(-1, SYS, refs=1)
            ts = [s.tk(9, [SYS, OTH], n_samples=4), s.tk(10, [SYS, OTH2])]
            return s.order(ts), s.order(ts, s.sched.FifoPolicy())
        else:
            s.grow(-1, SYS, refs=0)
            ts = [s.tk(0, [OTH]), s.tk(1, [SYS, OTH])]
        return s.order(ts)

    want = {"deeper": [2, 1, 0], "chain": [5, 6, 7],
            "per_slot": ([10, 9], [9, 10]), "cached": [1, 0]}[case]
    assert both(build) == want


def test_slo_lanes():
    def build(s):
        s.grow(-1, SYS, refs=2)
        s.fe.round = 10
        urgent = s.order([s.tk(2, [SYS, OTH]), s.tk(3, [OTH], deadline=12),
                          s.tk(5, [OTH2], deadline=11),
                          s.tk(4, [OTH], deadline=14)])
        seeded = s.order([s.tk(0, [SYS, OTH], deadline=11), s.tk(1, [OTH2]),
                          s.tk(2, [SYS, TPL])])
        bound = s.sched.SharingPolicyConfig().age_bound
        poor = s.tk(0, [OTH], submitted=0)
        s.fe.round = bound
        before = s.order([poor, s.tk(1, [SYS, OTH], submitted=bound - 1)])
        s.fe.round = bound + 1
        after = s.order([poor, s.tk(1, [SYS, OTH], submitted=bound)])
        return urgent, seeded, before, after

    assert both(build) == ([5, 3, 2, 4], [0, 2, 1], [1, 0], [0, 1])


def test_victim_keys():
    def build(s):
        eng = s.eng
        sys_id = s.grow(-1, SYS, refs=2)
        a_id = s.grow(sys_id, OTH, refs=1)
        loner_id = s.grow(-1, OTH2, refs=1)
        long_id = s.grow(sys_id, SYS + TPL, refs=1)
        eng.requests = {
            7: {"path": [sys_id, a_id], "slots": [0], "live": True},
            8: {"path": [loner_id], "slots": [1], "live": True},
            9: {"path": [sys_id, long_id], "slots": [2], "live": True},
        }
        sharer = s.tk(0, [SYS, OTH], handle=7)
        loner = s.tk(1, [OTH2], handle=8)
        longt = s.tk(2, [SYS, SYS + TPL], handle=9)
        pol, fifo = s.fe.policy, s.sched.FifoPolicy()
        keys = [pol.victim_key(s.fe, t) for t in (sharer, loner, longt)]
        fifo_keys = [fifo.victim_key(s.fe, t) for t in (sharer, loner)]
        loner.priority = 1
        prio = pol.victim_key(s.fe, loner)
        return keys, fifo_keys, prio

    keys, fifo_keys, prio = both(build)
    sharer, loner, longt = keys
    assert loner < sharer and fifo_keys[1] < fifo_keys[0]
    assert longt < sharer                  # the longer private tail first
    assert sharer < prio                   # priority dominates sharing
    d = t_delta(seg_lens=[len(SYS), len(SYS + TPL)], shared=[True, False],
                n_slots=1, c_d=8, g=1, hd=16, bytes_per_el=2)
    assert longt[1] == d["shared_bytes"] - d["ctx_delta"]


def test_victim_key_fully_shared_pays_no_reprefill():
    def build(s):
        sys_id = s.grow(-1, SYS, refs=3)
        tpl_id = s.grow(sys_id, TPL, refs=2)
        s.eng.requests = {5: {"path": [sys_id, tpl_id], "slots": [0],
                              "live": True}}
        return s.fe.policy.victim_key(s.fe, s.tk(0, [SYS, TPL], handle=5))

    assert both(build)[1] == (len(SYS) + len(TPL)) * PER_TOK


def test_peek_prefix_is_side_effect_free():
    def build(s):
        eng = s.eng
        sys_id = s.grow(-1, SYS, refs=1)
        tpl_id = s.grow(sys_id, TPL, refs=1)
        before = (list(eng.node_live), list(eng.node_refs),
                  dict(eng.node_index), list(eng.node_key), list(eng.node_len))
        hit = eng.peek_prefix([s.seg(SYS), s.seg(TPL), s.seg(OTH)])
        miss = eng.peek_prefix([s.seg(OTH)])
        after = (list(eng.node_live), list(eng.node_refs),
                 dict(eng.node_index), list(eng.node_key), list(eng.node_len))
        assert after == before
        return hit, miss, [sys_id, tpl_id]

    hit, miss, ids = both(build)
    assert hit == (ids, 2, len(SYS) + len(TPL)) and miss == ([], 0, 0)


@pytest.mark.parametrize("case", [
    ([8, 3, 5], [True, True, False], 2, dict(c_d=8, g=2, hd=16)),
    ([4, 6], [False, False], 1, dict(c_d=8, g=1, hd=16)),
    ([10, 6], [True, True], 4, dict(c_d=8, g=1, hd=16)),
    ([128, 64, 32], [True, False, True], 3,
     dict(c_d=16, g=8, hd=128, p=2, n=2, bytes_per_el=1)),
])
def test_admit_delta_equals_the_reference(case):
    seg_lens, shared, n_slots, kw = case
    got = t_delta(seg_lens=seg_lens, shared=shared, n_slots=n_slots, **kw)
    assert got == j_delta(seg_lens=seg_lens, shared=shared, n_slots=n_slots,
                          **kw)
    assert got["ctx_delta"] + got["dec_delta"] == got["total_delta"]


def test_admit_delta_matches_full_model_difference():
    node_lens, kw = [8, 3, 5], dict(c_d=8, g=2, hd=16)
    before = t_tree_io(paths=[(0,), (0, 1)], node_lens=node_lens, **kw)
    after = t_tree_io(paths=[(0,), (0, 1), (0, 1, 2), (0, 1, 2)],
                      node_lens=node_lens, **kw)
    want = j_tree_io(paths=[(0,), (0, 1), (0, 1, 2), (0, 1, 2)],
                     node_lens=node_lens, **kw)
    assert after == {k: want[k] for k in after}
    delta = t_delta(seg_lens=node_lens, shared=[True, True, False],
                    n_slots=2, **kw)
    assert delta["total_delta"] == after["total"] - before["total"]
    with pytest.raises(ValueError, match="align"):
        t_delta(seg_lens=[3], shared=[True, False], n_slots=1, **kw)
    with pytest.raises(ValueError, match="n_slots"):
        t_delta(seg_lens=[3], shared=[True], n_slots=0, **kw)


# ---------------------------------------------------------------------------
# a seeded workload x policy run over the tiny model, port vs reference
# ---------------------------------------------------------------------------

def _schedule(wseed):
    """The reference fuzz's arrival schedule for one workload seed."""
    rng = np.random.RandomState(wseed)
    prefixes = [rng.randint(0, 64, (1, n)) for n in (8, 12)]
    sched = []
    for r in range(5):
        n = int(rng.poisson(1.0)) + (2 if r == 2 else 0)
        evs = []
        for _ in range(n):
            pfx = prefixes[int(rng.randint(2))]
            sfx = rng.randint(0, 64, (1, int(rng.randint(2, 6))))
            evs.append(dict(
                segments=[pfx, sfx], n_samples=int(rng.choice([1, 2])),
                max_new_tokens=int(rng.randint(3, 6)),
                priority=int(rng.randint(0, 2)),
                deadline=(int(rng.randint(10, 25))
                          if rng.rand() < 0.25 else None)))
        sched.append(evs)
    return sched


def _policy_arm(tw, sched, policy):
    eng = tw.engine("tree", "paged", "bfloat16", n_nodes=6, depth=2,
                    slots=4, node_capacity=16, num_pages=8,
                    prefix_cache=True, suffix_prefill=True)
    fe = tw.frontend_(eng, queue_depth=16, stall_rounds=6, policy=policy)
    state = fe.init_state()
    for evs in sched:
        for ev in evs:
            fe.submit([tw.tok(s) for s in ev["segments"]],
                      n_samples=ev["n_samples"],
                      max_new_tokens=ev["max_new_tokens"],
                      priority=ev["priority"], deadline_rounds=ev["deadline"])
        state = fe.pump(tw.params, state)
    fe.drain(tw.params, state, max_rounds=len(sched) + 200)
    return fe


@pytest.mark.parametrize("policy", ["fifo", "sharing"])
def test_policy_workload_ends_as_the_reference(policy):
    """Workload seed 3 (one of the reference fuzz's fixed seeds): the port
    and the reference end every ticket alike, with the same counters,
    tokens and modelled bytes/step, exact budgets and green audits."""
    sched = _schedule(3)
    fe_j = _policy_arm(Twin("jax"), sched, policy)
    fe_t = _policy_arm(Twin("torch"), sched, policy)
    assert_same_run(fe_t, fe_j)
    m = fe_t.metrics()
    assert m["modelled_io"] == fe_j.metrics()["modelled_io"]
    assert m["counters"]["audits_passed"] == m["rounds"]
    for t in fe_t.tickets:
        assert t.status in ("completed", "rejected"), (t.tid, t.status)
        if t.status == "completed":
            assert all(len(tok) == t.max_new_tokens for tok in t.tokens)
