"""Port parity for the serving frontend (``runtime/frontend.ServeFrontend``)
and its fault injection: the cases of ``tests/test_frontend.py``, each run
on the port and on the reference over the tiny model (``_torch_serving``,
fp32 stores on both sides). After each run the two frontends must hold the
same ticket statuses, reasons, preemption counts, fault marks, counters
and greedy tokens (log-probs to 1e-5); each case also asserts on the port
what the reference's test asserts.

  * the admission ladder: typed rejections at submit, an oversubscribed
    drain with exact budgets and an audit every round, preemption by
    effective priority with the victim re-queued and finished, deadlines
    on queued and running tickets, the watchdog breaking a
    DELAYED_RETIREMENT hold;
  * the blast-radius contract on the paged trie and the paged forest: a
    plan of POOL_EXHAUST, DOUBLE_RELEASE, DELAYED_RETIREMENT and
    CANCEL_MID_DECODE leaves every ticket's greedy tokens as the fault-free
    run's."""
import numpy as np
import pytest

from _torch_serving import Twin, assert_same_run, both

RNG = np.random.RandomState(0)
SYS = RNG.randint(0, 64, (1, 12))
REQS = [RNG.randint(0, 64, (1, 7)) for _ in range(6)]
HI_SYS = RNG.randint(0, 64, (1, 12))

# the reference frontend tests' engines (paged, 8-token pages, 5 pages)
TREE = dict(n_nodes=4, depth=2, slots=4, node_capacity=16, decode_capacity=8,
            page_size=8, num_pages=5)
FOREST = dict(n_groups=3, slots=4, ctx_capacity=24, decode_capacity=8,
              page_size=8, num_pages=5)


def _tree(tw, **kw):
    return tw.engine("tree", "paged", "bfloat16", **{**TREE, **kw})


def _forest(tw, **kw):
    return tw.engine("forest", "paged", "bfloat16", **{**FOREST, **kw})


def _pair(run):
    """``run(twin)`` on the reference and on the port; the port's frontend
    must end as the reference's. Returns the port's frontend."""
    tw_j, tw_t = both()
    fe_j, fe_t = run(tw_j), run(tw_t)
    assert_same_run(fe_t, fe_j)
    return fe_t


def test_submit_never_raises_typed_rejections():
    def run(tw):
        fe = tw.frontend_(_tree(tw), queue_depth=2)
        fe.submit([tw.tok(SYS)], n_samples=9)            # > slots
        fe.submit([tw.tok(SYS)], max_new_tokens=64)      # > decode capacity
        fe.submit([tw.tok(np.zeros((1, 17), np.int32))])  # > node capacity
        for i in range(4):                                # queue overflow
            fe.submit([tw.tok(SYS), tw.tok(REQS[i % len(REQS)])])
        return fe

    fe = _pair(run)
    got = [(t.status, t.reason) for t in fe.tickets]
    assert got == [("rejected", "request_infeasible")] * 3 + [
        ("queued", None), ("queued", None), ("rejected", "queue_full"),
        ("rejected", "queue_full")]


def test_drain_oversubscribed_all_complete_exact_budgets():
    def run(tw):
        fe = tw.frontend_(_tree(tw))
        state = fe.init_state()
        for i in range(6):
            fe.submit([tw.tok(SYS), tw.tok(REQS[i])], n_samples=1 + (i % 2),
                      max_new_tokens=5)
        fe.drain(tw.params, state, max_rounds=80)
        return fe

    fe = _pair(run)
    m = fe.metrics()
    assert m["by_status"] == {"completed": 6}
    assert all(len(tok) == 5 for t in fe.tickets for tok in t.tokens)
    assert all(len(lp) == 5 for t in fe.tickets for lp in t.logprobs)
    assert m["counters"]["audits_passed"] == m["rounds"]
    assert m["counters"].get("backoffs", 0) > 0


def test_preemption_priority_and_requeue():
    def run(tw):
        fe = tw.frontend_(_tree(tw, num_pages=4), preempt_after=1)
        state = fe.init_state()
        fe.submit([tw.tok(SYS), tw.tok(REQS[0])], priority=0,
                  max_new_tokens=6)
        state = fe.pump(tw.params, state)
        assert fe.ticket(0).status == "running"
        fe.submit([tw.tok(HI_SYS), tw.tok(REQS[1])], priority=2,
                  max_new_tokens=6)
        fe.drain(tw.params, state, max_rounds=60)
        return fe

    def alone(tw):
        fe = tw.frontend_(_tree(tw, num_pages=4))
        state = fe.init_state()
        fe.submit([tw.tok(SYS), tw.tok(REQS[0])], max_new_tokens=6)
        fe.drain(tw.params, state, max_rounds=30)
        return fe

    fe = _pair(run)
    lo, hi = fe.ticket(0), fe.ticket(1)
    assert hi.status == "completed" and hi.preemptions == 0
    assert lo.status == "completed" and lo.preemptions >= 1
    assert fe.counters.get("preemptions_pressure", 0) >= 1
    base = alone(Twin("torch")).ticket(0)
    for a, b in zip(lo.tokens, base.tokens):
        np.testing.assert_array_equal(a, b)


def test_deadlines_reject_queued_and_running():
    def run(tw):
        fe = tw.frontend_(_tree(tw, num_pages=3))
        state = fe.init_state()
        fe.submit([tw.tok(SYS)], n_samples=1, max_new_tokens=8)
        fe.submit([tw.tok(REQS[4]), tw.tok(REQS[0])], deadline_rounds=2,
                  max_new_tokens=8)
        fe.submit([tw.tok(SYS)], n_samples=1, deadline_rounds=1,
                  max_new_tokens=8)
        fe.drain(tw.params, state, max_rounds=60)
        return fe

    fe = _pair(run)
    assert fe.ticket(0).status == "completed"
    for tid in (1, 2):
        t = fe.ticket(tid)
        assert (t.status, t.reason) == ("rejected", "deadline_exceeded")
    assert fe.counters.get("deadline_cancels", 0) >= 1


def test_watchdog_breaks_delayed_retirement_hold():
    def run(tw):
        f = tw.faults
        plan = f.FaultPlan([f.FaultEvent(1, f.FaultKind.DELAYED_RETIREMENT,
                                         hold=50)])
        fe = tw.frontend_(_tree(tw), fault_plan=plan, stall_rounds=3)
        state = fe.init_state()
        for i in range(3):
            fe.submit([tw.tok(SYS), tw.tok(REQS[i])], max_new_tokens=4)
        fe.drain(tw.params, state, max_rounds=60)
        return fe

    fe = _pair(run)
    assert all(t.status == "completed" for t in fe.tickets)
    assert fe.counters.get("retirement_suppressed", 0) > 0
    assert fe.counters.get("watchdog_fires", 0) >= 1


@pytest.mark.parametrize("which", ["tree", "forest"])
def test_blast_radius_tokens_bit_identical_under_faults(which):
    def replay(tw, faulty):
        f = tw.faults
        plan = f.FaultPlan([
            f.FaultEvent(2, f.FaultKind.POOL_EXHAUST, arg=2, hold=2),
            f.FaultEvent(3, f.FaultKind.DOUBLE_RELEASE),
            f.FaultEvent(4, f.FaultKind.DELAYED_RETIREMENT, hold=2),
            f.FaultEvent(5, f.FaultKind.CANCEL_MID_DECODE),
        ], seed=1) if faulty else None
        eng = _tree(tw) if which == "tree" else _forest(tw)
        fe = tw.frontend_(eng, fault_plan=plan, stall_rounds=4)
        state = fe.init_state()
        for i in range(4):
            segs = ([tw.tok(SYS), tw.tok(REQS[i])] if which == "tree"
                    else [tw.tok(np.concatenate([SYS, REQS[i]], axis=1))])
            fe.submit(segs, n_samples=1 + (i % 2), priority=i % 2,
                      max_new_tokens=5)
        fe.drain(tw.params, state, max_rounds=120)
        return fe

    base = _pair(lambda tw: replay(tw, False))
    faulty = _pair(lambda tw: replay(tw, True))
    assert all(t.status == "completed" for t in base.tickets + faulty.tickets)
    assert faulty.counters.get("fault_cancel_mid_decode", 0) == 1
    assert faulty.counters.get("double_release_refused", 0) == 1
    touched = [t for t in faulty.tickets if t.fault_touched]
    assert len(touched) == 1 and touched[0].preemptions >= 1
    for fe in (base, faulty):
        assert fe.counters["audits_passed"] == fe.metrics()["rounds"]
    for b, f in zip(base.tickets, faulty.tickets):
        assert len(b.tokens) == len(f.tokens)
        for x, y in zip(b.tokens, f.tokens):
            np.testing.assert_array_equal(x, y)


def test_host_state_roundtrip_and_metrics():
    """A frontend's host state survives JSON and a fresh frontend, and its
    metrics report what the reference's report."""
    import json

    def run(tw):
        fe = tw.frontend_(_tree(tw), policy="sharing")
        state = fe.init_state()
        for i in range(3):
            fe.submit([tw.tok(SYS), tw.tok(REQS[i])], max_new_tokens=3)
        fe.drain(tw.params, state, max_rounds=40)
        return fe

    tw_j, tw_t = both()
    fe_j, fe_t = run(tw_j), run(tw_t)
    assert_same_run(fe_t, fe_j)
    mt, mj = fe_t.metrics(), fe_j.metrics()
    for m in (mt, mj):
        m.pop("per_token_latency_s")
    assert mt == mj
    host = json.loads(json.dumps(fe_t.host_state()))
    fe2 = tw_t.frontend_(_tree(tw_t))
    fe2.load_host_state(host)
    assert fe2.host_state() == fe_t.host_state()
    assert [t.segments[0].device.type for t in fe2.tickets] == ["cpu"] * 3
