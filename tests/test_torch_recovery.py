"""Port parity for crash-consistent serving (``runtime/recovery``): the
cases of ``tests/test_recovery.py`` on the port, over the tiny model with
fp32 stores (``_torch_serving``), and the reference where a case compares
with it.

  * kill-and-restore: a ``DurableFrontend`` killed twice mid-workload and
    recovered from snapshot + journal replay ends every ticket as an
    uninterrupted control does, bit for bit, on the trie and the forest,
    dense and paged, bf16 and int8 nodes — and the control's tokens are the
    reference's (log-probs to 1e-5, int8 to 1e-3);
  * a corrupt snapshot falls back to the previous one; a truncated journal
    replays up to its last whole record; the snapshot budget's cadence
    under an injected clock; a packed prefill in flight defers snapshots
    across a recovery; the sharing policy's journaled admission orders
    (the reference's, round for round) replay without divergence, and a
    tampered order is a ``ReplayDivergence``;
  * the non-finite sentinel quarantines only the poisoned request, as the
    reference does; a flipped KV byte fails ``audit_state(
    verify_checksums=True)``; a stale heartbeat restarts under
    ``run_supervised``;
  * a real SIGKILL of a serving subprocess (tests/_torch_crash_drill_worker.py)
    recovered in a fresh interpreter;
  * the reference fault-plan fuzz's body on fixed draws, port against
    reference: both end alike, including the draws (0, 353, 4) and
    (0, 9886, 4) whose plan corrupts the only snapshot, where both raise
    ``FileNotFoundError``, and two draws whose kills are recovered through
    a corrupt snapshot and a truncated journal."""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from _torch_serving import (ALT_TOKS, REQ_TOKS, SHARED_REQ_TOKS, SYS_TOKS,
                            Twin, assert_same_run, both)

TW = Twin("torch")
F = TW.faults


def _submit_all(tw, fe):
    for r in REQ_TOKS:
        fe.submit([tw.tok(SYS_TOKS), tw.tok(r)], n_samples=1,
                  max_new_tokens=5)


def _submit_shared(tw, fe):
    pfx = [SYS_TOKS, ALT_TOKS]
    for i, r in enumerate(SHARED_REQ_TOKS):
        fe.submit([tw.tok(pfx[i % 2]), tw.tok(r)], n_samples=1,
                  max_new_tokens=5)


def _results(fe):
    return ({t.tid: [list(map(int, x)) for x in (t.tokens or [])]
             for t in fe.tickets}, {t.tid: t.status for t in fe.tickets})


def _control(tw, factory, submit=_submit_all, **kw):
    fe = tw.frontend_(factory(), queue_depth=32, decode_steps=1, **kw)
    state = fe.init_state()
    submit(tw, fe)
    fe.drain(tw.params, state)
    return fe


def _drive(dfe, params, on_kill=None):
    pumps = 0
    while dfe.pending():
        pumps += 1
        assert pumps < 200, "recovery liveness failure"
        try:
            dfe.pump(params)
        except F.ProcessKilled:
            dfe.recover(params)
            if on_kill is not None:
                on_kill(dfe)
    return dfe


def _durable(tw, factory, plan, directory, snapshot_every=2,
             submit=_submit_all, fe_kw=None, **kw):
    dfe = tw.durable(factory, directory, fault_plan=plan,
                     snapshot_every=snapshot_every,
                     frontend_kwargs=dict(queue_depth=32, decode_steps=1,
                                          **(fe_kw or {})), **kw)
    dfe.init_state()
    submit(tw, dfe)
    return dfe


def _kills(*rounds):
    return F.FaultPlan([F.FaultEvent(r, F.FaultKind.KILL_PROCESS)
                        for r in rounds])


# ---------------------------------------------------------------------------
# kill-and-restore bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tree", "forest"])
@pytest.mark.parametrize("store", ["paged", "dense"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kill_and_restore_bit_identical(tmp_path, kind, store, dtype):
    factory = TW.factory(kind, store, dtype)
    ctrl = _control(TW, factory)
    assert_same_run(ctrl, _control(Twin("jax"), Twin("jax").factory(
        kind, store, dtype)), tol=1e-3 if dtype == "int8" else 1e-5)
    dfe = _drive(_durable(TW, factory, _kills(2, 4), str(tmp_path)),
                 TW.params)
    assert dfe.stats["recoveries"] == 2
    assert _results(dfe.fe) == _results(ctrl)
    assert all(s == "completed" for s in _results(ctrl)[1].values())
    assert dfe.fe.counters["audits_passed"] > 0
    assert dfe.fe.engine.audit_state(dfe.state, verify_checksums=True)


# ---------------------------------------------------------------------------
# durability faults, the snapshot cadence, packed prefills in flight
# ---------------------------------------------------------------------------

def test_snapshot_corruption_falls_back_to_previous(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    plan = F.FaultPlan([F.FaultEvent(3, F.FaultKind.SNAPSHOT_CORRUPT, arg=3),
                        F.FaultEvent(4, F.FaultKind.KILL_PROCESS)])
    dfe = _drive(_durable(TW, factory, plan, str(tmp_path)), TW.params)
    assert dfe.stats["recoveries"] == 1
    assert dfe.stats["snapshot_fallbacks"] >= 1
    assert any(n.endswith(".corrupt") for n in os.listdir(dfe.ckpt.directory))
    assert _results(dfe.fe) == _results(_control(TW, factory))


def test_journal_truncation_replay_stops_cleanly(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    plan = F.FaultPlan([F.FaultEvent(3, F.FaultKind.JOURNAL_TRUNCATE, arg=40),
                        F.FaultEvent(4, F.FaultKind.KILL_PROCESS)])
    dfe = _drive(_durable(TW, factory, plan, str(tmp_path),
                          snapshot_every=8), TW.params)
    assert dfe.stats["recoveries"] == 1
    assert dfe.fe.counters.get("journals_truncated") == 1
    assert _results(dfe.fe) == _results(_control(TW, factory))


class TickClock:
    """Every call returns the time, then advances it by ``dt``: each
    journal record measures exactly ``dt`` seconds."""

    def __init__(self, dt=1.0):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        v = self.t
        self.t += self.dt
        return v


def test_snapshot_budget_cadence_with_injected_clock(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    dfe = _durable(TW, factory, None, str(tmp_path), snapshot_every=8,
                   snapshot_budget_s=3.5, clock=TickClock(1.0))
    assert dfe.estimated_replay_s() == pytest.approx(4.0)
    dfe.pump(TW.params)                        # 5 records > 3.5 s
    assert sorted(dfe.ckpt.all_rounds()) == [0, 1]
    assert dfe.estimated_replay_s() == 0.0
    for _ in range(3):
        dfe.pump(TW.params)
    assert sorted(dfe.ckpt.all_rounds()) == [0, 1]
    assert dfe.estimated_replay_s() == pytest.approx(3.0)
    dfe.pump(TW.params)                        # 4 s > 3.5 s: round 5
    assert max(dfe.ckpt.all_rounds()) == 5
    assert dfe.stats["snapshots"] == 3
    assert dfe.metrics()["durability"]["estimated_replay_s"] == 0.0


def test_recovery_remeasures_replay_cost(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    clk = TickClock(1.0)
    dfe = _durable(TW, factory, _kills(2), str(tmp_path),
                   snapshot_budget_s=30.0, clock=clk)
    seen = []

    def on_kill(d):
        n = d.stats["replayed_submits"] + d.stats["replayed_rounds"]
        seen.append(n)
        assert d._replay_s_per_record == pytest.approx(1.0 / n)
        assert d._records_since_snapshot == 0

    _drive(dfe, TW.params, on_kill)
    assert dfe.stats["recoveries"] == 1 and seen and seen[0] > 0
    assert _results(dfe.fe) == _results(_control(TW, factory))


def test_packed_pending_defers_snapshots_and_recovers(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16", step_mode="packed",
                         prefill_chunk=5, suffix_prefill=True)
    ctrl = _control(TW, factory)

    def on_kill(d):
        assert d.fe.engine._pending and d.journal is not None

    dfe = _drive(_durable(TW, factory, _kills(2), str(tmp_path),
                          snapshot_every=1), TW.params, on_kill)
    assert dfe.stats["recoveries"] == 1
    assert dfe.stats["deferred_snapshots"] > 0
    assert _results(dfe.fe) == _results(ctrl)
    dfe.fe.engine.host_state()      # quiescent again once drained


def test_engines_count_their_steps_replays_included(tmp_path):
    """Each engine counts the decode-only and packed steps it ran
    (``steps_run``, which the card's launch gates are held against): an
    uninterrupted run's counts add up to the frontend's step ledger; in a
    killed run the recovered engines count the replayed steps again, so
    its engines ran more steps than its ledger, the control's, shows."""
    built = []

    def factory():
        built.append(TW.engine("tree", "paged", "bfloat16",
                               step_mode="packed", prefill_chunk=5,
                               suffix_prefill=True))
        return built[-1]

    ctrl = _control(TW, factory)
    runs = built[0].steps_run
    assert runs["packed"] > 0 and runs["decode"] > 0
    assert runs["packed"] + runs["decode"] == ctrl.io_ledger["steps"]
    built.clear()
    dfe = _drive(_durable(TW, factory, _kills(2, 4), str(tmp_path)),
                 TW.params)
    assert dfe.stats["recoveries"] == 2 and dfe.stats["replayed_rounds"] > 0
    assert _results(dfe.fe) == _results(ctrl)
    assert dfe.fe.io_ledger == ctrl.io_ledger
    assert sum(e.steps_run["packed"] + e.steps_run["decode"]
               for e in built) > ctrl.io_ledger["steps"]


# ---------------------------------------------------------------------------
# the sharing policy's journaled order
# ---------------------------------------------------------------------------

def _journal_orders(dfe):
    orders = []
    for name in sorted(os.listdir(dfe.journal_dir)):
        recs, _ = TW.journal.Journal.read(os.path.join(dfe.journal_dir, name))
        for rec in recs:
            if rec.get("ev") == "round":
                orders += [(rec["round"], o["tids"]) for o in rec["obs"]
                           if o.get("ev") == "admit_order"]
    return orders


def test_sharing_policy_admit_order_replays_divergence_free(tmp_path):
    """A twice-killed sharing-policy run ends as its control, and the
    admission orders journaled over all its epochs are the reference's
    control's, round for round (and not all in tid order)."""
    factory = TW.factory("tree", "paged", "bfloat16")
    ctrl = _control(TW, factory, _submit_shared, policy="sharing")
    tw_j = Twin("jax")
    ref_orders = []
    fe_j = tw_j.frontend_(tw_j.factory("tree", "paged", "bfloat16")(),
                          queue_depth=32, decode_steps=1, policy="sharing")
    fe_j.observer = lambda ev: ref_orders.append(
        (ev["round"], ev["tids"])) if ev["ev"] == "admit_order" else None
    state = fe_j.init_state()
    _submit_shared(tw_j, fe_j)
    fe_j.drain(tw_j.params, state)
    assert_same_run(ctrl, fe_j)

    dfe = _drive(_durable(TW, factory, _kills(2, 4), str(tmp_path),
                          keep_last_k=100, submit=_submit_shared,
                          fe_kw=dict(policy="sharing")), TW.params)
    assert dfe.stats["recoveries"] == 2 and dfe.stats["replayed_rounds"] > 0
    assert _results(dfe.fe) == _results(ctrl)
    orders = _journal_orders(dfe)
    assert orders == ref_orders
    assert any(o != sorted(o) for _, o in orders), orders


def test_tampered_admit_order_is_a_replay_divergence(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    dfe = _durable(TW, factory, _kills(3), str(tmp_path), snapshot_every=100,
                   keep_last_k=100, submit=_submit_shared,
                   fe_kw=dict(policy="sharing"))
    with pytest.raises(F.ProcessKilled):
        while dfe.pending():
            dfe.pump(TW.params)
    ep = os.path.join(dfe.journal_dir, "journal_000000000.log")
    recs, clean = TW.journal.Journal.read(ep)
    assert clean
    swapped = False
    for rec in recs:
        for o in rec.get("obs", []):
            if o.get("ev") == "admit_order" and len(o["tids"]) >= 2:
                o["tids"][0], o["tids"][1] = o["tids"][1], o["tids"][0]
                swapped = True
                break
        if swapped:
            break
    assert swapped
    os.remove(ep)
    j = TW.journal.Journal(ep)
    for rec in recs:
        j.append(rec)
    j.close()
    with pytest.raises(TW.recovery.ReplayDivergence, match="admit_order"):
        dfe.recover(TW.params)


# ---------------------------------------------------------------------------
# KV guards and supervision
# ---------------------------------------------------------------------------

def test_nan_sentinel_quarantines_only_poisoned_request():
    """NaNs in one request's private trie node: its decode goes
    non-finite, the frontend rejects it as ``kv_corruption`` and its
    neighbour on the shared root completes — on both packages alike."""
    def run(tw):
        fe = tw.frontend_(tw.engine("tree", "dense", "bfloat16"),
                          queue_depth=32, decode_steps=1)
        state = fe.init_state()
        for r in REQ_TOKS[:2]:
            fe.submit([tw.tok(SYS_TOKS), tw.tok(r)], max_new_tokens=5)
        state = fe.pump(tw.params, state)
        assert fe.ticket(0).status == "running"
        nid = fe.engine.requests[fe.ticket(0).handle]["path"][-1]
        cache = state.cache
        if tw.which == "jax":
            import dataclasses
            state = dataclasses.replace(state, cache=dataclasses.replace(
                cache, k_ctx=cache.k_ctx.at[:, nid].set(float("nan"))))
        else:
            cache.k_ctx[:, nid] = float("nan")
        fe.drain(tw.params, state)
        return fe

    tw_j, tw_t = both()
    fe = run(tw_t)
    assert_same_run(fe, run(tw_j))
    a, b = fe.ticket(0), fe.ticket(1)
    assert (a.status, a.reason) == ("rejected", "kv_corruption")
    assert b.status == "completed" and len(b.tokens[0]) == 5
    assert fe.counters.get("kv_quarantines") == 1


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_audit_verify_checksums_catches_kv_flip(store):
    fe = TW.frontend_(TW.engine("tree", store, "bfloat16"), decode_steps=1)
    state = fe.init_state()
    fe.submit([TW.tok(SYS_TOKS), TW.tok(REQ_TOKS[0])], max_new_tokens=5)
    state = fe.pump(TW.params, state)
    assert fe.engine.audit_state(state, verify_checksums=True)
    nid = fe.engine.requests[0]["path"][0]
    if store == "dense":
        cell = state.cache.k_ctx[0, nid, 0, 0, :1]
    else:
        pid = fe.engine.node_pages[nid][0]
        cell = state.cache.store.k_pages[0, pid, 0, 0, :1]
    cell.view(torch.int32).bitwise_xor_(1 << 20)
    with pytest.raises(TW.errors.KVCorruption, match="checksum"):
        fe.engine.audit_state(state, verify_checksums=True)


def test_stale_heartbeat_triggers_supervised_restart(tmp_path):
    factory = TW.factory("tree", "paged", "bfloat16")
    hb_path = str(tmp_path / "hb")
    dfe = TW.durable(factory, str(tmp_path / "state"), snapshot_every=2,
                     heartbeat_path=hb_path, stale_after_s=60.0,
                     frontend_kwargs=dict(decode_steps=1))
    dfe.init_state()
    _submit_all(TW, dfe)
    wedged = {"armed": True}

    def work(d, p):
        pumps = 0
        while d.pending():
            pumps += 1
            assert pumps < 200
            if wedged["armed"] and d.fe.round == 3:
                wedged["armed"] = False
                open(hb_path, "w").write(f"3 {time.time() - 3600}\n")
            d.pump(p)
        return d

    with pytest.raises(TW.fault_tolerance.StaleHeartbeat):
        work(dfe, TW.params)
    dfe.run_supervised(TW.params, work, max_restarts=3)
    for t in dfe.fe.tickets:
        assert t.status == "completed"
        assert all(len(tok) == 5 for tok in t.tokens)
    assert dfe.stats["recoveries"] >= 1


# ---------------------------------------------------------------------------
# SIGKILL of a real serving process
# ---------------------------------------------------------------------------

_HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(_HERE, "_torch_crash_drill_worker.py")


def _env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(_HERE), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker(mode, workdir, policy, sleep_s="0"):
    subprocess.run([sys.executable, WORKER, mode, str(workdir), policy,
                    sleep_s], env=_env(), check=True, timeout=300)


@pytest.mark.parametrize("policy", ["fifo", "sharing"])
def test_sigkill_drill_recovers_bit_identical(tmp_path, policy):
    ctrl_dir = tmp_path / "control"
    _worker("serve", ctrl_dir, policy)
    control = json.loads((ctrl_dir / "done.json").read_text())
    assert all(t["status"] == "completed" for t in control["tickets"])

    drill_dir = tmp_path / "drill"
    proc = subprocess.Popen([sys.executable, WORKER, "serve", str(drill_dir),
                             policy, "0.3"], env=_env())
    try:
        progress = drill_dir / "progress.txt"
        deadline = time.time() + 120
        seen = -1
        while time.time() < deadline:
            if progress.exists():
                try:
                    seen = int(progress.read_text().split()[0])
                except (ValueError, IndexError):
                    pass
                if seen >= 3:
                    break
            if proc.poll() is not None:
                pytest.fail(f"worker exited (rc={proc.returncode}) before "
                            f"the kill window")
            time.sleep(0.02)
        assert seen >= 3, "worker never reached the kill window"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    assert not (drill_dir / "done.json").exists()
    _worker("recover", drill_dir, policy)
    result = json.loads((drill_dir / "result.json").read_text())
    assert result["stats"]["recoveries"] == 1
    assert result["tickets"] == control["tickets"]


# ---------------------------------------------------------------------------
# the reference fault-plan fuzz's body on fixed draws, port vs reference
# ---------------------------------------------------------------------------

def _fuzz_outcome(tw, workload_seed, plan_seed, num_pages):
    """The body of the reference's ``test_frontend_fault_plan_fuzz`` on one
    draw: how it ends — ("raised", exception type) or ("ok", per-ticket
    outcome, tokens checked against the unkilled control)."""
    f = tw.faults
    factory = tw.factory("tree", "paged", "bfloat16", n_nodes=3, depth=2,
                         slots=3, node_capacity=16, num_pages=num_pages)

    def workload(submit, pump):
        rng = np.random.RandomState(workload_seed)
        prefixes = [rng.randint(0, 64, (1, 10)) for _ in range(2)]
        budgets = {}
        for i in range(4):
            pfx = prefixes[int(rng.randint(2))]
            sfx = rng.randint(0, 64, (1, int(rng.randint(2, 8))))
            mnt = int(rng.randint(3, 6))
            submit([tw.tok(pfx), tw.tok(sfx)],
                   n_samples=int(rng.randint(1, 3)), max_new_tokens=mnt,
                   priority=int(rng.randint(0, 2)))
            budgets[(tuple(pfx[0].tolist()), tuple(sfx[0].tolist()))] = mnt
            if i % 2:
                pump()
        return budgets

    def content_key(t):
        return tuple(tuple(int(x) for x in np.asarray(s)[0].tolist())
                     for s in t.segments)

    durability = (f.FaultKind.KILL_PROCESS, f.FaultKind.SNAPSHOT_CORRUPT,
                  f.FaultKind.JOURNAL_TRUNCATE)
    plan_full = f.FaultPlan.random(plan_seed, rounds=10, rate=0.35)
    plan_ctrl = f.FaultPlan([e for e in plan_full.events
                             if e.kind not in durability], seed=plan_seed)
    fe_c = tw.frontend_(factory(), fault_plan=plan_ctrl, stall_rounds=4,
                        max_attempts=6)
    holder = {"s": fe_c.init_state()}

    def pump_c():
        holder["s"] = fe_c.pump(tw.params, holder["s"])

    workload(fe_c.submit, pump_c)
    fe_c.drain(tw.params, holder["s"], max_rounds=120)
    ctrl = {content_key(t): [[int(x) for x in tok] for tok in t.tokens]
            for t in fe_c.tickets if t.status == "completed"}

    with tempfile.TemporaryDirectory(prefix="fuzz_recov_") as d:
        dfe = tw.durable(factory, d, fault_plan=plan_full, snapshot_every=3,
                         frontend_kwargs=dict(stall_rounds=4, max_attempts=6))
        dfe.init_state()

        def pump_once():
            target = dfe.fe.round + 1
            guard = 0
            while dfe.fe.round < target:
                guard += 1
                assert guard < 50, "kill recovery did not converge"
                try:
                    dfe.pump(tw.params)
                except f.ProcessKilled:
                    dfe.recover(tw.params)

        try:
            budgets = workload(dfe.submit, pump_once)
            pumps = 0
            while dfe.pending():
                pumps += 1
                assert pumps < 120, "fuzz drain liveness failure"
                pump_once()
        except (FileNotFoundError, AssertionError, RuntimeError) as e:
            return ("raised", type(e).__name__, dfe.stats)
        out = []
        for t in dfe.fe.tickets:
            key = content_key(t)
            assert t.status in ("completed", "rejected"), (t.tid, t.status)
            toks = None
            if t.status == "completed":
                toks = [[int(x) for x in tok] for tok in t.tokens]
                assert all(len(tok) == budgets[key] for tok in toks)
                if key in ctrl:
                    assert toks == ctrl[key], "diverged from the control"
            else:
                assert t.reason
            out.append((key, t.status, t.reason, toks))
        assert (dfe.fe.counters["audits_passed"]
                >= dfe.fe.metrics()["rounds"])
        return ("ok", out, dfe.stats)


@pytest.mark.parametrize("draw", [(0, 353, 4), (0, 9886, 4), (0, 14, 5),
                                  (0, 17, 5)])
def test_fault_plan_fuzz_draw_ends_as_the_reference(draw):
    got = _fuzz_outcome(TW, *draw)
    want = _fuzz_outcome(Twin("jax"), *draw)
    assert got == want
    if draw[2] == 4:
        # these plans corrupt the only snapshot before the first kill:
        # recovery has nothing valid to load, in both packages
        assert got[:2] == ("raised", "FileNotFoundError")
    else:
        # kills recovered (with a corrupt snapshot and a truncated journal,
        # which loses tail submits, on the way)
        assert got[0] == "ok" and got[2]["recoveries"] >= 1
