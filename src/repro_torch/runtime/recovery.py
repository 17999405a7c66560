"""Crash-consistent serving: snapshot + journal + deterministic replay.

The port's copy of the reference's ``repro/runtime/recovery.py``.
``ServeFrontend`` (runtime/frontend.py) is robust WITHIN a process, but
everything it knows lives in memory. ``DurableFrontend`` makes it survive
process death, with a serve loop whose scheduling time is VIRTUAL (one pump
= one round) and therefore deterministic:

  * **Snapshots** (``checkpoint.ServeCheckpointer``) — every
    ``snapshot_every`` rounds, or, with ``snapshot_budget_s`` set, whenever
    the journal tail's ESTIMATED replay time (records since the last
    snapshot x a measured per-record cost, EMA over live rounds and
    corrected by each actual replay; the clock is injectable) exceeds the
    budget. Either cadence defers while the engine has a packed prefill in
    flight (its host mirrors refuse to serialize mid-prefill). A snapshot
    holds the device state (pools, page tables, lengths, decode arms, the
    sampling generator) and the host blob (ticket table, engine mirrors,
    per-segment checksums, the fault plan's RNG stream).
  * **Write-ahead journal** (``runtime.journal.Journal``) — between
    snapshots, every ``submit`` and every completed ``pump`` round (with
    its observed events) is appended and fsync'd; one epoch file per
    snapshot.
  * **Recovery** — load the newest snapshot whose CRCs *and* KV segment
    checksums verify (quarantining corrupt ones and falling back), then
    REPLAY the journal tail: re-submit journaled submits, re-pump journaled
    rounds, cross-checking every replayed event against the journaled
    observations (``ReplayDivergence`` on any mismatch). A recovered engine
    produces bit-identical greedy tokens to an uninterrupted run.
  * **Supervision** (``runtime.fault_tolerance``) — ``run_supervised``
    wraps the caller's pump loop in ``supervise``: crashes and stale
    heartbeats trigger recover-and-resume, a capped restart budget, and past
    the cap an escalation to ``cold_start``.

Durability faults from ``runtime/faults.py`` land here through the
frontend's ``durability_hook``: ``snapshot_corrupt`` bit-flips the newest
snapshot's array bytes on disk, ``journal_truncate`` chops the live
journal's tail; both are suppressed during replay. ``kill_process`` unwinds
as ``ProcessKilled`` through the driver, who calls ``recover``; the
survived kill is then disabled so replay does not crash-loop on it.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import Optional

import torch

from repro_torch.checkpoint import ServeCheckpointer
from repro_torch.runtime.fault_tolerance import StaleHeartbeat, supervise
from repro_torch.runtime.faults import FaultEvent, FaultKind, FaultPlan
from repro_torch.runtime.frontend import ServeFrontend
from repro_torch.runtime.journal import Journal


class ReplayDivergence(RuntimeError):
    """Journal replay produced different events than the original
    timeline recorded. Either determinism broke (a scheduling decision
    read un-snapshotted state) or the snapshot/journal pair is
    inconsistent — both are bugs, never tolerable drift."""


class DurableFrontend:
    """A ``ServeFrontend`` whose state survives process death.

    ``engine_factory`` rebuilds a FRESH engine (a dead process's engine
    object is gone; recovery must reconstruct it from disk alone) —
    typically ``lambda: TreeServeEngine(model, cfg, tcfg)``.

    Typical crash-tolerant loop::

        dfe = DurableFrontend(factory, directory, fault_plan=plan)
        dfe.init_state()
        dfe.submit([sys, req], n_samples=2, max_new_tokens=8)
        while dfe.pending():
            try:
                dfe.pump(params)
            except ProcessKilled:
                dfe.recover(params)     # resume bit-identically
    """

    def __init__(self, engine_factory, directory: str, *,
                 frontend_kwargs: Optional[dict] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 snapshot_every: int = 8, keep_last_k: int = 3,
                 snapshot_budget_s: Optional[float] = None,
                 clock=time.monotonic,
                 heartbeat_path: Optional[str] = None,
                 stale_after_s: Optional[float] = None,
                 device="cuda"):
        self.engine_factory = engine_factory
        self.device = device
        self.directory = directory
        self.frontend_kwargs = dict(frontend_kwargs or {})
        self.fault_plan = fault_plan
        self.snapshot_every = snapshot_every
        self.keep_last_k = keep_last_k
        self.snapshot_budget_s = snapshot_budget_s
        self.clock = clock
        self.heartbeat_path = heartbeat_path
        self.stale_after_s = stale_after_s
        self.journal_dir = os.path.join(directory, "journal")
        os.makedirs(self.journal_dir, exist_ok=True)
        self.ckpt = ServeCheckpointer(os.path.join(directory, "snapshots"),
                                      keep_last_k=keep_last_k)
        self.stats = {"recoveries": 0, "snapshot_fallbacks": 0,
                      "replayed_rounds": 0, "replayed_submits": 0,
                      "snapshots": 0, "cold_starts": 0,
                      "deferred_snapshots": 0}
        # replay-cost model for ``snapshot_budget_s``: EMA of seconds to
        # apply ONE journal record, seeded from live execution (a replayed
        # round re-runs the same pump) and corrected by the measured rate
        # of each actual replay. None until the first record lands.
        self._replay_s_per_record: Optional[float] = None
        self._records_since_snapshot = 0
        self.journal: Optional[Journal] = None
        self.state = None
        self._replaying = False
        self._obs_buf: list = []
        self._build_frontend()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _build_frontend(self):
        """Fresh engine + frontend with our durability hooks installed —
        used at construction AND at the top of every recovery (the dead
        process's objects are unrecoverable by definition)."""
        engine = self.engine_factory()
        fe = ServeFrontend(engine, fault_plan=self.fault_plan,
                           heartbeat_path=self.heartbeat_path,
                           device=self.device, **self.frontend_kwargs)
        fe.observer = self._observe
        fe.durability_hook = self._durability_fault
        self.fe = fe

    def init_state(self):
        """Create the device state and lay down the round-0 base snapshot
        (recovery always has somewhere to land, even before the first
        periodic snapshot)."""
        self.state = self.fe.init_state()
        self._snapshot()
        return self.state

    def submit(self, segments, n_samples: int = 1, *,
               max_new_tokens: Optional[int] = None, priority: int = 0,
               deadline_rounds: Optional[int] = None) -> int:
        """Write-ahead submit: the request is journaled BEFORE the ticket
        table sees it, so a crash in between re-creates it on replay
        (at-least-once on the durable side, exactly-once after replay's
        tid cross-check)."""
        if not isinstance(segments, (list, tuple)):
            segments = [segments]
        segments = [torch.as_tensor(s) for s in segments]
        self.journal.append({
            "ev": "submit",
            "tid": len(self.fe.tickets),
            "segments": [[int(x) for x in s[0].tolist()] for s in segments],
            "n_samples": int(n_samples),
            "max_new_tokens": max_new_tokens,
            "priority": int(priority),
            "deadline_rounds": deadline_rounds,
        })
        t0 = self.clock()
        tid = self.fe.submit(segments, n_samples=n_samples,
                             max_new_tokens=max_new_tokens,
                             priority=priority,
                             deadline_rounds=deadline_rounds)
        self._note_record_cost(self.clock() - t0)
        return tid

    def pump(self, params, decode_steps: Optional[int] = None):
        """One scheduler round, made durable: pump the frontend, then
        journal the round with every event it emitted, then snapshot on
        cadence. ``ProcessKilled`` (and anything else) unwinds BEFORE the
        round is journaled — a crashed round leaves no record, and
        recovery re-executes it from scratch, which determinism makes
        indistinguishable from it never having started."""
        if (self.stale_after_s is not None and self.fe.heartbeat is not None
                and self.fe.heartbeat.stale(self.stale_after_s)):
            raise StaleHeartbeat(
                f"no heartbeat for > {self.stale_after_s}s "
                f"(last: {self.fe.heartbeat.last()!r})")
        self._obs_buf = []
        t0 = self.clock()
        self.state = self.fe.pump(params, self.state, decode_steps)
        dt = self.clock() - t0
        self.journal.append({"ev": "round", "round": self.fe.round,
                             "decode_steps": decode_steps,
                             "obs": self._obs_buf})
        self._note_record_cost(dt)
        if self._should_snapshot():
            self._snapshot()
        return self.state

    def pending(self) -> bool:
        return any(not t.terminal for t in self.fe.tickets)

    def ticket(self, tid: int):
        return self.fe.ticket(tid)

    def metrics(self) -> dict:
        m = self.fe.metrics()
        m["durability"] = dict(self.stats)
        m["durability"]["estimated_replay_s"] = self.estimated_replay_s()
        return m

    # ------------------------------------------------------------------
    # snapshot cadence — fixed interval, or a replay-time budget
    # ------------------------------------------------------------------
    def _note_record_cost(self, dt: float):
        """Fold one applied journal record's wall time into the
        per-record replay estimate (EMA, weight 1/4) and count it toward
        the records a crash right now would have to replay."""
        self._records_since_snapshot += 1
        dt = max(float(dt), 0.0)
        if self._replay_s_per_record is None:
            self._replay_s_per_record = dt
        else:
            self._replay_s_per_record = (0.75 * self._replay_s_per_record
                                         + 0.25 * dt)

    def estimated_replay_s(self) -> float:
        """Seconds a crash at this instant is estimated to cost in
        journal replay: records appended since the last snapshot times
        the per-record estimate (0.0 until anything is measured)."""
        if self._replay_s_per_record is None:
            return 0.0
        return self._records_since_snapshot * self._replay_s_per_record

    def _should_snapshot(self) -> bool:
        """Snapshot cadence decision, made after each journaled round.

        With ``snapshot_budget_s`` set, snapshot as soon as the
        ESTIMATED replay time of the journal tail exceeds the budget —
        cheap rounds (a mostly-idle queue) stretch the interval out,
        expensive rounds (deep decode batches, chunked prefills) pull
        the next snapshot in, so recovery time stays bounded instead of
        the record count. Without a budget, the fixed
        ``snapshot_every``-rounds cadence applies.

        Either way a due snapshot is DEFERRED while the engine has a
        packed prefill in flight (``_pending`` non-empty): its host
        mirrors deliberately refuse to serialize mid-prefill
        (``host_state`` raises), and the journaled rounds replay the
        partial prefill deterministically anyway. Budget cadence retries
        every round until quiescent; fixed cadence waits for the next
        multiple."""
        if self.snapshot_budget_s is not None:
            due = self.estimated_replay_s() > self.snapshot_budget_s
        else:
            due = bool(self.snapshot_every) and (
                self.fe.round % self.snapshot_every == 0)
        if due and getattr(self.fe.engine, "_pending", None):
            self.stats["deferred_snapshots"] += 1
            return False
        return due

    # ------------------------------------------------------------------
    # snapshots + journal epochs
    # ------------------------------------------------------------------
    def _host_blob(self) -> dict:
        return {
            "frontend": self.fe.host_state(),
            "engine": self.fe.engine.host_state(),
            "plan": (None if self.fault_plan is None else {
                "events": [[e.round, e.kind, e.arg, e.hold]
                           for e in self.fault_plan.events],
                "rng": self.fault_plan.rng_state(),
            }),
        }

    def _snapshot(self):
        """Atomic snapshot at the current round, then roll the journal to
        a new epoch file and GC epochs older than the oldest snapshot
        still on disk (they can never be replayed again)."""
        r = self.fe.round
        self.ckpt.save(r, self.state, self._host_blob())
        self.stats["snapshots"] += 1
        self._records_since_snapshot = 0
        if self.journal is not None:
            self.journal.close()
        ep = self._epoch_path(r)
        if os.path.exists(ep):
            # re-snapshot at a round that already had an epoch (recovery
            # with an empty replay tail): every record in the old file is
            # baked into the snapshot we just wrote — replaying it again
            # would double-apply, so the epoch starts over empty.
            os.remove(ep)
        self.journal = Journal(ep)
        keep_from = min(self.ckpt.all_rounds(), default=0)
        for name in os.listdir(self.journal_dir):
            m = re.fullmatch(r"journal_(\d+)\.log", name)
            if m and int(m.group(1)) < keep_from:
                os.remove(os.path.join(self.journal_dir, name))

    def _epoch_path(self, round_: int) -> str:
        return os.path.join(self.journal_dir, f"journal_{round_:09d}.log")

    def _epoch_rounds(self):
        out = []
        for name in os.listdir(self.journal_dir):
            m = re.fullmatch(r"journal_(\d+)\.log", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _tail_end_epoch(self, from_round: int) -> int:
        """Round of the epoch the replay chain ENDS in — the first
        unclean epoch >= ``from_round`` if any (later epochs describe
        unreachable state), else the newest epoch, else ``from_round``.
        This is the file further appends must continue when recovery
        cannot roll a fresh epoch yet."""
        last = from_round
        for er in self._epoch_rounds():
            if er < from_round:
                continue
            last = er
            _, clean = Journal.read(self._epoch_path(er))
            if not clean:
                break
        return last

    def _journal_tail(self, from_round: int):
        """Chain journal epochs >= ``from_round`` back together, stopping
        the chain at the first UNCLEAN epoch (a torn tail means every
        later epoch, if any, describes state we can no longer reach)."""
        records = []
        for er in self._epoch_rounds():
            if er < from_round:
                continue
            recs, clean = Journal.read(self._epoch_path(er))
            records.extend(recs)
            if not clean:
                break
        return records

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def recover(self, params):
        """Reconstruct the pre-crash frontend from disk alone:

        1. fresh engine + frontend (``engine_factory``);
        2. newest snapshot whose per-leaf CRCs AND KV segment checksums
           verify — corrupt ones are quarantined and the next-older one
           is tried (``snapshot_fallbacks`` counts them);
        3. restore device state, host mirrors, and the fault plan's RNG
           stream; disable the ``kill_process`` event we just died from
           (re-firing it on replay would crash-loop);
        4. replay the journal tail — re-submit journaled submits,
           re-pump journaled rounds — cross-checking every replayed
           event against the journaled observations;
        5. snapshot immediately (the recovered state becomes the new
           base, so a crash *during* a long replay never compounds).
        """
        self.stats["recoveries"] += 1
        # warm recovery (same process caught ProcessKilled): the dying
        # frontend's round pins the true crash round even when a
        # journal_truncate ate the records that would prove it.
        observed_crash = self.fe.round + 1 if self.fe is not None else 0
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        # drop the dead timeline's device state before the template is
        # allocated; the snapshot is loaded into the template in place
        self.state = None
        self._build_frontend()
        template = self.fe.init_state()

        def validate(round_, device_state, host):
            probe = self.engine_factory()
            probe.load_host_state(host["engine"])
            probe.verify_checksums(device_state)

        before = self.ckpt.all_rounds()
        r, self.state, host = self.ckpt.load_latest(template,
                                                    validate=validate)
        self.stats["snapshot_fallbacks"] += len([x for x in before if x > r])
        self.fe.load_host_state(host["frontend"])
        self.fe.engine.load_host_state(host["engine"])
        if self.fault_plan is not None and host.get("plan"):
            self.fault_plan.events = sorted(
                (FaultEvent(*e) for e in host["plan"]["events"]),
                key=lambda e: e.round)
            self.fault_plan.set_rng_state(host["plan"]["rng"])

        records = self._journal_tail(r)
        crash_round = max((rec["round"] for rec in records
                           if rec["ev"] == "round"), default=r) + 1
        crash_round = max(crash_round, observed_crash)
        if self.fault_plan is not None:
            self.fault_plan.disable(FaultKind.KILL_PROCESS, crash_round)

        self._replaying = True
        t_replay = self.clock()
        try:
            for rec in records:
                if rec["ev"] == "submit":
                    segs = [torch.tensor([s], dtype=torch.int32)
                            for s in rec["segments"]]
                    tid = self.fe.submit(
                        segs, n_samples=rec["n_samples"],
                        max_new_tokens=rec["max_new_tokens"],
                        priority=rec["priority"],
                        deadline_rounds=rec["deadline_rounds"])
                    if tid != rec["tid"]:
                        raise ReplayDivergence(
                            f"replayed submit got tid {tid}, journal "
                            f"recorded {rec['tid']}")
                    self.stats["replayed_submits"] += 1
                elif rec["ev"] == "round":
                    self._obs_buf = []
                    self.state = self.fe.pump(params, self.state,
                                              rec["decode_steps"])
                    if self._obs_buf != rec["obs"]:
                        raise ReplayDivergence(
                            f"round {rec['round']}: replay emitted "
                            f"{self._obs_buf!r} but journal recorded "
                            f"{rec['obs']!r}")
                    self.stats["replayed_rounds"] += 1
        finally:
            self._replaying = False
        if records:
            # the replay we just did IS the quantity the budget bounds:
            # adopt its measured per-record rate outright (the live-
            # execution EMA is only a proxy for it).
            self._replay_s_per_record = (
                max(self.clock() - t_replay, 0.0) / len(records))
        if getattr(self.fe.engine, "_pending", None):
            # the crash landed mid packed-prefill: the engine's host
            # mirrors refuse to serialize until the chunks drain, so the
            # post-recovery base snapshot is deferred to the next
            # quiescent pump. Keep journaling into the newest replayed
            # epoch — compacted first, so appends after a torn tail stay
            # readable — and replay-from-r covers the gap meanwhile.
            self.stats["deferred_snapshots"] += 1
            ep = self._epoch_path(self._tail_end_epoch(r))
            Journal.compact(ep)
            self.journal = Journal(ep)
            self._records_since_snapshot = len(records)
        else:
            self._snapshot()
        return self.state

    def cold_start(self):
        """Last-resort escalation: discard ALL durable state and begin
        from nothing. Every in-flight request is lost — which is why
        ``run_supervised`` only lands here after the restart budget is
        exhausted."""
        self.stats["cold_starts"] += 1
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        shutil.rmtree(os.path.join(self.directory, "snapshots"),
                      ignore_errors=True)
        shutil.rmtree(self.journal_dir, ignore_errors=True)
        os.makedirs(self.journal_dir, exist_ok=True)
        self.ckpt = ServeCheckpointer(os.path.join(self.directory,
                                                   "snapshots"),
                                      keep_last_k=self.keep_last_k)
        self._build_frontend()
        return self.init_state()

    def run_supervised(self, params, work_fn, *, max_restarts: int = 3,
                       backoff_s: float = 0.0, sleep=time.sleep):
        """Run ``work_fn(self, params)`` under ``supervise``: any failure
        (``ProcessKilled``, ``StaleHeartbeat``, crash) triggers
        ``recover`` and a re-invocation of ``work_fn`` against the
        restored state; past ``max_restarts`` consecutive failures the
        frontend escalates to ``cold_start`` and runs the workload once
        from scratch."""
        try:
            return supervise(
                lambda: work_fn(self, params),
                max_restarts=max_restarts, backoff_s=backoff_s, sleep=sleep,
                on_failure=lambda attempt, exc: self.recover(params))
        except Exception:  # noqa: BLE001 — budget exhausted: escalate
            self.cold_start()
            return work_fn(self, params)

    # ------------------------------------------------------------------
    # hooks (installed on the wrapped frontend)
    # ------------------------------------------------------------------
    def _observe(self, ev: dict):
        self._obs_buf.append(ev)

    def _durability_fault(self, ev):
        """Disk-level fault injections delegated by the frontend. During
        replay these are suppressed: the damage already happened on the
        original timeline, and re-damaging the very files we are
        recovering from would turn one injected fault into an
        unrecoverable cascade."""
        if self._replaying:
            self.fe._count("replay_durability_suppressed")
            return
        if ev.kind == FaultKind.SNAPSHOT_CORRUPT:
            rounds = self.ckpt.all_rounds()
            if not rounds:
                self.fe._count("snapshot_corrupt_noop")
                return
            path = os.path.join(self.ckpt.path_for(max(rounds)),
                                "arrays.bin")
            size = os.path.getsize(path)
            if size == 0:
                self.fe._count("snapshot_corrupt_noop")
                return
            with open(path, "r+b") as f:
                pos = (ev.arg * 7919) % size
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0x40]))
            self.fe._count("snapshots_corrupted")
        elif ev.kind == FaultKind.JOURNAL_TRUNCATE:
            size = os.path.getsize(self.journal.path)
            if size == 0:
                self.fe._count("journal_truncate_noop")
                return
            os.truncate(self.journal.path, max(0, size - max(1, ev.arg)))
            self.fe._count("journals_truncated")


__all__ = ["DurableFrontend", "ReplayDivergence"]
