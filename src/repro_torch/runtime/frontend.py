"""Fault-tolerant serving frontend: admission queue, backoff, preemption.

The port's copy of the reference's ``repro/runtime/frontend.py``. The
slot-table engines (``runtime/serve.py``) are strict: ``admit`` RAISES a
typed ``CapacityError`` (core/errors.py) the moment a request does not fit.
``ServeFrontend`` wraps a ``ForestServeEngine`` or ``TreeServeEngine`` with
the robustness ladder a serving process needs:

    admit  ->  queue (capped exponential backoff)  ->  preempt  ->  reject

  * **Admission queue** — ``submit`` never raises on capacity: a request
    starts RUNNING, waits QUEUED (bounded queue; overflow is a typed
    ``queue_full`` rejection), or is REJECTED with a machine-readable
    reason. Transient failures (``retryable`` capacity errors) back off
    exponentially, capped; permanent ones reject at once.
  * **Preemption under pool pressure** — a queued request starved past
    ``preempt_after`` attempts evicts the policy's chosen victim among the
    live requests of lower effective priority (priority + preemptions
    suffered: aging) and RE-QUEUES it; under greedy decoding its re-run
    tokens are identical.
  * **Deadlines & watchdog** — per-request deadlines (in scheduler rounds)
    reject overdue work with ``deadline_exceeded``; a stuck-decode watchdog
    (no token progress for ``stall_rounds``) breaks a retirement hold and
    preempts wedged requests; every pump beats a
    ``runtime/fault_tolerance.Heartbeat`` when one is configured.
  * **Fault injection, quarantine & auditing** — a ``runtime/faults.FaultPlan``
    injects deterministic faults at pump boundaries; slots whose decode
    output went non-finite (the engines' ``corrupt_slots`` sentinel) have
    their request cancelled and rejected as ``kv_corruption``; every pump
    ends with ``engine.audit_state`` (``PageAllocator.audit``). Requests
    untouched by a fault produce bit-identical greedy tokens to a
    fault-free run (the blast-radius contract).

Scheduling time is VIRTUAL (one ``pump`` = one round): backoff, deadlines
and the watchdog are deterministic functions of the workload and the
fault-plan seed. Wall-clock is recorded per ticket for latency reporting
only. Token segments are tensors on the engine's device (``device=``, CUDA
unless the caller asks for the CPU); finished tokens and log-probs are
host numpy arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.errors import AllocatorCorruption, CapacityError
from repro_torch.core.paged import pages_needed
from repro_torch.runtime.fault_tolerance import Heartbeat
from repro_torch.runtime.faults import FaultKind, FaultPlan, ProcessKilled
from repro_torch.runtime.scheduler import make_policy


# Ticket lifecycle states. PREEMPTED is a TRANSITION, not a state: a
# preempted ticket goes back to QUEUED (preemptions += 1) and must end
# COMPLETED or REJECTED like everyone else.
QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
REJECTED = "rejected"
TERMINAL = (COMPLETED, REJECTED)

# Frontend-level rejection reasons (engine-level ones come from
# CapacityError.reason).
REASON_QUEUE_FULL = "queue_full"
REASON_INFEASIBLE = "request_infeasible"
REASON_DEADLINE = "deadline_exceeded"
REASON_MAX_ATTEMPTS = "max_attempts_exhausted"
REASON_KV_CORRUPTION = "kv_corruption"

# A starved request backs off 2**(attempts-1) rounds, at most
# BACKOFF_CAP; a submit without max_new_tokens gets DEFAULT_MAX_NEW_TOKENS.
BACKOFF_CAP = 8
DEFAULT_MAX_NEW_TOKENS = 8


@dataclasses.dataclass
class Ticket:
    """One submitted request and everything observed about it."""

    tid: int
    segments: List            # (1, m) token tensors (trie path order)
    n_samples: int
    max_new_tokens: int
    priority: int = 0                     # higher = more important
    deadline_round: Optional[int] = None  # absolute round; None = no deadline
    status: str = QUEUED
    reason: Optional[str] = None          # set when REJECTED
    attempts: int = 0                     # failed admission tries
    next_try: int = 0                     # earliest round to retry admission
    preemptions: int = 0
    handle: int = -1                      # engine request id / group id
    slots: List[int] = dataclasses.field(default_factory=list)
    submitted_round: int = 0
    admitted_round: Optional[int] = None
    finished_round: Optional[int] = None
    submit_wall: float = 0.0
    finish_wall: Optional[float] = None
    tokens: Optional[List[np.ndarray]] = None    # per-sample, on completion
    logprobs: Optional[List[np.ndarray]] = None
    tokens_emitted: int = 0
    last_progress_round: int = 0
    fault_touched: bool = False           # a fault targeted THIS ticket
    _preempting: bool = False             # requeue (not complete) at retire
    _deadline_hit: bool = False           # reject (not complete) at retire
    _corrupt: bool = False                # reject kv_corruption at retire

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL

    def per_token_latency(self) -> Optional[float]:
        """Wall seconds per emitted token, submit -> finish (reporting
        only — scheduling never reads wall time)."""
        if self.finish_wall is None or not self.tokens:
            return None
        n = sum(len(t) for t in self.tokens)
        if n == 0:
            return None
        return (self.finish_wall - self.submit_wall) / n


class ServeFrontend:
    """Robust admission frontend over a slot-table serve engine
    (``ForestServeEngine`` or ``TreeServeEngine``, dense or paged).

    Typical loop::

        fe = ServeFrontend(engine)               # device="cpu" off the card
        state = fe.init_state()
        tid = fe.submit(segments, n_samples=2, max_new_tokens=8)
        state = fe.drain(params, state)          # pump until quiescent
        fe.ticket(tid).status                    # 'completed' / 'rejected'
    """

    def __init__(self, engine, *,
                 queue_depth: int = 64,
                 max_attempts: int = 8,
                 preempt_after: int = 2,
                 stall_rounds: int = 8,
                 decode_steps: int = 4,
                 fault_plan: Optional[FaultPlan] = None,
                 heartbeat_path: Optional[str] = None,
                 policy="fifo",
                 device="cuda"):
        self.engine = engine
        # the engine's device: its state lives there, and submitted token
        # segments are moved there (CUDA unless the caller asks for the CPU)
        self.device = resolve_device(device)
        # admission policy (runtime/scheduler.py): "fifo" reproduces
        # the classic priority-then-submission drain; "sharing"
        # co-schedules queued requests that share trie ancestors to
        # minimize modelled context bytes/step. The same object ranks
        # preemption victims.
        self.policy = make_policy(policy)
        self.queue_depth = queue_depth
        self.max_attempts = max_attempts
        self.preempt_after = preempt_after
        self.stall_rounds = stall_rounds
        self.decode_steps = decode_steps
        self.fault_plan = fault_plan
        self.heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None

        self._is_tree = hasattr(engine, "retire_requests")
        self.round = 0
        self.tickets: List[Ticket] = []
        self.counters: Dict[str, int] = {}
        self.occupancy_log: List[dict] = []
        # modelled per-step IO ledger (engine.step_io_bytes x decode
        # chunks): the bytes/step axis the admission-policy A/B is
        # judged on. Snapshot state — replayed rounds re-accumulate it
        # deterministically.
        self.io_ledger: Dict[str, int] = {
            "ctx_bytes": 0, "total_bytes": 0, "steps": 0}
        self._retire_suppressed_until = -1
        self._stolen: List = []   # (return_round, page_ids) under fault
        # durability hooks (installed by runtime/recovery.DurableFrontend):
        # ``observer`` receives every state-mutating event as a dict (the
        # write-ahead journal records them; replay re-verifies them);
        # ``durability_hook`` claims the disk-level fault injections
        # (snapshot_corrupt / journal_truncate) that a memory-only
        # frontend has no substrate for.
        self.observer = None
        self.durability_hook = None

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def init_state(self):
        return self.engine.init_state(device=self.device)

    def submit(self, segments, n_samples: int = 1, *,
               max_new_tokens: Optional[int] = None, priority: int = 0,
               deadline_rounds: Optional[int] = None) -> int:
        """Submit a request; NEVER raises on capacity. Returns a ticket id
        whose status is QUEUED, or already REJECTED with a typed reason
        (``queue_full`` for a saturated admission queue,
        ``request_infeasible`` for a request no amount of retirement can
        ever fit). ``segments`` is a (1, m) token array or a list of them
        (trie path, outermost shared level first); ``deadline_rounds`` is
        relative to now, in scheduler rounds."""
        if not isinstance(segments, (list, tuple)):
            segments = [segments]
        segments = [torch.as_tensor(s, device=self.device) for s in segments]
        t = Ticket(
            tid=len(self.tickets), segments=segments, n_samples=n_samples,
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else DEFAULT_MAX_NEW_TOKENS),
            priority=priority,
            deadline_round=(self.round + deadline_rounds
                            if deadline_rounds is not None else None),
            submitted_round=self.round, next_try=self.round,
            submit_wall=time.perf_counter(),
        )
        self.tickets.append(t)
        self._count("submitted")
        why = self._infeasible_reason(t)
        if why is not None:
            self._reject(t, why)
        elif len(self._queued()) > self.queue_depth:
            self._reject(t, REASON_QUEUE_FULL)
        return t.tid

    def pump(self, params, state, decode_steps: Optional[int] = None):
        """One scheduler round: inject faults, collect retirements, enforce
        deadlines, run the admission ladder, decode one chunk, expire
        finished generations, run the watchdog, audit. Returns the new
        device state. Never raises on capacity — only on genuine
        invariant violations (``AllocatorCorruption``)."""
        self.round += 1
        if self.heartbeat is not None:
            self.heartbeat.beat(self.round)
        state = self._inject_faults(state)
        state = self._return_stolen_pages(state)
        state = self._collect(state)
        state = self._check_deadlines(state)
        state = self._admit_pass(params, state)
        state = self._expire_finished(state)
        state = self._decode(params, state,
                             decode_steps or self.decode_steps)
        state = self._quarantine_corrupt(state)
        state = self._expire_finished(state)
        state = self._collect(state)
        state = self._watchdog(params, state)
        self.occupancy_log.append(
            dict(self.engine.occupancy(state), round=self.round))
        # stolen (fault-held) pages are allocated but live outside the
        # engine mirrors — declare them so reconciliation stays exact
        stolen = [i for _, ids in self._stolen for i in ids]
        self.engine.audit_state(state, extra_tracked=stolen)
        self._count("audits_passed")
        return state

    def drain(self, params, state, *, max_rounds: int = 1000,
              decode_steps: Optional[int] = None):
        """Pump until every ticket is terminal (or ``max_rounds``, which
        raises — a liveness failure, not a capacity condition)."""
        while any(not t.terminal for t in self.tickets):
            if self.round >= max_rounds:
                stuck = [t.tid for t in self.tickets if not t.terminal]
                raise RuntimeError(
                    f"drain: tickets {stuck} not terminal after "
                    f"{max_rounds} rounds (liveness bug or starved "
                    f"workload)")
            state = self.pump(params, state, decode_steps)
        return state

    def ticket(self, tid: int) -> Ticket:
        return self.tickets[tid]

    def metrics(self) -> dict:
        """Counters + terminal-state summary for reporting."""
        by_status: Dict[str, int] = {}
        by_reason: Dict[str, int] = {}
        for t in self.tickets:
            by_status[t.status] = by_status.get(t.status, 0) + 1
            if t.reason:
                by_reason[t.reason] = by_reason.get(t.reason, 0) + 1
        lat = [t.per_token_latency() for t in self.tickets]
        lat = sorted(x for x in lat if x is not None)
        il = self.io_ledger
        return {
            "rounds": self.round,
            "policy": self.policy.name,
            "by_status": by_status,
            "rejections_by_reason": by_reason,
            "preemptions": sum(t.preemptions for t in self.tickets),
            "counters": dict(self.counters),
            "per_token_latency_s": {
                "p50": _pct(lat, 50), "p99": _pct(lat, 99),
            },
            "modelled_io": {
                "decode_steps": il["steps"],
                "ctx_bytes_per_step": (
                    round(il["ctx_bytes"] / il["steps"], 2)
                    if il["steps"] else None),
                "total_bytes_per_step": (
                    round(il["total_bytes"] / il["steps"], 2)
                    if il["steps"] else None),
            },
        }

    # ------------------------------------------------------------------
    # durable host state (checkpoint/ServeCheckpointer snapshots)
    # ------------------------------------------------------------------
    def host_state(self) -> dict:
        """Everything host-side a recovered frontend needs to resume
        scheduling bit-identically: the full ticket table (including
        queued backoff clocks and in-flight flags), the round counter,
        fault bookkeeping, and the counters. JSON-able; device state is
        snapshotted separately by ``ServeCheckpointer``. Wall-clock
        fields round-trip as-is — they are reporting-only and never read
        by scheduling."""
        return {
            "round": self.round,
            "tickets": [_ticket_to_dict(t) for t in self.tickets],
            "counters": dict(self.counters),
            "occupancy_log": list(self.occupancy_log),
            "retire_suppressed_until": self._retire_suppressed_until,
            "stolen": [[due, [int(i) for i in ids]]
                       for due, ids in self._stolen],
            "io_ledger": {k: int(v) for k, v in self.io_ledger.items()},
        }

    def load_host_state(self, d: dict):
        self.round = int(d["round"])
        self.tickets = [_ticket_from_dict(x, self.device)
                        for x in d["tickets"]]
        self.counters = dict(d["counters"])
        self.occupancy_log = list(d["occupancy_log"])
        self._retire_suppressed_until = int(d["retire_suppressed_until"])
        self._stolen = [(int(due), list(ids)) for due, ids in d["stolen"]]
        self.io_ledger = {k: int(v)
                          for k, v in d.get("io_ledger", {
                              "ctx_bytes": 0, "total_bytes": 0,
                              "steps": 0}).items()}

    # ------------------------------------------------------------------
    # scheduling passes
    # ------------------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        self.counters[key] = self.counters.get(key, 0) + n

    def _emit(self, **ev):
        """Report one state-mutating event to the observer (the recovery
        manager's write-ahead journal). Events are plain JSON-able dicts;
        they double as the replay cross-check — a recovered frontend
        re-pumping a journaled round must emit the same events."""
        if self.observer is not None:
            self.observer(ev)

    def _queued(self) -> List[Ticket]:
        return [t for t in self.tickets if t.status == QUEUED]

    def _running(self) -> List[Ticket]:
        return [t for t in self.tickets if t.status == RUNNING]

    def _infeasible_reason(self, t: Ticket) -> Optional[str]:
        """A request that can NEVER fit this engine's envelope (no amount
        of retirement helps) — reject at submit, before it wastes queue
        slots and retries."""
        eng, ecfg = self.engine, self.engine.ecfg
        if t.n_samples > ecfg.slots:
            return REASON_INFEASIBLE
        if t.max_new_tokens - 1 > ecfg.decode_capacity:
            return REASON_INFEASIBLE
        if self._is_tree:
            if len(t.segments) > ecfg.depth:
                return REASON_INFEASIBLE
            if any(int(s.shape[1]) > ecfg.node_capacity
                   for s in t.segments):
                return REASON_INFEASIBLE
            if len(t.segments) > ecfg.n_nodes:
                return REASON_INFEASIBLE
        else:
            total = sum(int(s.shape[1]) for s in t.segments)
            if total > ecfg.ctx_capacity:
                return REASON_INFEASIBLE
        if getattr(eng, "paged", False):
            need = sum(pages_needed(int(s.shape[1]), ecfg.page_size)
                       for s in t.segments)
            # gate against the TOTAL pool, not the free list: with the
            # prefix cache on, cached-resident pages are evictable on
            # demand, so any request fitting the whole pool is feasible
            if need > eng.num_pages:
                return REASON_INFEASIBLE
        return None

    def _reject(self, t: Ticket, reason: str):
        t.status, t.reason = REJECTED, reason
        t.finished_round = self.round
        t.finish_wall = time.perf_counter()
        self._count(f"rejected_{reason}")
        self._emit(ev="reject", tid=t.tid, round=self.round, reason=reason)

    def _engine_admit(self, params, state, t: Ticket):
        if self._is_tree:
            state, slots = self.engine.admit(params, state, t.segments,
                                             t.n_samples)
            # stable rid from the engine's monotonic counter — the request
            # table is a compacted dict, NOT a dense history list
            t.handle = self.engine.last_rid
        else:
            ctx = (t.segments[0] if len(t.segments) == 1
                   else torch.cat(t.segments, dim=1))
            state, slots = self.engine.admit(params, state, ctx, t.n_samples)
            t.handle = self.engine.slot_group[slots[0]]
        t.slots = list(slots)
        t.status = RUNNING
        t.admitted_round = self.round
        t.tokens_emitted = t.n_samples       # first token sampled at admit
        t.last_progress_round = self.round
        # journal the engine-side outcome (which nodes/group the request
        # landed on, which slots fanned out) — the write_node/assign_paths
        # audit trail replay verifies against
        self._emit(ev="admit", tid=t.tid, round=self.round,
                   handle=int(t.handle), slots=[int(s) for s in t.slots],
                   path=(list(self.engine.requests[t.handle]["path"])
                         if self._is_tree else [int(t.handle)]))
        return state

    def _admit_pass(self, params, state):
        """The admission ladder. Eligible queued tickets (backoff
        expired) try to admit in the order the POLICY chooses
        (``runtime/scheduler.py`` — fifo: priority desc, submission
        order; sharing: SLO lanes then greedy marginal bytes/step
        gain); transient failures back off exponentially (capped),
        starved tickets trigger preemption, permanent failures and
        exhausted retry budgets become typed rejections. The chosen
        order is journaled (``admit_order`` event) BEFORE any admission
        applies, so replay recovery cross-checks the policy's decision
        itself, not just its side effects."""
        eligible = [t for t in self._queued() if t.next_try <= self.round]
        order = self.policy.admit_order(self, eligible)
        if order:
            self._emit(ev="admit_order", round=self.round,
                       policy=self.policy.name,
                       tids=[int(t.tid) for t in order])
        for t in order:
            state = self._try_admit_one(params, state, t)
        return state

    def _try_admit_one(self, params, state, t: Ticket):
        try:
            state = self._engine_admit(params, state, t)
            self._count("admitted")
            return state
        except CapacityError as e:
            if not e.retryable:
                self._reject(t, e.reason)
                return state
            t.attempts += 1
            last_reason = e.reason
        # starved past the preemption threshold: evict the lowest-priority,
        # least-shared live request and retry once, immediately.
        if t.attempts >= self.preempt_after:
            victim = self._pick_victim(t)
            if victim is not None:
                state = self._preempt(state, victim)
                # resources free at RETIREMENT, not at cancel: run the
                # collection pass now (requeues the victim, releases its
                # pages) so the immediate retry sees the freed capacity.
                # Under a DELAYED_RETIREMENT fault this no-ops and the
                # retry fails back into backoff — faithful to the fault.
                state = self._collect(state)
                try:
                    state = self._engine_admit(params, state, t)
                    self._count("admitted_after_preempt")
                    return state
                except CapacityError as e:
                    if not e.retryable:
                        self._reject(t, e.reason)
                        return state
                    t.attempts += 1
                    last_reason = e.reason
        if t.attempts > self.max_attempts:
            self._reject(t, last_reason or REASON_MAX_ATTEMPTS)
            return state
        backoff = min(BACKOFF_CAP, 2 ** (t.attempts - 1))
        t.next_try = self.round + backoff
        self._count("backoffs")
        return state

    def _pick_victim(self, requester: Ticket) -> Optional[Ticket]:
        """Preemption victim choice: among live requests STRICTLY below
        the requester's effective priority (base priority + preemptions
        already suffered — aging, so repeatedly-evicted work climbs out
        of victimhood and preemption cycles terminate), the POLICY's
        ``victim_key`` picks the minimum — the same score that ranks
        admissions, inverted (fifo: least-shared node count; sharing:
        fewest shared context bytes/step), then the youngest (least
        sunk decode work)."""
        def eff(t: Ticket) -> int:
            return t.priority + t.preemptions

        cands = [t for t in self._running() if eff(t) < eff(requester)]
        if not cands:
            return None
        return min(cands, key=lambda t: self.policy.victim_key(self, t))

    def _preempt(self, state, victim: Ticket, *, fault: bool = False):
        """Cancel a running ticket's slots and mark it for REQUEUE at the
        retirement pass (status flows RUNNING -> [retire] -> QUEUED).
        Resources free through the engines' ordinary refcounted
        retirement — shared trie ancestors survive."""
        if self._is_tree:
            state = self.engine.cancel_request(state, victim.handle)
        else:
            state = self.engine.cancel_group(state, victim.handle)
        victim._preempting = True
        victim.fault_touched = victim.fault_touched or fault
        self._count("preemptions_fault" if fault else "preemptions_pressure")
        self._emit(ev="preempt", tid=victim.tid, round=self.round,
                   fault=bool(fault))
        return state

    def _collect(self, state):
        """Retirement + ticket finalization. A RUNNING ticket whose engine
        request/group has retired becomes COMPLETED (results gathered
        from the host-side output lists), re-QUEUED (preemption), or
        REJECTED (deadline). Suppressed entirely while a
        DELAYED_RETIREMENT fault holds — the watchdog breaks the hold."""
        if self.round <= self._retire_suppressed_until:
            self._count("retirement_suppressed")
            return state
        # ONE device→host sync of the active mask per collection pass,
        # threaded through retirement (free_slots in the next admit pays
        # its own — the mask changes at decode, not here)
        active = state.active.cpu().numpy()
        if self._is_tree:
            self.engine.retire_requests(state, active=active)
        else:
            self.engine.retire_groups(state, active=active)
        if getattr(self.engine, "paged", False):
            state = self.engine.release_retired(state)
        for t in self._running():
            live = (self.engine.request_live(t.handle) if self._is_tree
                    else self.engine.group_live[t.handle])
            if live:
                continue
            if t._corrupt:
                # quarantined: its collected output is untrustworthy from
                # the first non-finite step — never surface it
                self._reject(t, REASON_KV_CORRUPTION)
            elif t._preempting:
                t._preempting = False
                t.status = QUEUED
                t.preemptions += 1
                t.attempts = 0
                t.next_try = self.round + 1
                t.handle, t.slots = -1, []
                t.tokens_emitted = 0
                self._count("requeued_after_preempt")
                self._emit(ev="requeue", tid=t.tid, round=self.round)
            elif t._deadline_hit:
                self._reject(t, REASON_DEADLINE)
            else:
                t.tokens = [np.asarray(self.engine.outputs[s])
                            for s in t.slots]
                t.logprobs = [np.asarray(self.engine.logps[s])
                              for s in t.slots]
                t.status = COMPLETED
                t.finished_round = self.round
                t.finish_wall = time.perf_counter()
                self._count("completed")
                self._emit(ev="complete", tid=t.tid, round=self.round,
                           n_tokens=sum(len(x) for x in t.tokens))
        return state

    def _check_deadlines(self, state):
        for t in self.tickets:
            if t.deadline_round is None or self.round <= t.deadline_round:
                continue
            if t.status == QUEUED:
                self._reject(t, REASON_DEADLINE)
            elif t.status == RUNNING and not t._deadline_hit:
                t._deadline_hit = True
                if self._is_tree:
                    state = self.engine.cancel_request(state, t.handle)
                else:
                    state = self.engine.cancel_group(state, t.handle)
                self._count("deadline_cancels")
        return state

    def _expire_finished(self, state):
        """Deactivate slots that have emitted their ticket's
        ``max_new_tokens`` (the continuous-batching analogue of
        ``n_steps``): their lanes park masked until the whole request
        retires."""
        steps = state.steps.cpu().numpy()
        active = state.active.cpu().numpy()
        done = []
        for t in self._running():
            done.extend(s for s in t.slots
                        if active[s] and steps[s] >= t.max_new_tokens - 1)
        return self.engine.deactivate_slots(state, done)

    def _decode(self, params, state, n_steps: int):
        """One decode chunk for the whole slot table, shortened so no live
        slot can overrun its decode arm (``DecodeCapacityExceeded`` is a
        caller bug, not a runtime event, so the frontend never trips it).
        The chunk is one ``step_chunk`` call of that many steps."""
        active = state.active.cpu().numpy()
        # packed mode: pending prefills advance ONLY inside decode steps
        # (their chunks piggyback), so an otherwise-idle slot table must
        # still step while any admission's prefill is in flight.
        pending = bool(getattr(self.engine, "_pending", None))
        if (not active.any() and not pending) or n_steps <= 0:
            return state
        if active.any():
            deepest = int(state.cache.dec_lens.cpu().numpy()[active].max())
            chunk = min(n_steps, state.cache.decode_capacity - deepest)
        else:
            chunk = n_steps
        # also stop at the tightest live token budget, so every ticket
        # emits EXACTLY max_new_tokens (the expiry pass then parks its
        # slots) — budgets stay exact regardless of chunk boundaries,
        # which is what makes fault-free and faulty runs comparable
        # token-for-token.
        steps = state.steps.cpu().numpy()
        for t in self._running():
            for s in t.slots:
                if active[s]:
                    chunk = min(chunk,
                                t.max_new_tokens - 1 - int(steps[s]))
        if chunk <= 0:
            return state
        if hasattr(self.engine, "step_io_bytes"):
            # modelled-IO ledger: the live set read during this chunk's
            # steps (host mirrors only — no extra device sync)
            io = self.engine.step_io_bytes(state, active=active)
            self.io_ledger["ctx_bytes"] += io["ctx_bytes"] * chunk
            self.io_ledger["total_bytes"] += io["total"] * chunk
            self.io_ledger["steps"] += chunk
        state = self.engine.step_chunk(params, state, chunk)
        # progress accounting for the watchdog
        for t in self._running():
            emitted = sum(len(self.engine.outputs[s]) for s in t.slots)
            if emitted > t.tokens_emitted:
                t.tokens_emitted = emitted
                t.last_progress_round = self.round
        # decode-chunk boundary record: per-slot emitted token counts —
        # the journal's progress ledger, re-verified on replay
        self._emit(ev="decode", round=self.round, chunk=int(chunk),
                   lens=[len(self.engine.outputs[s])
                         for s in range(self.engine.ecfg.slots)])
        return state

    def _quarantine_corrupt(self, state):
        """KV-corruption quarantine: the engine's NaN/Inf sentinel flags
        slots whose decode output went non-finite (poisoned pool bytes).
        The owning tickets are cancelled through the ordinary retirement
        path and rejected with the typed, non-retryable
        ``kv_corruption`` reason — their (garbage) output is never
        surfaced, their pages free normally, and their healthy
        neighbours are untouched (blast-radius contract)."""
        bad = set(self.engine.corrupt_slots)
        if not bad:
            return state
        for t in self._running():
            if not bad.intersection(t.slots):
                continue
            t._corrupt = True
            t.fault_touched = True
            if self._is_tree:
                state = self.engine.cancel_request(state, t.handle)
            else:
                state = self.engine.cancel_group(state, t.handle)
            self._count("kv_quarantines")
            self._emit(ev="kv_quarantine", tid=t.tid, round=self.round,
                       slots=sorted(int(s) for s in
                                    bad.intersection(t.slots)))
        self.engine.corrupt_slots.clear()
        return state

    def _watchdog(self, params, state):
        """Stuck-decode watchdog: a RUNNING ticket with no token progress
        for ``stall_rounds`` rounds means the pipeline is wedged — most
        commonly retirement is being held (fault, bug) while its slots
        are already inactive. The watchdog force-lifts any retirement
        hold and re-runs collection; a ticket that is STILL wedged with
        active slots gets preempted back to the queue."""
        del params
        stalled = [t for t in self._running()
                   if self.round - t.last_progress_round > self.stall_rounds]
        if not stalled:
            return state
        self._count("watchdog_fires")
        if self._retire_suppressed_until >= self.round:
            self._retire_suppressed_until = -1   # break the hold
        state = self._collect(state)
        active = state.active.cpu().numpy()
        for t in stalled:
            if t.status == RUNNING and any(active[s] for s in t.slots):
                state = self._preempt(state, t)
        return self._collect(state)

    # ------------------------------------------------------------------
    # fault injection (runtime/faults.py)
    # ------------------------------------------------------------------
    def _inject_faults(self, state):
        if self.fault_plan is None:
            return state
        for ev in self.fault_plan.at(self.round):
            self._count(f"fault_{ev.kind}")
            if ev.kind == FaultKind.POOL_EXHAUST:
                state = self._fault_pool_exhaust(state, ev)
            elif ev.kind == FaultKind.CANCEL_MID_DECODE:
                state = self._fault_cancel(state, ev)
            elif ev.kind == FaultKind.DELAYED_RETIREMENT:
                self._retire_suppressed_until = max(
                    self._retire_suppressed_until, self.round + ev.hold)
            elif ev.kind == FaultKind.DOUBLE_RELEASE:
                self._fault_double_release()
            elif ev.kind == FaultKind.KILL_PROCESS:
                # simulated process death BETWEEN rounds: everything in
                # memory is gone. A DurableFrontend driver catches this,
                # recovers from snapshot+journal, and resumes; a plain
                # frontend driver dies with it — as a real process would.
                raise ProcessKilled(
                    f"kill_process fault at round {self.round}")
            elif ev.kind in (FaultKind.SNAPSHOT_CORRUPT,
                             FaultKind.JOURNAL_TRUNCATE):
                # disk-level faults: only meaningful when a durability
                # layer (runtime/recovery) owns snapshots/journals; a
                # memory-only frontend has nothing to corrupt.
                if self.durability_hook is not None:
                    self.durability_hook(ev)
                else:
                    self._count("durability_fault_ignored")
            else:
                raise ValueError(f"unknown fault kind: {ev.kind!r}")
        return state

    def _fault_pool_exhaust(self, state, ev):
        if not getattr(self.engine, "paged", False):
            return state
        n = min(ev.arg, self.engine.page_alloc.free_count())
        if n > 0:
            ids = self.engine.page_alloc.alloc(n)
            self._stolen.append((self.round + ev.hold, ids))
            self._count("pages_stolen", n)
        return state

    def _return_stolen_pages(self, state):
        keep = []
        for due, ids in self._stolen:
            if due <= self.round:
                self.engine.page_alloc.release(ids)
                self._count("pages_returned", len(ids))
            else:
                keep.append((due, ids))
        self._stolen = keep
        return state

    def _fault_cancel(self, state, ev):
        victim = self.fault_plan.choose(self._running())
        if victim is not None:
            state = self._preempt(state, victim, fault=True)
        return state

    def _fault_double_release(self):
        """Attempt a double release against the hardened allocator; the
        allocator MUST refuse atomically. An accepted double release is a
        real accounting hole — surface it as AllocatorCorruption."""
        if not getattr(self.engine, "paged", False):
            return
        free = self.engine.page_alloc.free_pages()
        if not free:
            return
        before = self.engine.page_alloc.free_count()
        caught = False
        try:
            self.engine.page_alloc.release([free[0]])
        except AllocatorCorruption:
            caught = True
        if not caught or self.engine.page_alloc.free_count() != before:
            raise AllocatorCorruption(
                f"double release of page {free[0]} was ACCEPTED — "
                f"allocator accounting hole")
        self._count("double_release_refused")


def _ticket_to_dict(t: Ticket) -> dict:
    """JSON-able snapshot of one ticket. Token arrays flatten to nested
    int/float lists; segments keep their trie-path nesting."""
    segments = t.segments
    t = dataclasses.replace(t, segments=[])
    d = dataclasses.asdict(t)
    d["segments"] = [[int(x) for x in s[0].tolist()] for s in segments]
    d["tokens"] = (None if t.tokens is None
                   else [[int(x) for x in arr] for arr in t.tokens])
    d["logprobs"] = (None if t.logprobs is None
                     else [[float(x) for x in arr] for arr in t.logprobs])
    d["slots"] = [int(s) for s in t.slots]
    return d


def _ticket_from_dict(d: dict, device) -> Ticket:
    d = dict(d)
    d["segments"] = [torch.tensor([seg], dtype=torch.int32, device=device)
                     for seg in d["segments"]]
    if d["tokens"] is not None:
        d["tokens"] = [np.asarray(arr, np.int32) for arr in d["tokens"]]
    if d["logprobs"] is not None:
        d["logprobs"] = [np.asarray(arr, np.float32)
                         for arr in d["logprobs"]]
    return Ticket(**d)


def _pct(sorted_vals: List[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


__all__ = [
    "ServeFrontend", "Ticket",
    "QUEUED", "RUNNING", "COMPLETED", "REJECTED", "TERMINAL",
    "REASON_QUEUE_FULL", "REASON_INFEASIBLE", "REASON_DEADLINE",
    "REASON_MAX_ATTEMPTS", "REASON_KV_CORRUPTION",
]
