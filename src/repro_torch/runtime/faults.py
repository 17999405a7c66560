"""Deterministic fault injection for the serving stack.

The port's copy of the reference's ``repro/runtime/faults.py``. A
``FaultPlan`` is a reproducible schedule of fault events (derived from one
integer seed, or written out explicitly) that
``runtime/frontend.ServeFrontend`` consults at every scheduler round. The
seeded numpy stream is the reference's, so the same seed gives the same
plan and the same victims in both packages.

Fault kinds (``FaultKind``):

  * ``POOL_EXHAUST`` — steal ``arg`` pages from the engine's
    ``PageAllocator`` for ``hold`` rounds; admissions meanwhile hit the real
    ``PoolExhausted`` path and must queue, back off or preempt.
  * ``CANCEL_MID_DECODE`` — force-preempt one live request (chosen through
    the plan's RNG): its slots deactivate mid-decode, its resources free
    through normal retirement, and it re-queues.
  * ``DELAYED_RETIREMENT`` — suppress the frontend's retirement pass for
    ``hold`` rounds; the stuck-decode watchdog must force progress.
  * ``DOUBLE_RELEASE`` — attempt to release an already-free pool page; the
    ``PageAllocator`` must refuse atomically (``AllocatorCorruption``).
  * ``KILL_PROCESS`` — simulated whole-process death between pump rounds:
    the frontend raises ``ProcessKilled`` before doing any work for the
    round. Only what ``runtime/recovery.DurableFrontend`` put on disk
    (snapshots + journal) survives.
  * ``SNAPSHOT_CORRUPT`` — flip a bit inside the latest snapshot's array
    bytes on disk; recovery must detect it by the per-leaf CRCs, quarantine
    the snapshot and fall back to the previous one.
  * ``JOURNAL_TRUNCATE`` — chop the tail off the current journal file;
    replay must stop cleanly at the last complete record.

The last three are DURABILITY faults: a plain ``ServeFrontend`` has no disk
state, so it re-raises ``KILL_PROCESS`` and counts-and-ignores the other
two unless a ``durability_hook`` (installed by ``DurableFrontend``) claims
them.

The blast-radius contract: requests untouched by any fault produce
bit-identical greedy tokens to a fault-free run of the same workload.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


class ProcessKilled(RuntimeError):
    """Simulated whole-process death (``FaultKind.KILL_PROCESS``): the
    in-memory engine/frontend state is gone the instant this propagates;
    only durable snapshots + journal survive. Raised from inside
    ``ServeFrontend.pump`` so it unwinds through the driver exactly like
    a real SIGKILL would end the pump loop."""


class FaultKind:
    """Fault-kind slugs (plain strings so plans serialize trivially).

    ``ALL`` is DERIVED from the registered slugs (every uppercase class
    attribute), so a new kind enters random plans the moment it is
    defined."""

    POOL_EXHAUST = "pool_exhaust"
    CANCEL_MID_DECODE = "cancel_mid_decode"
    DELAYED_RETIREMENT = "delayed_retirement"
    DOUBLE_RELEASE = "double_release"
    KILL_PROCESS = "kill_process"
    SNAPSHOT_CORRUPT = "snapshot_corrupt"
    JOURNAL_TRUNCATE = "journal_truncate"

    @classmethod
    def registered(cls) -> tuple:
        """Every registered fault-kind slug, in definition order."""
        return tuple(v for k, v in vars(cls).items()
                     if k.isupper() and isinstance(v, str))


FaultKind.ALL = FaultKind.registered()


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires at scheduler ``round`` (1-based, the
    frontend's pump counter). ``arg`` scales the fault (pages to steal);
    ``hold`` is its duration in rounds (page theft, retirement delay)."""

    round: int
    kind: str
    arg: int = 1
    hold: int = 2


class FaultPlan:
    """A deterministic, replayable schedule of ``FaultEvent``s.

    Construct explicitly (``FaultPlan([FaultEvent(3, FaultKind...)])``) for
    targeted runs, or via ``FaultPlan.random(seed, rounds)``. Victim selection inside the frontend goes through
    ``choose`` so the whole faulty trajectory is a pure function of
    (workload, plan seed)."""

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.round)
        self.seed = seed
        self._rng = np.random.RandomState(seed + 0x5EED)

    def at(self, round_: int) -> List[FaultEvent]:
        """Events scheduled for this round."""
        return [e for e in self.events if e.round == round_]

    def choose(self, seq):
        """Deterministic victim choice (consumes the plan's RNG stream in
        injection order)."""
        if not seq:
            return None
        return seq[int(self._rng.randint(len(seq)))]

    # ---- durable-state serialization (checkpoint/recovery) ----
    def rng_state(self) -> list:
        """JSON-serializable snapshot of the victim-choice RNG stream.
        Snapshotting this alongside the engine state is what makes a
        recovered replay consume the SAME random victims as the original
        timeline (``choose`` is a pure function of this state)."""
        name, key, pos, has_gauss, cached = self._rng.get_state()
        return [name, [int(x) for x in key], int(pos),
                int(has_gauss), float(cached)]

    def set_rng_state(self, state) -> "FaultPlan":
        """Restore the stream saved by ``rng_state()``."""
        name, key, pos, has_gauss, cached = state
        self._rng.set_state((name, np.asarray(key, dtype=np.uint32),
                             int(pos), int(has_gauss), float(cached)))
        return self

    def disable(self, kind: str, upto_round: int) -> int:
        """Remove events of ``kind`` scheduled at rounds <= ``upto_round``
        (returns how many were dropped). A recovery manager calls this for
        SURVIVED ``kill_process`` events before replay — re-firing a kill
        the process already died from once would crash-loop forever."""
        before = len(self.events)
        self.events = [e for e in self.events
                       if not (e.kind == kind and e.round <= upto_round)]
        return before - len(self.events)

    @classmethod
    def random(cls, seed: int, rounds: int,
               kinds: Optional[Sequence[str]] = None,
               rate: float = 0.2, max_arg: int = 4,
               max_hold: int = 3) -> "FaultPlan":
        """Seeded random plan: each round fires a fault with probability
        ``rate``, kind uniform over ``kinds``, ``arg``/``hold`` uniform in
        [1, max_*]. Same seed -> same plan, always.

        ``kinds`` defaults to the FULL registered set at CALL time
        (``FaultKind.registered()``)."""
        if kinds is None:
            kinds = FaultKind.registered()
        rng = np.random.RandomState(seed)
        events = []
        for r in range(1, rounds + 1):
            if rng.rand() < rate:
                events.append(FaultEvent(
                    round=r,
                    kind=kinds[int(rng.randint(len(kinds)))],
                    arg=int(rng.randint(1, max_arg + 1)),
                    hold=int(rng.randint(1, max_hold + 1)),
                ))
        return cls(events, seed=seed)

    def counts(self) -> dict:
        """Events per kind (reporting)."""
        out: dict = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, events={len(self.events)}, "
                f"kinds={self.counts()})")


__all__ = ["FaultKind", "FaultEvent", "FaultPlan", "ProcessKilled"]
