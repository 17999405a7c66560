"""Heartbeat and restart-on-failure supervision for the serve loop.

The port's copy of the serving half of the reference's
``repro/runtime/fault_tolerance.py``: ``runtime/frontend.ServeFrontend``
beats a ``Heartbeat`` once per scheduler round (``heartbeat_path=``), a
watcher that polls ``Heartbeat.stale`` (``runtime/recovery.DurableFrontend``)
raises ``StaleHeartbeat``, and ``supervise`` restarts the wrapped loop after
any failure, so a hang is handled exactly like a crash: restart from the
latest snapshot.
"""
from __future__ import annotations

import os
import time
from typing import Optional


class StaleHeartbeat(RuntimeError):
    """The supervised process's heartbeat went stale (hang / wedge /
    silent death). Raised by watchers that poll ``Heartbeat.stale`` —
    e.g. ``runtime/recovery.DurableFrontend`` — so ``supervise`` treats
    a hang exactly like a crash: restart from the latest checkpoint."""


class Heartbeat:
    """File-mtime heartbeat; supervisor checks staleness."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int):
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}\n")

    def last(self) -> Optional[tuple]:
        try:
            with open(self.path) as f:
                step, ts = f.read().split()
            return int(step), float(ts)
        except (FileNotFoundError, ValueError):
            return None

    def stale(self, timeout_s: float) -> bool:
        """True when the last beat is older than ``timeout_s``. A missing
        or malformed file is NOT stale (the process may simply not have
        started beating yet); a beat whose timestamp lies in the FUTURE
        (clock skew, clock step) is also not stale — staleness only
        triggers on genuinely old beats, never on skew artifacts."""
        last = self.last()
        if last is None:
            return False
        return (time.time() - last[1]) > timeout_s


def supervise(run_once, *, max_restarts: int = 3, heartbeat: Heartbeat = None,
              stale_after_s: float = 600.0, backoff_s: float = 0.0,
              backoff_cap_s: float = 30.0, sleep=time.sleep,
              on_failure=None):
    """Restart-on-failure wrapper: ``run_once()`` is re-invoked after any
    exception (it is expected to resume from the latest checkpoint).

      * ``max_restarts`` caps consecutive failures; past the cap the last
        exception propagates (escalation — the caller decides whether to
        cold-start or page a human).
      * ``backoff_s`` > 0 sleeps ``backoff_s * 2**(attempt-1)`` (capped at
        ``backoff_cap_s``) before each retry, so a crash-looping process
        doesn't thrash the checkpoint store. ``sleep`` is injectable for
        tests.
      * ``on_failure(attempt, exc)`` runs before each retry — the hook
        where ``DurableFrontend`` performs recovery (load snapshot,
        replay journal) so the NEXT ``run_once`` resumes warm. An
        exception from the hook counts as the restart failing and
        propagates immediately.
      * ``heartbeat``/``stale_after_s`` document the staleness contract;
        the POLLING lives with the caller (e.g. ``DurableFrontend.pump``
        raises ``StaleHeartbeat``), which then lands here like any other
        failure.
    """
    attempts = 0
    while True:
        try:
            return run_once()
        except Exception as e:  # noqa: BLE001 — supervisor catches everything
            attempts += 1
            if attempts > max_restarts:
                raise
            print(f"[supervise] attempt {attempts} failed: {e!r}; restarting")
            if on_failure is not None:
                on_failure(attempts, e)
            if backoff_s > 0:
                sleep(min(backoff_cap_s, backoff_s * (2 ** (attempts - 1))))
