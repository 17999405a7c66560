"""Pluggable admission policies for the serving frontend.

The port's copy of the reference's ``repro/runtime/scheduler.py``.
``ServeFrontend`` (runtime/frontend.py) drains its queue through a POLICY
object: each scheduler round, every eligible queued ticket (backoff
expired) is handed to ``AdmissionPolicy.admit_order``, which returns the
order admission is attempted in. The same object ranks preemption victims
(``victim_key``).

  * ``FifoPolicy`` (``policy="fifo"``, the default) — priority descending,
    then submission order.
  * ``SharingPolicy`` (``policy="sharing"``) — co-schedules requests that
    SHARE trie ancestors: context KV is read once per step however many
    sequences traverse it, so the context bytes/step of a batch depend on
    WHICH requests decode together. Each candidate is scored by the context
    bytes/step its matched prefix would avoid (``engine.peek_prefix``,
    priced by ``core.io_model.tree_admit_bytes_delta``) per claimed slot,
    and admitted greedily by marginal gain: each selection's would-be path
    joins the hypothetical read-set, so its siblings gain their shared
    levels on the next pick.

SLO guardrails (ordering lanes ahead of the greedy lane): a ticket within
``deadline_slack`` rounds of its deadline goes first (tightest first); a
ticket queued longer than ``age_bound`` rounds is promoted (oldest first),
so no request starves.

Determinism: a decision is a pure function of the frontend's ticket table
and the engine's host mirrors (both snapshotted and journal-replayed by
``runtime/recovery.DurableFrontend``), and the chosen order is journaled
per round (``admit_order`` event), so replay cross-checks it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core.io_model import tree_admit_bytes_delta


@dataclasses.dataclass(frozen=True)
class SharingPolicyConfig:
    """Knobs of ``SharingPolicy``.

    ``deadline_slack``: a queued ticket whose deadline is within this
    many rounds goes to the urgent lane (admitted first, tightest
    first). ``age_bound``: a ticket queued longer than this many rounds
    goes to the aged lane (ahead of the greedy lane, oldest first) —
    the no-starvation bound. ``bytes_per_el``: context-arm bytes per
    element for the byte model (2 = bf16)."""

    deadline_slack: int = 2
    age_bound: int = 12
    bytes_per_el: int = 2


class AdmissionPolicy:
    """Base class: order eligible queued tickets, rank preemption
    victims. Policies must be DETERMINISTIC functions of the ticket
    table + engine host mirrors (both are snapshot/replay state) —
    never wall clock, never unseeded randomness."""

    name = "base"

    def admit_order(self, fe, eligible: Sequence) -> List:
        """Return ``eligible`` tickets in the order admission should be
        attempted this round. Must be a permutation of ``eligible``."""
        raise NotImplementedError

    def victim_key(self, fe, ticket):
        """Sort key for preemption victims — ``min`` over candidates
        wins. Default (FIFO) ranking: lowest effective priority (base +
        preemptions suffered), then least-shared (node count), then
        youngest."""
        eff = ticket.priority + ticket.preemptions
        sharing = (fe.engine.request_sharing(ticket.handle)
                   if fe._is_tree else 0)
        return (eff, sharing, -ticket.submitted_round)


class FifoPolicy(AdmissionPolicy):
    """Priority descending, then submission order — the frontend's
    pre-policy admission ladder, bit-for-bit."""

    name = "fifo"

    def admit_order(self, fe, eligible: Sequence) -> List:
        return sorted(eligible, key=lambda t: (-t.priority, t.tid))


class SharingPolicy(AdmissionPolicy):
    """Greedy marginal-gain co-scheduling of trie sharers under SLOs.

    Order produced each round:

        [urgent lane] tickets within ``deadline_slack`` of deadline,
                      tightest slack first;
        [aged lane]   tickets queued > ``age_bound`` rounds, oldest
                      first (no starvation);
        [greedy lane] repeatedly pick the candidate with the highest
                      (saved context bytes per step per claimed slot,
                      matched resident tokens, priority, -tid), then
                      fold its whole would-be path into the
                      hypothetical read-set so its siblings score
                      their shared levels on the next pick.

    On an engine without a trie probe (``peek_prefix``), every score is
    zero and the greedy lane degrades to (priority, submission order) —
    the policy stays safe on forest engines, it just has nothing to
    share."""

    name = "sharing"

    def __init__(self, config: Optional[SharingPolicyConfig] = None):
        self.config = config or SharingPolicyConfig()

    # -- path signatures -------------------------------------------------
    # A trie node's identity is (ancestor chain, token content). The
    # hypothetical read-set keys nodes by their full token-tuple chain
    # ("signature") so would-be-new nodes of queued candidates unify
    # with live nodes AND with each other across the greedy pass.
    @staticmethod
    def _ticket_levels(ticket):
        return [tuple(int(x) for x in torch.as_tensor(s)[0].tolist())
                for s in ticket.segments]

    @staticmethod
    def _level_sigs(levels):
        sigs, acc = [], ()
        for toks in levels:
            acc = acc + (toks,)
            sigs.append(acc)
        return sigs

    @staticmethod
    def _node_sig(engine, nid, memo):
        if nid in memo:
            return memo[nid]
        parent, toks = engine.node_key[nid]
        sig = ((() if parent < 0
                else SharingPolicy._node_sig(engine, parent, memo))
               + (toks,))
        memo[nid] = sig
        return sig

    @classmethod
    def _referenced_sigs(cls, engine):
        """Signatures of trie nodes ALREADY read each decode step —
        referenced by at least one live request. Cached (refcount-zero)
        nodes are resident but not streamed, so they do not count as
        read; they do count as matched tokens (prefill reuse) via
        ``peek_prefix``."""
        if not hasattr(engine, "node_refs"):
            return set()
        memo = {}
        return {cls._node_sig(engine, nid, memo)
                for nid, refs in enumerate(engine.node_refs)
                if refs > 0 and engine.node_live[nid]}

    # -- scoring ---------------------------------------------------------
    def _score(self, fe, ticket, read_sigs):
        """(saved context bytes/step per claimed slot, matched resident
        tokens) for one candidate against the hypothetical read-set."""
        engine = fe.engine
        if not hasattr(engine, "peek_prefix"):
            return 0.0, 0
        levels = self._ticket_levels(ticket)
        shared = [sig in read_sigs for sig in self._level_sigs(levels)]
        delta = tree_admit_bytes_delta(
            seg_lens=[len(lv) for lv in levels], shared=shared,
            n_slots=ticket.n_samples,
            c_d=engine.ecfg.decode_capacity,
            g=engine.cfg.n_kv_heads, hd=engine.cfg.kq_dim,
            bytes_per_el=self.config.bytes_per_el)
        _, _, matched_tokens = engine.peek_prefix(ticket.segments)
        return delta["saved_per_slot"], matched_tokens

    def admit_order(self, fe, eligible: Sequence) -> List:
        cfg = self.config
        urgent, aged, rest = [], [], []
        for t in eligible:
            slack = (None if t.deadline_round is None
                     else t.deadline_round - fe.round)
            if slack is not None and slack <= cfg.deadline_slack:
                urgent.append(t)
            elif fe.round - t.submitted_round > cfg.age_bound:
                aged.append(t)
            else:
                rest.append(t)
        order = sorted(urgent, key=lambda t: (t.deadline_round, t.tid))
        order += sorted(aged, key=lambda t: (t.submitted_round, t.tid))

        read = self._referenced_sigs(fe.engine)
        for t in order:      # urgent/aged picks share like any other admit
            read |= set(self._level_sigs(self._ticket_levels(t)))
        rest = list(rest)
        while rest:
            best = max(
                range(len(rest)),
                key=lambda i: (self._score(fe, rest[i], read)
                               + (rest[i].priority, -rest[i].tid)))
            t = rest.pop(best)
            order.append(t)
            read |= set(self._level_sigs(self._ticket_levels(t)))
        return order

    def victim_key(self, fe, ticket):
        """Preemption COST MODEL: evict the victim with the lowest

            shared_bytes - re-prefill price of its PRIVATE levels

        (min over candidates wins), after effective priority. The two
        terms price the two sides of a preemption:

          * ``shared_bytes`` — context bytes/step this victim's nodes
            contribute to OTHER live requests' reading (refcount > 1).
            Evicting a sharer forfeits amortization everyone else was
            enjoying, so high sharing protects.
          * ``ctx_delta`` of the unshared levels
            (``io_model.tree_admit_bytes_delta``) — the bytes a
            re-admission must re-prefill. Shared ancestors stay
            resident (other refs pin them), so this prices exactly the
            victim's PRIVATE footprint: a mostly-private victim has a
            large ctx_delta and small shared_bytes, scores most
            negative, and is evicted first — it frees the most pages
            nobody else uses, and its re-prefill bill is paid by it
            alone rather than by the sharers it would have displaced.

        Ties break youngest-first, matching the base policy."""
        eff = ticket.priority + ticket.preemptions
        engine = fe.engine
        score = 0
        if fe._is_tree and hasattr(engine, "requests"):
            req = engine.requests.get(ticket.handle)
            if req is not None and req["path"]:
                shared = [engine.node_refs[nid] > 1 for nid in req["path"]]
                delta = tree_admit_bytes_delta(
                    seg_lens=[engine.node_len[nid] for nid in req["path"]],
                    shared=shared,
                    n_slots=max(len(req["slots"]), 1),
                    c_d=engine.ecfg.decode_capacity,
                    g=engine.cfg.n_kv_heads, hd=engine.cfg.kq_dim,
                    bytes_per_el=self.config.bytes_per_el)
                score = delta["shared_bytes"] - delta["ctx_delta"]
        return (eff, score, -ticket.submitted_round)


def make_policy(policy) -> AdmissionPolicy:
    """Resolve the frontend's ``policy=`` argument: an
    ``AdmissionPolicy`` instance passes through; ``"fifo"`` /
    ``"sharing"`` / ``None`` (= fifo) build the named policy."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    if policy in (None, "fifo"):
        return FifoPolicy()
    if policy == "sharing":
        return SharingPolicy()
    raise ValueError(
        f"unknown admission policy {policy!r} — expected 'fifo', "
        f"'sharing', or an AdmissionPolicy instance")


__all__ = [
    "AdmissionPolicy", "FifoPolicy", "SharingPolicy",
    "SharingPolicyConfig", "make_policy",
]
