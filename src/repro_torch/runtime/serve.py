"""Single-context batch-sampling serve engine (the paper's target workload).

Pipeline (paper Figure 1, bottom):
  1. ``prefill`` the ONE shared context (batch=1) -> unbatched context KV;
  2. fork ``b`` samples: BifurcatedCache broadcasts nothing — the context
     half stays head-major (L, g, m_c, hd), only the small decode half is
     per-sample;
  3. decode ``n_steps`` tokens per sample in a host step loop; with
     ``use_kernel`` every layer-step is one launch of the fused CUDA
     decode kernel (kernels/bifurcated_decode.py);
  4. the BifurcationPolicy switch falls back to the standard batched cache
     for tiny workloads (paper FAQ #4), so enabling the feature is never a
     loss.

Also provides greedy/temperature sampling with top-p, and per-sample
mean-logprob tracking used for pass@top-k style reranking (paper §5.4).

``ForestServeEngine`` (below) is the continuous-batching generalization:
many concurrent shared-prefix requests (a prefix FOREST) served from one
slot table over grouped caches, with admit/retire as in-place value
updates of tensors allocated once, and a step loop that keeps its state
on the device and reads it back once per chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ForestConfig, ModelConfig, ServeConfig
from repro_torch.core.errors import (
    DecodeCapacityExceeded,
    SegmentCapacityExceeded,
    SegmentsExhausted,
    SlotsExhausted,
)
from repro_torch.core.kv_cache import DecodeCache
from repro_torch.core.policy import BifurcationPolicy
from repro_torch.core.quantized import ctx_cache_family


def sample_tokens(logits, temperature: float, top_p: float, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (b, V) -> token ids (b,). Nucleus + temperature sampling.

    Sampling is ``argmax(logits + gumbel)``, which is what
    ``jax.random.categorical`` computes; ``noise`` (b, V) supplies the
    Gumbel draws (so a caller can feed both frameworks the same numbers),
    else they are drawn from ``generator``."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=(-1,))
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)  # first index past p
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -1e30, logits)
    if noise is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
    return torch.argmax(logits + noise.to(logits.device, torch.float32), dim=-1)


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor        # (b, n_steps)
    mean_logprob: torch.Tensor  # (b,) ranking score (paper §5.4 pass@top-k)
    logprobs: torch.Tensor      # (b, n_steps)


def _token_logprob(logits, tok):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tok[:, None])[:, 0]


class ServeEngine:
    def __init__(self, model, cfg: ModelConfig, scfg: ServeConfig,
                 policy: Optional[BifurcationPolicy] = None):
        if scfg.ctx_store != "dense":
            raise NotImplementedError(
                f"ctx_store={scfg.ctx_store!r} is not ported")
        self.model = model
        self.cfg = cfg
        self.scfg = scfg
        self.policy = policy or BifurcationPolicy(enabled=scfg.bifurcated)
        # decode-phase dispatch counter, counted as the reference counts
        # it: one per generate for loop="scan", one per step for "python"
        self.decode_dispatches = 0

    # ---- policy ----
    def should_bifurcate(self, batch: int, m_c: int) -> bool:
        return self.policy.should_bifurcate(
            batch=batch, m_c=m_c,
            n_groups=self.cfg.n_kv_heads_padded, head_dim=self.cfg.kq_dim,
        )

    # ---- engine steps ----
    def prefill_shared(self, params, context_tokens, batch: int):
        """context_tokens: (1, m_c). Returns (first logits (batch, V), cache)."""
        cfg, model = self.cfg, self.model
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported")
        m_c = context_tokens.shape[1]
        logits, cache1 = model.prefill(params, context_tokens)
        if self.should_bifurcate(batch, m_c):
            # cache_dtype="int8" selects the quantized family: the context
            # arm is quantized ONCE here, the decode arm keeps the
            # activation dtype. (The policy's fallback below ignores
            # cache_dtype, as in the reference.)
            fam = ctx_cache_family(
                "int8" if self.scfg.cache_dtype == "int8" else "none")
            cache = fam.from_prefill(
                cache1.k[:, 0], cache1.v[:, 0], batch,
                self.scfg.decode_capacity, dtype=cache1.k.dtype,
                ctx_layout=cfg.ctx_layout)
        else:
            L, _, m, g, hd = cache1.k.shape
            shape = (L, batch, m + self.scfg.decode_capacity, g, hd)
            k = cache1.k.new_zeros(shape)
            v = cache1.v.new_zeros(shape)
            k[:, :, :m] = cache1.k
            v[:, :, :m] = cache1.v
            cache = DecodeCache(k=k, v=v, length=cache1.length)
        return logits.expand(batch, logits.shape[-1]), cache

    def _decode_body(self, params, cache, tokens, *, generator, noise):
        logits, cache = self.model.decode_step(
            params, cache, tokens,
            impl="kernel" if self.scfg.use_kernel else "einsum")
        logits = logits[:, -1]
        next_tok = sample_tokens(logits, self.scfg.temperature,
                                 self.scfg.top_p, generator=generator,
                                 noise=noise)
        return cache, next_tok, _token_logprob(logits, next_tok)

    def generate(self, params, context_tokens, *, n_steps: int,
                 batch: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 loop: str = "scan") -> GenerationResult:
        """Prefill once, then decode ``n_steps`` tokens per sample.

        ``generator`` draws the sampling noise (default: seeded from
        ``ServeConfig.seed``); ``noise`` (n_steps, batch, V) gives the
        Gumbel draws of every step instead. ``loop`` is "scan" or
        "python": the same host loop, kept for the reference's API and
        its dispatch count.
        """
        scfg = self.scfg
        batch = batch or scfg.batch
        if loop not in ("scan", "python"):
            raise ValueError(f"unknown loop mode: {loop!r}")
        if n_steps - 1 > scfg.decode_capacity:
            # the decode arm has decode_capacity slots; generating past it
            # would write outside the arm — reject loudly instead.
            raise DecodeCapacityExceeded(
                f"n_steps={n_steps} needs {n_steps - 1} decode-cache slots "
                f"> decode_capacity={scfg.decode_capacity}; raise "
                f"ServeConfig.decode_capacity or generate fewer tokens")
        dev = context_tokens.device
        if generator is None and noise is None:
            generator = torch.Generator(device=dev).manual_seed(scfg.seed)
        logits0, cache = self.prefill_shared(params, context_tokens, batch)
        tok = sample_tokens(logits0, scfg.temperature, scfg.top_p,
                            generator=generator,
                            noise=None if noise is None else noise[0])
        toks, lps = [tok], [_token_logprob(logits0, tok)]
        for i in range(1, n_steps):
            cache, tok, lp = self._decode_body(
                params, cache, tok[:, None], generator=generator,
                noise=None if noise is None else noise[i])
            toks.append(tok)
            lps.append(lp)
            if loop == "python":
                self.decode_dispatches += 1
        if loop == "scan" and n_steps > 1:
            self.decode_dispatches += 1
        logprobs = torch.stack(lps, dim=1)
        return GenerationResult(tokens=torch.stack(toks, dim=1),
                                mean_logprob=torch.mean(logprobs, dim=1),
                                logprobs=logprobs)


def rank_by_mean_logprob(result: GenerationResult, top_k: int = 3):
    """Deduplicate + rank samples by mean log-probability (paper §5.4).

    Ties are broken by sample index (stable argsort), so equal-score
    samples rank in submission order; duplicate token rows keep only their
    best-ranked occurrence."""
    toks = result.tokens.cpu().numpy()
    scores = result.mean_logprob.float().cpu().numpy()
    seen, order = set(), []
    for i in np.argsort(-scores, kind="stable"):
        key = toks[i].tobytes()
        if key not in seen:
            seen.add(key)
            order.append(int(i))
    return order[:top_k]


# ---------------------------------------------------------------------------
# Continuous-batching forest engine (multi-prefix serving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ForestState:
    """Device-side slot-table state of the forest engine.

    Everything that changes at admit/retire time is a VALUE here (masks,
    counters, cache contents), written into tensors allocated once by
    ``init_state``: admission never changes a shape or reallocates.
    """

    cache: object              # GroupedBifurcatedCache | GroupedQuant...
    tokens: torch.Tensor       # (b, 1) int64 — last sampled token per slot
    active: torch.Tensor       # (b,) bool — slot is live (not retired/free)
    steps: torch.Tensor        # (b,) int32 — decode steps emitted per slot
    generator: torch.Generator  # sampling noise (temperature > 0)


class _SlotTableEngine:
    """Shared decode machinery for the slot-table serve engines.

    Subclasses own admission (how a request's context lands in the cache
    and slots get pointed at it) and retirement bookkeeping; everything
    here — the chunked step loop, in-state EOS retirement, the
    decode-capacity guard, host-side output collection with its non-finite
    sentinel — depends only on the ``ecfg`` fields shared by the slot-table
    configs (slots / temperature / top_p / use_kernel / eos_token /
    pad_token) and on the cache's ``dec_lens`` / ``decode_capacity``.
    """

    def __init__(self, model, cfg: ModelConfig, ecfg):
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.decode_dispatches = 0          # chunks run, as in the reference
        # host-side output mirrors (admission policy only — the decode
        # math depends exclusively on device-side state values)
        self.outputs = {s: [] for s in range(ecfg.slots)}   # slot -> tokens
        self.logps = {s: [] for s in range(ecfg.slots)}
        # slots whose decode output went non-finite (the sentinel in
        # _collect_emitted): their output stops being collected
        self.corrupt_slots = set()

    # ---- decode ----
    def _decode_one(self, params, state: ForestState):
        """One slot-table decode step: advance every slot one token, gate
        the emission and the slot-table updates on each slot's live bit.
        Runs on the device with no host sync; updates ``state`` in place
        and returns (tok, logp, emit), each (b,)."""
        ecfg = self.ecfg
        logits, _ = self.model.decode_step(
            params, state.cache, state.tokens,
            impl="kernel" if ecfg.use_kernel else "einsum")
        logits = logits[:, -1]
        sampled = sample_tokens(logits, ecfg.temperature, ecfg.top_p,
                                generator=state.generator)
        tok_logp = _token_logprob(logits, sampled)
        emit = state.active.clone()
        tok = torch.where(emit, sampled, torch.full_like(sampled,
                                                         ecfg.pad_token))
        if ecfg.eos_token >= 0:
            state.active &= sampled != ecfg.eos_token
        state.tokens.copy_(tok[:, None])
        state.steps += emit.to(torch.int32)
        return tok, tok_logp, emit

    def step_chunk(self, params, state: ForestState, n_steps: int):
        """Run ``n_steps`` decode steps for the whole slot table. The loop
        keeps every state tensor on the device; the host reads the state
        once before the chunk (the capacity guard) and once after it (the
        emitted tokens), never inside it. Appends each live slot's emitted
        tokens to the host-side output lists and returns the state.

        Raises if the chunk would push any LIVE slot past its decode
        capacity (the per-slot KV write would clamp at the last slot and
        corrupt that slot's decode arm); slots admitted mid-lifetime sit at
        different depths, so the guard tracks the deepest live one."""
        active = state.active.cpu()
        if bool(active.any()):
            deepest = int(state.cache.dec_lens.cpu()[active].max())
            cap = state.cache.decode_capacity
            if deepest + n_steps > cap:
                raise DecodeCapacityExceeded(
                    f"chunk of {n_steps} steps would overflow "
                    f"decode_capacity={cap} (deepest live slot at "
                    f"{deepest}); retire slots or shorten the chunk")
        outs = [self._decode_one(params, state) for _ in range(n_steps)]
        self.decode_dispatches += 1
        if outs:
            toks, lps, emits = (torch.stack(x) for x in zip(*outs))
            self._collect_emitted(toks, lps, emits)
        return state

    def _collect_emitted(self, toks, lps, emits):
        """Append one chunk's emitted tokens ((T, b) stacks, or (b,) for a
        single step) to the host-side output lists, running the non-finite
        sentinel per emission: a non-finite log-prob comes only from
        non-finite logits, i.e. a slot that decoded from bad KV bytes; its
        output stops being collected and the slot joins
        ``corrupt_slots``."""
        toks, lps, emits = (np.asarray(x.cpu()) for x in (toks, lps, emits))
        if toks.ndim == 1:
            toks, lps, emits = toks[None], lps[None], emits[None]
        for t in range(toks.shape[0]):
            for s in range(toks.shape[1]):
                if not emits[t, s] or s in self.corrupt_slots:
                    continue
                if not np.isfinite(lps[t, s]):
                    self.corrupt_slots.add(s)
                    continue
                self.outputs[s].append(int(toks[t, s]))
                self.logps[s].append(float(lps[t, s]))

    def _sample_first(self, generator, logits0, n_samples):
        """Sample each fanned-out slot's first token from the shared
        prefill logits; returns (tokens (n,), logps (n,), live (n,) bool)
        with EOS-at-step-0 already folded into ``live``."""
        ecfg = self.ecfg
        logits_b = logits0.expand(n_samples, logits0.shape[-1])
        tok = sample_tokens(logits_b, ecfg.temperature, ecfg.top_p,
                            generator=generator)
        lp = _token_logprob(logits_b, tok)
        live = (tok != ecfg.eos_token if ecfg.eos_token >= 0
                else torch.ones_like(tok, dtype=torch.bool))
        return tok, lp, live

    def result(self, slot: int) -> GenerationResult:
        """Per-slot GenerationResult view over the host-side output lists."""
        toks = torch.tensor(self.outputs[slot], dtype=torch.int64)[None, :]
        lps = torch.tensor(self.logps[slot], dtype=torch.float32)[None, :]
        return GenerationResult(tokens=toks, mean_logprob=torch.mean(lps, 1),
                                logprobs=lps)

    # ---- cancellation / observability ----
    def deactivate_slots(self, state: ForestState, slots) -> ForestState:
        """Flip the given slots' live bits off, in place — the in-state
        equivalent of those slots sampling EOS. Their lanes keep stepping
        masked, their outputs stay readable, and the normal retirement pass
        frees their group once every sibling slot is inactive."""
        slots = list(slots)
        if slots:
            ids = torch.as_tensor(slots, dtype=torch.long,
                                  device=state.active.device)
            state.active[ids] = False
        return state

    def occupancy(self, state: ForestState) -> dict:
        """Host-side utilization snapshot: live slot count."""
        return {"live_slots": int(state.active.sum()),
                "slots": int(self.ecfg.slots)}


class ForestServeEngine(_SlotTableEngine):
    """Continuous-batching serve loop over a prefix forest.

    A slot table of ``fcfg.slots`` decode lanes over ``fcfg.n_groups``
    shared-context segments:

      admit   — prefill a new request's context (batch=1), write it into a
                free segment (``write_context``: quantize/transpose once,
                in place), point free slots at it, sample each slot's first
                token from the prefill logits.
      decode  — ``step_chunk`` runs n_steps of the whole slot table with
                the state on the device. Per-slot step counts and EOS
                retirement live in the state: a slot that samples
                ``eos_token`` flips its own ``active`` bit and emits
                ``pad_token`` from then on (its lane keeps stepping, masked
                and isolated by the cross-slot decode mask, so shapes never
                change).
      retire  — host-side bookkeeping: segments whose slots have all gone
                inactive free up for the next admit; retired slots are
                reusable at once (``assign_slots`` wipes their stale
                decode arm).

    The integrity and durability surface of the reference engine
    (segment checksums, ``audit_state``, ``host_state``) is not ported.
    """

    def __init__(self, model, cfg: ModelConfig, fcfg: ForestConfig):
        if fcfg.ctx_store != "dense":
            raise NotImplementedError(
                f"ctx_store={fcfg.ctx_store!r} is not ported")
        super().__init__(model, cfg, fcfg)
        self.fcfg = fcfg
        # host-side slot table mirrors (admission policy only)
        self.group_live = [False] * fcfg.n_groups
        self.slot_group = [-1] * fcfg.slots

    # ---- lifecycle ----
    def init_state(self, device="cuda") -> ForestState:
        """The empty slot table and forest cache on ``device`` (CUDA unless
        the caller asks for the CPU). The bf16 family's segments and both
        families' decode arms are stored in bf16, as in the reference."""
        fcfg = self.fcfg
        dev = resolve_device(device)
        quant = "int8" if fcfg.cache_dtype == "int8" else "none"
        cache = self.model.make_forest_cache(
            fcfg.slots, fcfg.n_groups, fcfg.ctx_capacity,
            fcfg.decode_capacity, quant, dtype=torch.bfloat16, device=dev)
        b = fcfg.slots
        return ForestState(
            cache=cache,
            tokens=torch.zeros((b, 1), dtype=torch.int64, device=dev),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            steps=torch.zeros(b, dtype=torch.int32, device=dev),
            generator=torch.Generator(device=dev).manual_seed(fcfg.seed),
        )

    def free_groups(self):
        return [g for g, live in enumerate(self.group_live) if not live]

    def free_slots(self, state: ForestState, active=None):
        """Slots safe to (re)assign: never admitted, or belonging to a
        RETIRED group. An EOS'd slot of a still-live group is NOT free —
        its finished output must stay readable via ``result()`` until
        ``retire_groups`` frees the whole group. ``active`` — optional host
        copy of ``state.active``, so one serve round syncs once."""
        if active is None:
            active = state.active.cpu()
        return [s for s in range(self.fcfg.slots)
                if not bool(active[s]) and (
                    self.slot_group[s] < 0
                    or not self.group_live[self.slot_group[s]])]

    def admit(self, params, state: ForestState, context_tokens,
              n_samples: int) -> tuple:
        """Admit one request: prefill its context into a free segment, fan
        ``n_samples`` slots out over it, sample their first token from the
        prefill logits. Returns (state, slot_ids). A rejected admission
        raises its typed error before anything is mutated. EOS-at-step-0:
        a first token equal to ``eos_token`` retires the slot before it
        ever decodes (its emitted sequence is just the EOS)."""
        fcfg = self.fcfg
        m_new = int(context_tokens.shape[1])
        if m_new > fcfg.ctx_capacity:
            raise SegmentCapacityExceeded(
                f"context of {m_new} tokens exceeds the segment capacity "
                f"{fcfg.ctx_capacity}; rejected (raise "
                f"ForestConfig.ctx_capacity or split the request)")
        free_g = self.free_groups()
        free_s = self.free_slots(state)
        if not free_g:
            raise SegmentsExhausted("no free context segment — retire first")
        if len(free_s) < n_samples:
            raise SlotsExhausted(
                f"need {n_samples} free slots, have {len(free_s)}")
        gidx, slots = free_g[0], free_s[:n_samples]

        logits0, cache1 = self.model.prefill(params, context_tokens)
        cache = state.cache.write_context(cache1.k[:, 0], cache1.v[:, 0],
                                          gidx)
        dev = state.active.device
        slot_ids = torch.as_tensor(slots, dtype=torch.long, device=dev)
        slot_mask = torch.zeros(fcfg.slots, dtype=torch.bool, device=dev)
        slot_mask[slot_ids] = True
        cache.assign_slots(slot_mask, gidx)

        tok, lp, live = self._sample_first(state.generator, logits0,
                                           n_samples)
        state.tokens[slot_ids, 0] = tok
        state.active[slot_ids] = live
        state.steps[slot_ids] = 0
        self.group_live[gidx] = True
        tok_h, lp_h = tok.tolist(), lp.tolist()
        for i, s in enumerate(slots):
            self.slot_group[s] = gidx
            self.outputs[s] = [int(tok_h[i])]
            self.logps[s] = [float(lp_h[i])]
            self.corrupt_slots.discard(s)  # fresh request, fresh verdict
        return state, slots

    # ---- retire ----
    def retire_groups(self, state: ForestState, active=None):
        """Free every segment whose slots have all gone inactive. Returns
        the retired group ids; their slots become reusable by the next
        ``admit`` (which wipes the stale decode arms). A dense cache keeps
        the retired segment's bytes until the next admission overwrites
        them; the kernels read only live lengths of assigned segments.
        ``active`` optionally supplies a host copy of ``state.active``."""
        if active is None:
            active = state.active.cpu()
        retired = []
        for g in range(self.fcfg.n_groups):
            if not self.group_live[g]:
                continue
            slots = [s for s in range(self.fcfg.slots)
                     if self.slot_group[s] == g]
            if not any(bool(active[s]) for s in slots):
                self.group_live[g] = False
                retired.append(g)
        return retired

    def release_retired(self, state: ForestState) -> ForestState:
        """Paged mode clears retired groups' page tables; the dense store
        has nothing to release: identity."""
        return state

    # ---- robustness surface ----
    def cancel_group(self, state: ForestState, group: int) -> ForestState:
        """Deactivate every slot of a LIVE group (preemption / deadline /
        client cancellation). The group frees through ``retire_groups``;
        until then the slots' partial outputs stay readable."""
        slots = [s for s in range(self.fcfg.slots)
                 if self.slot_group[s] == group]
        return self.deactivate_slots(state, slots)
