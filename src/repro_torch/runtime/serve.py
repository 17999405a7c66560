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

The mixture-of-experts and VLM families serve as the dense one does (a
VLM's ``patch_embeds`` go to its prefill through ``generate``'s
``prefill_kwargs``; the policy decides on the text's length). The
encoder-decoder's cache is a dict of its decoder's self-attention cache
(bifurcated, int8 context or not, or the standard fallback) and the
cross-attention K/V (unbatched when bifurcated); its ``frames`` and
``sample_batch`` go to its prefill the same way.

The zamba2 hybrid serves through the same engine: its cache is a dict of
the shared attention block's cache (bifurcated, or the standard fallback),
the Mamba2 states and the position; ``_broadcast_state`` fans the prefill's
batch-1 states out to the samples. xLSTM's cache is its recurrent states
alone (the mLSTM's matrix memories, the sLSTM's h and c), fanned out the
same way; the policy and the cache dtype have nothing to act on there.

Also provides greedy/temperature sampling with top-p, and per-sample
mean-logprob tracking used for pass@top-k style reranking (paper §5.4).

``ForestServeEngine`` (below) is the continuous-batching generalization:
many concurrent shared-prefix requests (a prefix FOREST) served from one
slot table over grouped caches, with admit/retire as in-place value
updates of tensors allocated once, and a step loop that keeps its state
on the device and reads it back once per chunk. ``TreeServeEngine``
generalizes it to a prefix TRIE: requests are paths of shared segments,
and a shared ancestor is stored once and read once per step however many
requests hang below it.

With ``ctx_store="paged"`` every engine stores its contexts in a shared
page pool (core/paged.py): a context occupies ``ceil(len / page_size)``
pages of its live length, the pool may be smaller than the envelope of
all segments (``num_pages``, oversubscription), a ``PageAllocator`` on the
host hands pages out and takes them back at retirement, and every decode
layer-step runs the paged CUDA kernel, which reads only live pages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (
    ForestConfig,
    ModelConfig,
    ServeConfig,
    TreeConfig,
)
from repro_torch.core.errors import (
    DecodeCapacityExceeded,
    PoolExhausted,
    PrefillInFlight,
    SegmentCapacityExceeded,
    SegmentsExhausted,
    SlotsExhausted,
)
from repro_torch.core.integrity import segment_checksum, verify_segment
from repro_torch.core.io_model import tree_decode_io_bytes
from repro_torch.core.kv_cache import DecodeCache
from repro_torch.core.paged import (
    PageAllocator,
    PagedBifurcatedCache,
    PagedGroupedBifurcatedCache,
    pages_needed,
)
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
        # where the fp32 cumsum ends below top_p the index is V: the
        # reference gathers NaN there and masks nothing; the index is
        # clamped so that no out-of-range gather reaches the device
        v = sorted_logits.shape[-1]
        cutoff = torch.gather(sorted_logits, -1,
                              torch.clamp(cutoff_idx, max=v - 1)[:, None])
        cutoff = torch.where(cutoff_idx[:, None] >= v, -torch.inf, cutoff)
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
        _check_ctx_store(scfg.ctx_store)
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
    def prefill_shared(self, params, context_tokens, batch: int, **kwargs):
        """context_tokens: (1, m_c). Returns (first logits (batch, V),
        cache). ``kwargs`` go to the model's prefill: ``patch_embeds``
        (vlm), ``frames`` and ``sample_batch`` (encdec). The policy decides
        on the text's length m_c alone (a VLM's image tokens join the
        cache's context all the same, as in the reference)."""
        cfg, model = self.cfg, self.model
        if cfg.family == "xlstm":
            # a state cache: the prefill's final states broadcast to the
            # samples; no KV cache, so neither the policy nor the cache
            # dtype applies (as in the reference)
            logits, cache1 = model.prefill(params, context_tokens, **kwargs)
            return (logits.expand(batch, logits.shape[-1]),
                    self._broadcast_state(cache1, batch))
        m_c = context_tokens.shape[1]
        quant = "int8" if self.scfg.cache_dtype == "int8" else "none"
        bifurcated = self.should_bifurcate(batch, m_c)
        if cfg.family == "hybrid":
            # the policy's decision and the cache dtype pick the shared
            # block's cache family (its one quantizable arm); the decode arm
            # is sized from the serve config. ctx_store is not read, as in
            # the reference: the hybrid's context stays a dense slab.
            logits, cache1 = model.prefill(
                params, context_tokens, bifurcated=bifurcated,
                dec_capacity=self.scfg.decode_capacity,
                ctx_quant=quant if bifurcated else "none", **kwargs)
            return (logits.expand(batch, logits.shape[-1]),
                    self._broadcast_state(cache1, batch))
        if cfg.family == "encdec":
            # the decode arm sized from the serve config, int8 for the
            # self-attention's context arm; ctx_store is not read (the
            # reference's encdec branch builds the dense slab). The
            # standard cache is copied per sample (decode writes it in
            # place); its cross K/V are read only, so they are expanded.
            kwargs.setdefault("dec_capacity", self.scfg.decode_capacity)
            if bifurcated:
                kwargs.setdefault("ctx_quant", quant)
            logits, cache = model.prefill(params, context_tokens,
                                          bifurcated=bifurcated, **kwargs)
            if not bifurcated:
                sc = cache["self"]
                cache = {"self": DecodeCache(k=_fan(sc.k, batch),
                                             v=_fan(sc.v, batch),
                                             length=sc.length),
                         **{name: _fan(cache[name], batch, copy=False)
                            for name in ("cross_k", "cross_v")}}
            return logits.expand(batch, logits.shape[-1]), cache
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"unknown model family: {cfg.family}")
        logits, cache1 = model.prefill(params, context_tokens, **kwargs)
        if bifurcated and self.scfg.ctx_store == "paged":
            # the context lands in a page pool of exactly
            # ceil(m_c / page_size) pages; decode reads it through the page
            # table (the int8 store carries the int8 and scale pages)
            cache = PagedBifurcatedCache.from_prefill(
                cache1.k[:, 0], cache1.v[:, 0], batch,
                self.scfg.decode_capacity, dtype=cache1.k.dtype,
                page_m=self.scfg.page_size, ctx_quant=quant)
        elif bifurcated:
            # cache_dtype="int8" selects the quantized family: the context
            # arm is quantized ONCE here, the decode arm keeps the
            # activation dtype. (The policy's fallback below ignores
            # cache_dtype and ctx_store, as in the reference.)
            cache = ctx_cache_family(quant).from_prefill(
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

    def _broadcast_state(self, cache, batch):
        """A state-cache prefill's cache (batch 1) for ``batch`` samples:
        xLSTM's states; the hybrid's Mamba2 states and its shared block's
        per-sample arm (bifurcated: the decode arm; standard: the whole
        cache). Each is copied per sample, since decode updates them in
        place (an expanded view would let every sample write one state); a
        bifurcated context (and its scales) stays unbatched."""
        def fan(x, axis=1):
            return _fan(x, batch, axis)

        if self.cfg.family == "xlstm":
            return {"mlstm": fan(cache["mlstm"], axis=2),
                    "slstm_h": fan(cache["slstm_h"]),
                    "slstm_c": fan(cache["slstm_c"]),
                    "position": cache["position"]}
        attn = cache["attn"]
        if isinstance(attn, DecodeCache):
            attn = DecodeCache(k=fan(attn.k), v=fan(attn.v), length=attn.length)
        else:
            attn = dataclasses.replace(attn, k_dec=fan(attn.k_dec),
                                       v_dec=fan(attn.v_dec))
        return {"attn": attn,
                "mamba": {k: fan(x) for k, x in cache["mamba"].items()},
                "position": cache["position"]}

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
                 loop: str = "scan", **prefill_kwargs) -> GenerationResult:
        """Prefill once, then decode ``n_steps`` tokens per sample.
        ``prefill_kwargs`` go to ``prefill_shared`` (a VLM's
        ``patch_embeds``; an encoder-decoder's ``frames`` and
        ``sample_batch``).

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
        logits0, cache = self.prefill_shared(params, context_tokens, batch,
                                             **prefill_kwargs)
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


def _fan(x, batch, axis=1, copy=True):
    """A batch-1 leaf for ``batch`` samples along ``axis``: copied per
    sample (``copy``; decode updates it in place, and an expanded view
    would let every sample write one state) or an expanded view (read
    only)."""
    x = x.expand(*x.shape[:axis], batch, *x.shape[axis + 1:])
    return x.contiguous() if copy else x


def _check_ctx_store(ctx_store: str):
    if ctx_store not in ("dense", "paged"):
        raise ValueError(f"unknown ctx_store {ctx_store!r}: 'dense' or "
                         f"'paged'")


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

    cache: object              # a forest, trie or paged cache
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
    pad_token, and the paged store's ctx_store / page_size / num_pages)
    and on the cache's ``dec_lens`` / ``decode_capacity``.
    """

    def __init__(self, model, cfg: ModelConfig, ecfg):
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.decode_dispatches = 0          # chunks run, as in the reference
        # steps this engine object ran, by kind: "decode" (decode-only) and
        # "packed". Not host state: an engine rebuilt by a recovery counts
        # its replayed steps again, as the kernels' launch counters do.
        self.steps_run = {"decode": 0, "packed": 0}
        # host-side output mirrors (admission policy only — the decode
        # math depends exclusively on device-side state values)
        self.outputs = {s: [] for s in range(ecfg.slots)}   # slot -> tokens
        self.logps = {s: [] for s in range(ecfg.slots)}
        # slots whose decode output went non-finite (the sentinel in
        # _collect_emitted): their output stops being collected
        self.corrupt_slots = set()
        # segment / node id -> CRC32 of its live context bytes, recorded
        # when it is written (core/integrity.py), dropped when it frees
        self.seg_checksums = {}
        self.paged = ecfg.ctx_store == "paged"

    # ---- decode ----
    def _decode_one(self, params, state: ForestState, noise=None):
        """One slot-table decode step: advance every slot one token, gate
        the emission and the slot-table updates on each slot's live bit.
        Runs on the device with no host sync; updates ``state`` in place
        and returns (tok, logp, emit), each (b,). ``noise`` (b, V): the
        step's Gumbel draws (default: from ``state.generator``)."""
        logits, _ = self.model.decode_step(
            params, state.cache, state.tokens,
            impl="kernel" if self.ecfg.use_kernel else "einsum")
        return self._emit_step(state, logits[:, -1], noise)

    def _emit_step(self, state: ForestState, logits, noise=None):
        """Sample each slot's next token from its step ``logits`` (b, V)
        and gate the emission and the slot-table updates on its live bit,
        in place; returns (tok, logp, emit), each (b,)."""
        ecfg = self.ecfg
        sampled = sample_tokens(logits, ecfg.temperature, ecfg.top_p,
                                generator=state.generator, noise=noise)
        tok_logp = _token_logprob(logits, sampled)
        emit = state.active.clone()
        tok = torch.where(emit, sampled, torch.full_like(sampled,
                                                         ecfg.pad_token))
        if ecfg.eos_token >= 0:
            state.active &= sampled != ecfg.eos_token
        state.tokens.copy_(tok[:, None])
        state.steps += emit.to(torch.int32)
        return tok, tok_logp, emit

    def _check_decode_capacity(self, state: ForestState, n_steps: int,
                               what: str):
        """Raise if ``n_steps`` more steps would push any LIVE slot past
        its decode capacity (the per-slot KV write would clamp at the last
        slot and corrupt that slot's decode arm); slots admitted
        mid-lifetime sit at different depths, so the guard tracks the
        deepest live one. One host read of the state."""
        active = state.active.cpu()
        if bool(active.any()):
            deepest = int(state.cache.dec_lens.cpu()[active].max())
            cap = state.cache.decode_capacity
            if deepest + n_steps > cap:
                raise DecodeCapacityExceeded(
                    f"{what} would overflow decode_capacity={cap} "
                    f"(deepest live slot at {deepest}); retire slots or "
                    f"shorten the chunk")

    def step_chunk(self, params, state: ForestState, n_steps: int,
                   noise=None):
        """Run ``n_steps`` decode steps for the whole slot table. The loop
        keeps every state tensor on the device; the host reads the state
        once before the chunk (the capacity guard) and once after it (the
        emitted tokens), never inside it. Appends each live slot's emitted
        tokens to the host-side output lists and returns the state.
        ``noise`` (n_steps, b, V): the Gumbel draws of every step, as
        ``ServeEngine.generate`` takes them (default: ``state.generator``).

        Raises ``DecodeCapacityExceeded`` if the chunk would push any live
        slot past its decode capacity."""
        self._check_decode_capacity(state, n_steps,
                                    f"chunk of {n_steps} steps")
        outs = [self._decode_one(params, state,
                                 None if noise is None else noise[i])
                for i in range(n_steps)]
        self.decode_dispatches += 1
        self.steps_run["decode"] += n_steps
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

    def _sample_first(self, generator, logits0, n_samples, noise=None):
        """Sample each fanned-out slot's first token from the shared
        prefill logits; returns (tokens (n,), logps (n,), live (n,) bool)
        with EOS-at-step-0 already folded into ``live``. ``noise`` (n, V):
        the Gumbel draws (default: from ``generator``)."""
        ecfg = self.ecfg
        logits_b = logits0.reshape(1, -1).expand(n_samples, logits0.shape[-1])
        tok = sample_tokens(logits_b, ecfg.temperature, ecfg.top_p,
                            generator=generator, noise=noise)
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
        """Host-side utilization snapshot: live slot count and, in paged
        mode, the pool's free and total pages."""
        occ = {"live_slots": int(state.active.sum()),
               "slots": int(self.ecfg.slots)}
        if self.paged:
            occ["pages_free"] = int(self.page_alloc.free_count())
            occ["pages_total"] = int(self.num_pages)
        return occ

    def _init_pages(self, n_segments: int, capacity: int):
        """Paged mode's host state: the pool geometry and its allocator."""
        ecfg = self.ecfg
        self.pages_per_seg = pages_needed(capacity, ecfg.page_size)
        self.num_pages = (ecfg.num_pages if ecfg.num_pages is not None
                          else n_segments * self.pages_per_seg)
        self.page_alloc = PageAllocator(self.num_pages)

    # ---- integrity (KV checksums) ----
    def _live_segments(self):
        """Segment / node ids currently holding live context (subclass)."""
        raise NotImplementedError

    def _record_checksum(self, cache, idx: int):
        """Fingerprint segment ``idx``'s live context bytes right after they
        are written (re-verified by ``verify_checksums``)."""
        self.seg_checksums[idx] = segment_checksum(cache, idx)

    def verify_checksums(self, state: ForestState) -> bool:
        """Recompute every LIVE segment's context checksum and compare it to
        the CRC recorded at write time. Raises ``KVCorruption`` on the
        first mismatch; run at snapshot load and on demand through
        ``audit_state(verify_checksums=True)``."""
        for idx in self._live_segments():
            expected = self.seg_checksums.get(idx)
            if expected is None:
                continue
            verify_segment(state.cache, idx, expected,
                           what=type(self).__name__ + " segment")
        return True

    def _audit_pages(self, state: ForestState, live, pages: dict,
                     extra_tracked, verify: bool) -> bool:
        """``audit_state``'s body: optionally re-verify the checksums, then
        run ``PageAllocator.audit`` over the ``live`` segments' page-table
        rows and the page ids the host mirrors (``pages``) and the caller
        (``extra_tracked``, e.g. a frontend's fault-stolen pages) hold.
        Dense mode has no allocator: its checks are trivially True."""
        if verify:
            self.verify_checksums(state)
        if not self.paged:
            return True
        tables = state.cache.store.page_tables.cpu().numpy()
        rows = [tables[i] for i in live]
        tracked = [pid for ids in pages.values() for pid in ids]
        tracked.extend(int(i) for i in extra_tracked)
        return self.page_alloc.audit(rows=rows, tracked=tracked)

    # ---- durable-state serialization (checkpoint/recovery) ----
    def host_state(self) -> dict:
        """JSON-serializable snapshot of the host-side mirrors shared by
        every slot-table engine; subclasses extend it with their own.
        Together with the device ``ForestState`` this is the engine's whole
        state: restoring both onto a fresh engine continues bit-identically."""
        return {
            "decode_dispatches": int(self.decode_dispatches),
            "outputs": [list(self.outputs[s])
                        for s in range(self.ecfg.slots)],
            "logps": [list(self.logps[s]) for s in range(self.ecfg.slots)],
            "seg_checksums": [[int(k), int(v)]
                              for k, v in self.seg_checksums.items()],
            "corrupt_slots": sorted(int(s) for s in self.corrupt_slots),
        }

    def load_host_state(self, d: dict):
        self.decode_dispatches = int(d["decode_dispatches"])
        self.outputs = {s: [int(t) for t in toks]
                        for s, toks in enumerate(d["outputs"])}
        self.logps = {s: [float(x) for x in lps]
                      for s, lps in enumerate(d["logps"])}
        self.seg_checksums = {int(k): int(v) for k, v in d["seg_checksums"]}
        self.corrupt_slots = set(int(s) for s in d["corrupt_slots"])
        return self


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

    With ``ctx_store="paged"`` the segments live in a page pool of
    ``num_pages`` pages (default: the full envelope; fewer oversubscribe
    it): admission allocates ``ceil(len / page_size)`` pages and raises
    ``PoolExhausted`` before any mutation when too few are free;
    retirement returns a group's pages; ``release_retired`` empties the
    retired groups' page tables, so their pages leave the kernel's walk,
    and every admission runs it before allocating, so no pool page is ever
    referenced by two segments.

    Integrity and durability: a segment's live context bytes are
    fingerprinted when it is written (``seg_checksums``, dropped at
    retirement); ``audit_state`` runs the allocator's audit (and, on
    demand, ``verify_checksums``); ``host_state`` / ``load_host_state``
    carry the host mirrors through a snapshot.
    """

    def __init__(self, model, cfg: ModelConfig, fcfg: ForestConfig):
        _check_ctx_store(fcfg.ctx_store)
        super().__init__(model, cfg, fcfg)
        self.fcfg = fcfg
        # host-side slot table mirrors (admission policy only)
        self.group_live = [False] * fcfg.n_groups
        self.slot_group = [-1] * fcfg.slots
        if self.paged:
            self._init_pages(fcfg.n_groups, fcfg.ctx_capacity)
            self.group_pages = {}        # group id -> pool page ids

    # ---- lifecycle ----
    def init_state(self, device="cuda") -> ForestState:
        """The empty slot table and forest cache on ``device`` (CUDA unless
        the caller asks for the CPU). The bf16 family's segments and both
        families' decode arms are stored in bf16, as in the reference."""
        fcfg = self.fcfg
        dev = resolve_device(device)
        quant = "int8" if fcfg.cache_dtype == "int8" else "none"
        if self.paged:
            cache = PagedGroupedBifurcatedCache.init(
                self.cfg.n_layers, fcfg.n_groups, fcfg.slots,
                fcfg.ctx_capacity, fcfg.decode_capacity,
                self.cfg.n_kv_heads_padded, self.cfg.kq_dim,
                page_m=fcfg.page_size, num_pages=self.num_pages,
                ctx_quant=quant, device=dev)
        else:
            cache = self.model.make_forest_cache(
                fcfg.slots, fcfg.n_groups, fcfg.ctx_capacity,
                fcfg.decode_capacity, quant, dtype=torch.bfloat16,
                device=dev)
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
              n_samples: int, noise=None) -> tuple:
        """Admit one request: prefill its context into a free segment, fan
        ``n_samples`` slots out over it, sample their first token from the
        prefill logits. Returns (state, slot_ids). A rejected admission
        raises its typed error before anything is mutated. EOS-at-step-0:
        a first token equal to ``eos_token`` retires the slot before it
        ever decodes (its emitted sequence is just the EOS). ``noise``
        (n_samples, V): the first tokens' Gumbel draws (default: from
        ``state.generator``)."""
        fcfg = self.fcfg
        m_new = int(context_tokens.shape[1])
        if m_new > fcfg.ctx_capacity:
            raise SegmentCapacityExceeded(
                f"context of {m_new} tokens exceeds the segment capacity "
                f"{fcfg.ctx_capacity}; rejected (raise "
                f"ForestConfig.ctx_capacity or split the request)")
        if self.paged:
            n_pg = pages_needed(m_new, fcfg.page_size)
            if n_pg > self.page_alloc.free_count():
                raise PoolExhausted(
                    f"context of {m_new} tokens needs {n_pg} pool pages, "
                    f"only {self.page_alloc.free_count()} of "
                    f"{self.num_pages} free — retire first")
        free_g = self.free_groups()
        free_s = self.free_slots(state)
        if not free_g:
            raise SegmentsExhausted("no free context segment — retire first")
        if len(free_s) < n_samples:
            raise SlotsExhausted(
                f"need {n_samples} free slots, have {len(free_s)}")
        gidx, slots = free_g[0], free_s[:n_samples]
        if self.paged:
            # pages released at retire may go to this admission: clear the
            # retired groups' stale table rows first, so no pool page is
            # ever referenced by two segments (after the rejections: a
            # rejected admission mutates nothing)
            state = self.release_retired(state)

        logits0, cache1 = self.model.prefill(params, context_tokens)
        if self.paged:
            page_ids = self.page_alloc.alloc(n_pg)
            self.group_pages[gidx] = page_ids
            cache = state.cache.write_context(cache1.k[:, 0], cache1.v[:, 0],
                                              gidx, page_ids)
        else:
            cache = state.cache.write_context(cache1.k[:, 0], cache1.v[:, 0],
                                              gidx)
        dev = state.active.device
        slot_ids = torch.as_tensor(slots, dtype=torch.long, device=dev)
        slot_mask = torch.zeros(fcfg.slots, dtype=torch.bool, device=dev)
        slot_mask[slot_ids] = True
        cache.assign_slots(slot_mask, gidx)
        self._record_checksum(cache, gidx)

        tok, lp, live = self._sample_first(state.generator, logits0,
                                           n_samples, noise)
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
        them; the kernels read only live lengths of assigned segments. In
        paged mode the retired groups' pages return to the allocator at
        once; their table rows are emptied by ``release_retired`` (or by
        the next admission, before it allocates).
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
                self.seg_checksums.pop(g, None)
                if self.paged:
                    self.page_alloc.release(self.group_pages.pop(g, []))
        return retired

    def release_retired(self, state: ForestState) -> ForestState:
        """Paged mode: empty the page-table rows of every non-live group,
        in place, so their pages leave the decode kernel's walk (a freed
        segment costs zero decode bytes). The dense store has nothing to
        release. Returns ``state``."""
        if self.paged:
            for g in range(self.fcfg.n_groups):
                if not self.group_live[g]:
                    state.cache.free_group(g)
        return state

    # ---- robustness surface ----
    def cancel_group(self, state: ForestState, group: int) -> ForestState:
        """Deactivate every slot of a LIVE group (preemption / deadline /
        client cancellation). The group frees through ``retire_groups``;
        until then the slots' partial outputs stay readable."""
        slots = [s for s in range(self.fcfg.slots)
                 if self.slot_group[s] == group]
        return self.deactivate_slots(state, slots)

    def _live_segments(self):
        return [g for g in range(self.fcfg.n_groups) if self.group_live[g]]

    def audit_state(self, state: ForestState, extra_tracked=(),
                    verify_checksums: bool = False) -> bool:
        """``PageAllocator.audit`` against the live groups' page-table rows
        and the host's page mirrors (``extra_tracked``: pages a caller holds
        outside them); with ``verify_checksums`` every live segment's KV
        bytes are re-fingerprinted first (a host round-trip per segment:
        on demand, not every round). Raises on the first violation."""
        return self._audit_pages(state, self._live_segments(),
                                 self.group_pages if self.paged else {},
                                 extra_tracked, verify_checksums)

    # ---- durable-state serialization (checkpoint/recovery) ----
    def host_state(self) -> dict:
        d = super().host_state()
        d.update({
            "group_live": [bool(x) for x in self.group_live],
            "slot_group": [int(x) for x in self.slot_group],
        })
        if self.paged:
            d["group_pages"] = [[int(g), [int(p) for p in ids]]
                                for g, ids in self.group_pages.items()]
            d["allocator"] = self.page_alloc.state_dict()
        return d

    def load_host_state(self, d: dict):
        super().load_host_state(d)
        self.group_live = [bool(x) for x in d["group_live"]]
        self.slot_group = [int(x) for x in d["slot_group"]]
        if self.paged:
            self.group_pages = {int(g): [int(p) for p in ids]
                                for g, ids in d["group_pages"]}
            self.page_alloc.load_state_dict(d["allocator"])
        return self


# ---------------------------------------------------------------------------
# Continuous-batching prefix-trie engine (cascade serving)
# ---------------------------------------------------------------------------

def _tokens_key(seg) -> tuple:
    """A (1, m) token segment's contents as a hashable tuple (host sync)."""
    return tuple(int(t) for t in torch.as_tensor(seg)[0].tolist())


class TreeServeEngine(_SlotTableEngine):
    """Continuous-batching serve loop over a prefix TRIE.

    Requests arrive as a path of ``segments`` (outermost shared level
    first); admission matches the LONGEST existing prefix path before
    allocating anything:

      admit   — walk the host-side trie index level by level; every level
                that matches a live node (same ancestor path, same tokens)
                is REUSED, its KV neither recomputed into the cache nor
                stored again. The request's full concatenation is
                prefilled once (batch=1) for the first-token logits, and
                only the NEW levels' KV slices are written into free node
                segments (``write_node``: quantize/transpose once, in
                place). Free slots are pointed at the path
                (``assign_paths``).
      decode  — inherited ``step_chunk``: the whole slot table advances
                with the state on the device, read back once per chunk;
                with ``use_kernel`` every layer-step is one launch of the
                tree kernel, which reads each node on a path once per kv
                head per step however many paths go through it.
      retire  — ``retire_requests`` frees finished requests; node
                refcounts drop along their paths and a node (and its
                trie-index entry) frees only when NO live request
                references it: shared ancestors survive their children.
                With ``prefix_cache`` a refcount-zero node is not freed: it
                becomes CACHED (its K/V, pages and index entry stay
                resident, LRU-stamped), and a later admission that matches
                it revives it at no prefill and no new page. Cached nodes
                are evicted lazily, children first, only when an admission
                lacks free nodes or pages (``_evict_cached``): oldest stamp
                first, or under ``evict_policy="sharing"`` the ones with
                the fewest ancestor-shared bytes first.

    With every request a single segment (depth-1 paths) this engine serves
    the flat forest's workload. With ``ctx_store="paged"`` the nodes live in
    a page pool, as the forest's segments do: only NEW nodes allocate
    pages (a reused ancestor costs none), a node's pages return to the
    allocator when its refcount reaches zero, and ``release_retired``
    empties freed nodes' table rows (every admission runs it before
    allocating).

    ``suffix_prefill``: on a prefix hit, the matched ancestors' cached K/V
    is the context of a prefill of the new levels' tokens only
    (``model.prefill_suffix``), instead of the whole path.

    ``step_mode="packed"``: an admission with new trie levels becomes a
    PENDING prefill (nodes and pages reserved, nothing computed); its
    suffix goes through the model in chunks of ``prefill_chunk`` tokens,
    one per decode step of the whole slot table, never crossing a node
    (``_packed_step``). On the paged store with ``use_kernel`` each
    layer-step of such a step is ONE launch of the packed kernel, which
    serves the decode rows and the chunk rows together and reads the
    shared ancestors' pages once for both; otherwise the decode step and
    a suffix prefill of the chunk run one after the other. A node goes
    live when its last chunk lands; the request activates (its slots get
    their path and first token) when its last node does. Until then its
    slots emit nothing, ``retire_requests`` skips it, ``cancel_request``
    aborts it, and an admission whose first new level collides with a
    pending node raises ``PrefillInFlight``.

    Integrity and durability: a node's live context bytes are fingerprinted
    when it is written (``seg_checksums``; a cached node keeps its CRC, an
    evicted or freed one drops it); ``audit_state`` runs the allocator's
    audit over the live nodes (and, on demand, ``verify_checksums``);
    ``host_state`` / ``load_host_state`` carry the trie index, refcounts,
    lengths, the prefix cache's stamps and statistics, the request table
    and the allocator's free list through a snapshot (refused while a
    packed prefill is pending).
    """

    def __init__(self, model, cfg: ModelConfig, tcfg: TreeConfig):
        _check_ctx_store(tcfg.ctx_store)
        if tcfg.evict_policy not in ("lru", "sharing"):
            raise ValueError(f"unknown evict_policy {tcfg.evict_policy!r}: "
                             f"'lru' or 'sharing'")
        if tcfg.step_mode not in ("decode", "packed"):
            raise ValueError(f"unknown step_mode {tcfg.step_mode!r}: "
                             f"'decode' or 'packed'")
        super().__init__(model, cfg, tcfg)
        self.tcfg = tcfg
        # host-side trie mirrors (admission policy only — the decode math
        # depends exclusively on device-side state values)
        self.node_live = [False] * tcfg.n_nodes
        self.node_refs = [0] * tcfg.n_nodes          # live-request refcount
        self.node_index = {}    # (parent id, token tuple) -> node id
        self.node_key = [None] * tcfg.n_nodes        # reverse map
        self.node_len = [0] * tcfg.n_nodes           # live tokens per node
        self.slot_request = [-1] * tcfg.slots
        # request table: rid -> {"path", "slots", "live"}: live requests
        # plus retired ones still referenced by a slot (their outputs stay
        # readable until the slot is reused); anything else compacts away
        # (_compact_requests). rids are monotonic and never reused.
        self.requests = {}
        self.next_rid = 0
        self.last_rid = -1      # rid of the most recent admit
        # cross-request prefix cache (tcfg.prefix_cache): refcount-zero nodes
        # stay resident (node_live True, pages held, index entry kept),
        # stamped here for LRU eviction; a later admission matching one pops
        # its stamp and bumps its refcount
        self.node_cached = {}   # node id -> LRU stamp
        self.lru_clock = 0
        # per-admission accounting of path tokens reused from resident trie
        # nodes vs written fresh, tokens run through prefill, evictions
        self.prefix_stats = {"admits": 0, "full_hits": 0,
                             "partial_hits": 0, "reused_tokens": 0,
                             "new_tokens": 0, "computed_tokens": 0,
                             "evictions": 0}
        if self.paged:
            self._init_pages(tcfg.n_nodes, tcfg.node_capacity)
            # node id -> pool page ids; an ancestor's pages are allocated
            # at its first admission and freed with the node itself
            self.node_pages = {}
        # packed mode: rid -> pending-prefill record, and the node ids its
        # prefills reserved: not live (no KV yet; an empty table row in the
        # paged store), not free (identity and pages claimed)
        self._pending = {}
        self.node_pending = set()

    # ---- lifecycle ----
    def init_state(self, device="cuda") -> ForestState:
        """The empty slot table and trie cache on ``device`` (CUDA unless
        the caller asks for the CPU): a ``PrefixTreeCache`` / its int8 twin,
        or under ``ctx_store="paged"`` a ``PagedPrefixTreeCache`` over the
        page pool. The bf16 families' nodes and every decode arm are stored
        in bf16, as in the reference."""
        tcfg = self.tcfg
        dev = resolve_device(device)
        quant = "int8" if tcfg.cache_dtype == "int8" else "none"
        if self.paged:
            cache = self.model.make_paged_cache(
                tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
                page_m=tcfg.page_size, num_pages=self.num_pages,
                dec_capacity=tcfg.decode_capacity, ctx_quant=quant,
                dtype=torch.bfloat16, device=dev)
        else:
            cache = self.model.make_tree_cache(
                tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
                tcfg.decode_capacity, quant, dtype=torch.bfloat16,
                device=dev)
        b = tcfg.slots
        return ForestState(
            cache=cache,
            tokens=torch.zeros((b, 1), dtype=torch.int64, device=dev),
            active=torch.zeros(b, dtype=torch.bool, device=dev),
            steps=torch.zeros(b, dtype=torch.int32, device=dev),
            generator=torch.Generator(device=dev).manual_seed(tcfg.seed),
        )

    def free_nodes(self):
        return [i for i, live in enumerate(self.node_live)
                if not live and i not in self.node_pending]

    def free_slots(self, state: ForestState, active=None):
        """Slots safe to (re)assign: never admitted, or belonging to a
        RETIRED request (an EOS'd slot of a still-live request keeps its
        output readable). A slot whose request was compacted away counts
        as retired. ``active`` — optional host copy of ``state.active``,
        so one serve round syncs once."""
        if active is None:
            active = state.active.cpu()
        return [s for s in range(self.tcfg.slots)
                if not bool(active[s]) and (
                    self.slot_request[s] < 0
                    or not self.request_live(self.slot_request[s]))]

    def request_live(self, rid: int) -> bool:
        """Is request ``rid`` still live? A compacted rid is not."""
        req = self.requests.get(rid)
        return bool(req is not None and req["live"])

    def match_prefix(self, segments):
        """Longest-matching prefix path for ``segments`` (list of (1, m)
        token tensors, outermost level first): returns (node ids of the
        matched levels, number matched). Node identity is (ancestor node,
        token content), so a match guarantees identical KV."""
        path, parent = [], -1
        for seg in segments:
            nid = self.node_index.get((parent, _tokens_key(seg)))
            if nid is None or not self.node_live[nid]:
                break
            path.append(nid)
            parent = nid
        return path, len(path)

    def peek_prefix(self, segments):
        """Side-effect-free admission probe: ``(path, matched,
        matched_tokens)`` — what ``admit`` would reuse, and the resident
        tokens on that path. Touches no refcount and no statistic."""
        path, matched = self.match_prefix(segments)
        return path, matched, sum(self.node_len[nid] for nid in path)

    def step_io_bytes(self, state: ForestState, active=None) -> dict:
        """Modelled per-decode-step device-memory bytes of the live slot
        table (per layer), via ``core.io_model.tree_decode_io_bytes`` over
        the live slots' paths: every referenced node read once, plus the
        per-slot decode arms and q/out rows. Returns ``{"ctx_bytes",
        "total", "slots"}`` — zeros when nothing is decoding."""
        if active is None:
            active = state.active.cpu()
        paths = []
        for s in range(self.tcfg.slots):
            rid = self.slot_request[s]
            if bool(active[s]) and rid >= 0 and self.request_live(rid):
                paths.append(tuple(self.requests[rid]["path"]))
        if not paths:
            return {"ctx_bytes": 0, "total": 0, "slots": 0}
        io = tree_decode_io_bytes(
            paths=paths, node_lens=self.node_len,
            c_d=self.tcfg.decode_capacity, g=self.cfg.n_kv_heads,
            hd=self.cfg.kq_dim)
        return {"ctx_bytes": int(sum(io["per_node"].values())),
                "total": int(io["total"]), "slots": len(paths)}

    # ---- cross-request prefix cache (tcfg.prefix_cache) ----
    def cached_nodes(self):
        """Refcount-zero trie nodes held resident as cache entries (sorted
        node ids)."""
        return sorted(self.node_cached)

    def _eviction_order(self, protect=()):
        """Cached nodes outside ``protect`` in eviction order. A candidate
        has no resident child (evicting a parent first would leave its
        descendants' (parent, tokens) keys dangling across node reuse);
        among candidates the oldest LRU stamp goes first, then the fewest
        live tokens, then the lowest id. A live descendant pins its
        ancestors' refcounts, so a cached node's resident descendants are
        cached too and the childless-first peeling reaches every candidate.
        Under ``evict_policy="sharing"`` the first key is the candidate's
        ancestor-shared bytes (``_ancestor_shared_bytes``): cold private
        tails go before leaves under hot shared ancestors, whatever their
        stamps."""
        protect = set(protect)
        remaining = {n for n in self.node_cached if n not in protect}
        if self.tcfg.evict_policy == "sharing":
            def key(n):
                return (self._ancestor_shared_bytes(n), self.node_cached[n],
                        self.node_len[n], n)
        else:
            def key(n):
                return (self.node_cached[n], self.node_len[n], n)
        order = []
        while remaining:
            blocked = {self.node_key[n][0] for n in remaining}
            nid = min((n for n in remaining if n not in blocked), key=key)
            order.append(nid)
            remaining.discard(nid)
        return order

    def _ancestor_shared_bytes(self, nid: int) -> int:
        """Per-layer context bytes of ``nid``'s resident ancestors that are
        SHARED: pinned by a live request (refcount > 0) or parent of two or
        more resident children. A node under a private chain scores 0."""
        children = {}
        for n in range(self.tcfg.n_nodes):
            if self.node_live[n] and self.node_key[n] is not None:
                parent = self.node_key[n][0]
                if parent >= 0:
                    children[parent] = children.get(parent, 0) + 1
        per_tok = 2 * self.cfg.n_kv_heads * self.cfg.kq_dim * 2
        total, n = 0, nid
        while True:
            key = self.node_key[n]
            if key is None or key[0] < 0:
                return total
            parent = key[0]
            if self.node_refs[parent] > 0 or children.get(parent, 0) >= 2:
                total += self.node_len[parent] * per_tok
            n = parent

    def _evict_cached(self, state: ForestState, *, need_nodes: int = 0,
                      need_pages: int = 0, protect=()) -> ForestState:
        """Evict cached nodes, in ``_eviction_order``, until ``need_nodes``
        free nodes and ``need_pages`` allocatable pool pages exist. A
        demand that evicting every candidate cannot meet evicts nothing:
        the caller's capacity error fires and the cache keeps its
        contents. A victim frees as at eager retirement (index entry and
        length dropped); in paged mode its page-table row is cleared
        before its pages return to the allocator, so no page is ever named
        by two nodes. Returns ``state`` (updated in place)."""
        order = self._eviction_order(protect)
        victims = []
        if self.paged and need_pages:
            plan = self.page_alloc.plan_eviction(
                need_pages,
                [(n, len(self.node_pages.get(n, ()))) for n in order])
            if plan is None:
                return state
            victims = list(plan)
        short = need_nodes - len(self.free_nodes()) - len(victims)
        if short > 0:
            if len(victims) + short > len(order):
                return state
            victims = order[:len(victims) + short]
        for nid in victims:
            self.node_live[nid] = False
            self.node_cached.pop(nid, None)
            self.node_index.pop(self.node_key[nid], None)
            self.node_key[nid] = None
            self.node_len[nid] = 0
            self.seg_checksums.pop(nid, None)
            if self.paged:
                state.cache.free_node(nid)
                self.page_alloc.release(self.node_pages.pop(nid, []))
        self.prefix_stats["evictions"] += len(victims)
        return state

    def _node_kv(self, cache, nid: int, m: int):
        """One resident node's first ``m`` live tokens of K/V as
        (L, m, g, hd) tensors in the decode arm's dtype, read from the
        serve cache: dense slab slices or pool-page gathers; int8 nodes
        dequantize (the k scales carry the logit scale hd**-0.5 folded in,
        so K unfolds it by hd**0.5)."""
        hd = self.cfg.kq_dim
        store = getattr(cache, "store", None)
        if store is not None:
            ids = torch.as_tensor(self.node_pages[nid], dtype=torch.long,
                                  device=store.k_pages.device)

            def pages(t):   # (L, P, g, pm[, hd]) -> (L, m, g[, hd])
                x = t.index_select(1, ids).transpose(2, 3)
                return x.reshape(x.shape[0], -1, *x.shape[3:])[:, :m]

            k, v = pages(store.k_pages), pages(store.v_pages)
            if hasattr(store, "k_scale_pages"):
                k = k.float() * pages(store.k_scale_pages)[..., None] * hd**0.5
                v = v.float() * pages(store.v_scale_pages)[..., None]
        else:
            gmk = cache.ctx_layout == "gmk"

            def node(t):    # (L, N, g, m_c[, hd]) | (L, N, m_c, g[, hd])
                x = t[:, nid]
                return x[:, :, :m].transpose(1, 2) if gmk else x[:, :m]

            k, v = node(cache.k_ctx), node(cache.v_ctx)
            if hasattr(cache, "k_scale"):
                k = k.float() * node(cache.k_scale)[..., None] * hd**0.5
                v = v.float() * node(cache.v_scale)[..., None]
        dtype = cache.k_dec.dtype
        return k.to(dtype), v.to(dtype)

    def _gather_path_kv(self, state: ForestState, path, cut: int):
        """Per-layer K/V of the matched path's first ``cut`` tokens in the
        prefill layout (L, 1, cut, g, hd): the cached context fed to
        ``model.prefill_suffix`` so that admission never recomputes it."""
        ks, vs = [], []
        got = 0
        for nid in path:
            if got >= cut:
                break
            m = min(self.node_len[nid], cut - got)
            k, v = self._node_kv(state.cache, nid, m)
            ks.append(k)
            vs.append(v)
            got += m
        return torch.cat(ks, dim=1)[:, None], torch.cat(vs, dim=1)[:, None]

    def admit(self, params, state: ForestState, segments,
              n_samples: int, noise=None) -> tuple:
        """Admit one request given as a PATH of ``segments`` — a list of
        (1, m_i) token tensors, outermost shared level first; 1 <= len <=
        ``depth``. The longest matching prefix of the path is reused from
        the trie; the full concatenation is prefilled ONCE (with
        ``suffix_prefill``, only the new levels' tokens over the matched
        ancestors' cached K/V) and only the new levels' KV slices are
        written. ``n_samples`` free slots fan out over the path. Returns
        (state, slot_ids). A rejected admission raises its typed error
        before anything is mutated; EOS at step 0 retires a slot before it
        ever decodes. ``noise`` (n_samples, V): the first tokens' Gumbel
        draws (default: from ``state.generator``; a packed admission
        samples them when it activates, from the generator).

        In packed mode an admission with new levels only reserves them and
        returns at once: its slots start decoding after its chunks land
        (``step_chunk``). An admission whose first new level is being
        prefilled by a pending request raises ``PrefillInFlight``."""
        tcfg = self.tcfg
        dev = state.active.device
        segments = [torch.as_tensor(s, device=dev) for s in segments]
        if not 1 <= len(segments) <= tcfg.depth:
            raise ValueError(
                f"request path of {len(segments)} levels; engine depth "
                f"is {tcfg.depth}")
        cap = state.cache.node_capacity
        for seg in segments:
            if seg.shape[1] > cap:
                raise SegmentCapacityExceeded(
                    f"segment of {seg.shape[1]} tokens > node capacity {cap}")
        path, matched = self.match_prefix(segments)
        new_segs = segments[matched:]
        if new_segs:
            # the first new level's (parent, tokens) identity may be
            # reserved by a pending packed prefill: its KV is not written,
            # so it can be neither reused nor duplicated (deeper new levels
            # hang off nodes this admission creates)
            key0 = (path[-1] if path else -1, _tokens_key(new_segs[0]))
            nid0 = self.node_index.get(key0)
            if nid0 is not None and nid0 in self.node_pending:
                raise PrefillInFlight(
                    f"trie level is being prefilled by a pending packed "
                    f"admission (node {nid0}) — retry after its chunks "
                    f"land")
        if tcfg.prefix_cache and len(new_segs) > len(self.free_nodes()):
            # node pressure: evict cached nodes; the matched path is
            # protected, this admission revives it
            state = self._evict_cached(state, need_nodes=len(new_segs),
                                       protect=path)
        free_n = self.free_nodes()
        free_s = self.free_slots(state)
        if len(new_segs) > len(free_n):
            raise SegmentsExhausted(
                f"need {len(new_segs)} free trie nodes, have {len(free_n)}"
                " — retire first")
        if len(free_s) < n_samples:
            raise SlotsExhausted(
                f"need {n_samples} free slots, have {len(free_s)}")
        if self.paged:
            # admission gates on allocatable pool pages before any prefill
            # work: reused ancestors cost zero new pages
            n_pg = sum(pages_needed(int(s.shape[1]), tcfg.page_size)
                       for s in new_segs)
            if tcfg.prefix_cache and n_pg > self.page_alloc.free_count():
                # page pressure: the same lazy eviction, the victims
                # planned by the allocator against its free list
                state = self._evict_cached(state, need_pages=n_pg,
                                           protect=path)
            if n_pg > self.page_alloc.free_count():
                raise PoolExhausted(
                    f"request needs {n_pg} pool pages for "
                    f"{len(new_segs)} new node(s), only "
                    f"{self.page_alloc.free_count()} of {self.num_pages} "
                    f"free — retire first")
            # freed nodes' pages may go to this admission: clear their
            # stale table rows first (after the rejections)
            state = self.release_retired(state)
        slots = free_s[:n_samples]
        if self.tcfg.step_mode == "packed" and new_segs:
            return self._admit_packed(state, segments, slots, path, matched,
                                      free_n)

        total = sum(int(s.shape[1]) for s in segments)
        offset = sum(int(s.shape[1]) for s in segments[:matched])
        cut = 0
        if tcfg.suffix_prefill and matched:
            # SUFFIX-ONLY prefill: the matched ancestors' cached KV is the
            # context; only the new levels' tokens run through the model.
            # On a full-path hit the last cached token re-runs as a
            # one-token suffix, so that the first-token logits are defined
            cut = min(offset, total - 1)
            k_anc, v_anc = self._gather_path_kv(state, path, cut)
            suffix = torch.cat(segments, 1)[:, cut:]
            logits0, cache1 = self.model.prefill_suffix(
                params, suffix, k_anc, v_anc, start=cut)
        else:
            # ONE prefill of the full concatenation: reused ancestors are
            # recomputed (identical values) but not rewritten; each new
            # node gets its token slice
            logits0, cache1 = self.model.prefill(params,
                                                 torch.cat(segments, 1))
        stats = self.prefix_stats
        stats["admits"] += 1
        if matched == len(segments):
            stats["full_hits"] += 1
        elif matched:
            stats["partial_hits"] += 1
        stats["reused_tokens"] += offset
        stats["new_tokens"] += total - offset
        stats["computed_tokens"] += total - cut
        cache = state.cache
        parent = path[-1] if path else -1
        for seg in new_segs:
            nid = free_n.pop(0)
            m = int(seg.shape[1])
            k = cache1.k[:, 0, offset - cut:offset - cut + m]
            v = cache1.v[:, 0, offset - cut:offset - cut + m]
            if self.paged:
                ids = self.page_alloc.alloc(pages_needed(m, tcfg.page_size))
                self.node_pages[nid] = ids
                cache.write_node(k, v, nid, ids)
            else:
                cache.write_node(k, v, nid)
            key = (parent, _tokens_key(seg))
            self.node_index[key] = nid
            self.node_key[nid] = key
            self.node_live[nid] = True
            self.node_len[nid] = m
            self._record_checksum(cache, nid)
            path.append(nid)
            parent = nid
            offset += m
        for nid in path:
            self.node_refs[nid] += 1
            self.node_cached.pop(nid, None)  # revival: cached -> live

        path_col = torch.tensor(path + [-1] * (tcfg.depth - len(path)),
                                dtype=torch.int32, device=dev)
        slot_ids = torch.as_tensor(slots, dtype=torch.long, device=dev)
        slot_mask = torch.zeros(tcfg.slots, dtype=torch.bool, device=dev)
        slot_mask[slot_ids] = True
        cache.assign_paths(slot_mask, path_col)

        tok, lp, live = self._sample_first(state.generator, logits0,
                                           n_samples, noise)
        state.tokens[slot_ids, 0] = tok
        state.active[slot_ids] = live
        state.steps[slot_ids] = 0
        rid = self.next_rid
        self.next_rid += 1
        self.last_rid = rid
        self.requests[rid] = {"path": list(path), "slots": list(slots),
                              "live": True}
        tok_h, lp_h = tok.tolist(), lp.tolist()
        for i, s in enumerate(slots):
            self.slot_request[s] = rid
            self.outputs[s] = [int(tok_h[i])]
            self.logps[s] = [float(lp_h[i])]
            self.corrupt_slots.discard(s)  # fresh request, fresh verdict
        # slot reuse may have dropped the last reference to a retired
        # request's table entry
        self._compact_requests()
        return state, slots

    # ---- packed heterogeneous stepping (step_mode="packed") ----
    def _prefill_chunk(self) -> int:
        return self.tcfg.prefill_chunk or self.tcfg.page_size

    def _admit_packed(self, state: ForestState, segments, slots, path,
                      matched, free_n) -> tuple:
        """Packed-mode admission of a request with new trie levels, after
        the rejections: reserve a node (and in paged mode its pages) for
        every new level and register the request as PENDING; nothing is
        computed or written. The suffix is prefilled in chunks by the
        following steps (``_packed_step``); the slots activate when the
        last chunk lands. Until then the request is live (its slots are
        not free) but decodes nothing."""
        tcfg = self.tcfg
        new_segs = segments[matched:]
        total = sum(int(s.shape[1]) for s in segments)
        offset = sum(int(s.shape[1]) for s in segments[:matched])
        stats = self.prefix_stats
        stats["admits"] += 1
        if matched:
            stats["partial_hits"] += 1
        stats["reused_tokens"] += offset
        stats["new_tokens"] += total - offset
        stats["computed_tokens"] += total - offset

        parent = path[-1] if path else -1
        new_nodes = []
        for seg in new_segs:
            nid = free_n.pop(0)
            m = int(seg.shape[1])
            if self.paged:
                self.node_pages[nid] = self.page_alloc.alloc(
                    pages_needed(m, tcfg.page_size))
            key = (parent, _tokens_key(seg))
            self.node_index[key] = nid
            self.node_key[nid] = key
            self.node_len[nid] = m
            self.node_pending.add(nid)
            new_nodes.append((nid, m))
            path.append(nid)
            parent = nid
        for nid in path:
            self.node_refs[nid] += 1
            self.node_cached.pop(nid, None)  # revival: cached -> live

        rid = self.next_rid
        self.next_rid += 1
        self.last_rid = rid
        self.requests[rid] = {"path": list(path), "slots": list(slots),
                              "live": True}
        for s in slots:
            self.slot_request[s] = rid
            self.outputs[s] = []
            self.logps[s] = []
            self.corrupt_slots.discard(s)
        suffix = torch.cat([seg[0] for seg in new_segs]).cpu()
        self._pending[rid] = {
            "path": list(path), "slots": list(slots), "matched": matched,
            "new": new_nodes, "suffix": suffix, "cut": offset, "done": 0,
            "node_i": 0, "buf_len": 0, "fresh_start": offset,
            # kernel path: the per-layer fresh-KV envelopes (made at the
            # first chunk); reference path: the suffix KV prefilled so far
            "k_fresh": None, "v_fresh": None, "kbuf": None, "vbuf": None,
        }
        self._compact_requests()
        return state, slots

    def step_chunk(self, params, state: ForestState, n_steps: int,
                   noise=None, first_noise=None):
        """Packed mode: while a prefill is pending, run single packed steps,
        each advancing the whole slot table one token and the oldest
        pending prefill one chunk; the rest of the chunk (all of it when
        nothing is pending) runs as in decode mode. ``noise`` as in
        ``_SlotTableEngine.step_chunk``. ``first_noise`` (n_steps, b, V):
        at a step where a pending request activates, each of its slots'
        first token draws from that slot's row (by default the first
        tokens draw from ``state.generator``)."""
        if self.tcfg.step_mode != "packed":
            return super().step_chunk(params, state, n_steps, noise)
        done = 0
        while done < n_steps:
            if not self._pending:
                return super().step_chunk(
                    params, state, n_steps - done,
                    None if noise is None else noise[done:])
            state = self._packed_step(
                params, state, None if noise is None else noise[done],
                None if first_noise is None else first_noise[done])
            done += 1
        return state

    def _packed_step(self, params, state: ForestState, noise=None,
                     first_noise=None) -> ForestState:
        """ONE packed heterogeneous step: the whole slot table advances one
        decode token AND the oldest pending prefill advances one chunk of
        at most ``prefill_chunk`` tokens, never crossing a node. A node's
        last chunk writes its KV into the cache; the request's last node
        activates it from the final chunk's last logits. ``noise`` (b, V):
        the decode step's Gumbel draws; ``first_noise`` (b, V): the
        activated slots' first-token draws, by slot. Raises
        ``DecodeCapacityExceeded`` first if a live slot has no decode slot
        left."""
        rid = min(self._pending)
        pend = self._pending[rid]
        nid, m_node = pend["new"][pend["node_i"]]
        cv = min(self._prefill_chunk(), m_node - pend["buf_len"])
        chunk = pend["suffix"][pend["done"]:pend["done"] + cv]
        self._check_decode_capacity(state, 1, "packed step")
        if self.paged and self.tcfg.use_kernel:
            out, logits_last = self._packed_step_kernel(
                params, state, pend, chunk, cv, noise)
        else:
            out, logits_last = self._packed_step_ref(
                params, state, pend, chunk, noise)
        self.decode_dispatches += 1
        self.steps_run["packed"] += 1
        self._collect_emitted(*out)
        pend["buf_len"] += cv
        pend["done"] += cv
        if pend["buf_len"] == m_node:
            self._complete_node(state, pend, nid, m_node)
        if pend["node_i"] == len(pend["new"]):
            state = self._activate_pending(
                state, rid, logits_last,
                None if first_noise is None else first_noise[pend["slots"]])
        return state

    def _packed_step_kernel(self, params, state: ForestState, pend, chunk,
                            cv, noise):
        """The kernel path: ``model.decode_step_packed``, every layer-step
        one launch of the packed kernel over the decode rows and the chunk
        (padded to ``prefill_chunk`` rows), whose K/V land in the pending
        node's envelopes at ``buf_len``. Returns the step's emissions and
        the chunk's last live row's logits."""
        cfg = self.cfg
        cp = self._prefill_chunk()
        dev = state.active.device
        if pend["k_fresh"] is None:
            shape = (cfg.n_layers, self.pages_per_seg * self.tcfg.page_size,
                     cfg.n_kv_heads_padded, cfg.kq_dim)
            pend["k_fresh"] = state.cache.k_dec.new_zeros(shape)
            pend["v_fresh"] = state.cache.k_dec.new_zeros(shape)
        buf = torch.zeros((1, cp), dtype=torch.long)
        buf[0, :cv] = chunk
        fpath = pend["path"] + [-1] * (self.tcfg.depth - len(pend["path"]))
        start = pend["fresh_start"] + pend["buf_len"]
        logits, logits_c, _, _, _ = self.model.decode_step_packed(
            params, state.cache, state.tokens, buf.to(dev),
            k_fresh=pend["k_fresh"], v_fresh=pend["v_fresh"],
            buf_len=pend["buf_len"], chunk_valid=cv,
            fresh_start=pend["fresh_start"],
            fresh_pos=torch.arange(start, start + cp, dtype=torch.int32,
                                   device=dev),
            fresh_path=torch.tensor(fpath, dtype=torch.int32, device=dev))
        out = self._emit_step(state, logits[:, -1], noise)
        return out, logits_c[0, cv - 1]

    def _packed_step_ref(self, params, state: ForestState, pend, chunk,
                         noise):
        """The reference path (dense store, or ``use_kernel=False``): the
        decode step of decode mode, then a prefill of the chunk over
        [matched ancestors ⊕ the suffix KV prefilled so far] (a suffix
        prefill, or a plain prefill at position 0), row for row what the
        one-shot suffix prefill computes. Returns the step's emissions and
        the chunk's last logits."""
        out = self._decode_one(params, state, noise)
        start = pend["cut"] + pend["done"]
        chunk_t = chunk.to(state.active.device)[None, :]
        if start == 0:
            logits_c, cache_c = self.model.prefill(params, chunk_t)
        else:
            k_anc, v_anc = self._pending_context(state, pend, start)
            logits_c, cache_c = self.model.prefill_suffix(
                params, chunk_t, k_anc, v_anc, start=start)
        k_new, v_new = cache_c.k[:, 0], cache_c.v[:, 0]  # (L, cv, g, hd)
        for name, new in (("kbuf", k_new), ("vbuf", v_new)):
            pend[name] = (new if pend[name] is None
                          else torch.cat([pend[name], new], dim=1))
        return out, logits_c

    def _pending_context(self, state: ForestState, pend, start: int):
        """The pending request's first ``start`` tokens of per-layer K/V in
        the prefill layout (L, 1, start, g, hd): the matched ancestors read
        from the cache ⊕ the suffix tokens prefilled by earlier chunks."""
        ks, vs = [], []
        if pend["cut"]:
            k_m, v_m = self._gather_path_kv(
                state, pend["path"][:pend["matched"]], pend["cut"])
            ks.append(k_m[:, 0])
            vs.append(v_m[:, 0])
        if pend["done"]:
            ks.append(pend["kbuf"])
            vs.append(pend["vbuf"])
        dtype = ks[-1].dtype
        return (torch.cat([k.to(dtype) for k in ks], dim=1)[:, None],
                torch.cat([v.to(dtype) for v in vs], dim=1)[:, None])

    def _complete_node(self, state: ForestState, pend, nid: int, m: int):
        """All of node ``nid``'s tokens are prefilled: write its KV into the
        serve cache (quantized and transposed once, in place, as a
        synchronous admission writes it) and flip the node live, so that
        later chunks and requests read it."""
        if pend["k_fresh"] is not None:
            k, v = pend["k_fresh"][:, :m], pend["v_fresh"][:, :m]
        else:
            lo = pend["done"] - m
            k = pend["kbuf"][:, lo:lo + m]
            v = pend["vbuf"][:, lo:lo + m]
        if self.paged:
            state.cache.write_node(k, v, nid, self.node_pages[nid])
        else:
            state.cache.write_node(k, v, nid)
        self._record_checksum(state.cache, nid)
        self.node_live[nid] = True
        self.node_pending.discard(nid)
        pend["node_i"] += 1
        pend["buf_len"] = 0
        pend["fresh_start"] += m

    def _activate_pending(self, state: ForestState, rid: int, logits0,
                          noise=None) -> ForestState:
        """The pending request's last chunk landed: point its reserved
        slots at the now live path and sample their first token from the
        last chunk's last logits, as a synchronous admission samples from
        its prefill's. ``noise`` (n_samples, V): the Gumbel draws."""
        tcfg = self.tcfg
        pend = self._pending.pop(rid)
        path, slots = pend["path"], pend["slots"]
        dev = state.active.device
        path_col = torch.tensor(path + [-1] * (tcfg.depth - len(path)),
                                dtype=torch.int32, device=dev)
        slot_ids = torch.as_tensor(slots, dtype=torch.long, device=dev)
        slot_mask = torch.zeros(tcfg.slots, dtype=torch.bool, device=dev)
        slot_mask[slot_ids] = True
        state.cache.assign_paths(slot_mask, path_col)
        tok, lp, live = self._sample_first(state.generator, logits0,
                                           len(slots), noise)
        state.tokens[slot_ids, 0] = tok
        state.active[slot_ids] = live
        state.steps[slot_ids] = 0
        tok_h, lp_h = tok.tolist(), lp.tolist()
        for i, s in enumerate(slots):
            self.outputs[s] = [int(tok_h[i])]
            self.logps[s] = [float(lp_h[i])]
        return state

    def _abort_pending(self, state: ForestState, rid: int) -> ForestState:
        """Abort an in-flight packed prefill (cancellation): its unwritten
        reserved nodes free at once (trie identity dropped, pages
        released; nothing of them was ever written to the cache), and its
        matched ancestors and completed nodes release through the
        refcounted path of retirement."""
        pend = self._pending.pop(rid)
        self.requests[rid]["live"] = False
        for nid, _ in pend["new"][pend["node_i"]:]:
            self.node_pending.discard(nid)
            self.node_refs[nid] -= 1
            self.node_index.pop(self.node_key[nid], None)
            self.node_key[nid] = None
            self.node_len[nid] = 0
            if self.paged:
                self.page_alloc.release(self.node_pages.pop(nid, []))
        self._release_path(pend["path"][:pend["matched"] + pend["node_i"]])
        self._compact_requests()
        return state

    # ---- retire ----
    def retire_requests(self, state: ForestState, active=None):
        """Free every request whose slots have all gone inactive. Node
        refcounts drop along the retired paths; a node's segment (and its
        trie-index entry) frees only at refcount zero — an ancestor shared
        with a still-live request survives; with ``prefix_cache`` it is
        cached instead (``_release_path``). A request whose packed
        prefill is pending is skipped: its slots are inactive until it
        activates, and it ends only by ``cancel_request``. Returns the
        retired request ids; their slots become reusable by the next
        ``admit``. ``active`` optionally supplies a host copy of
        ``state.active``."""
        if active is None:
            active = state.active.cpu()
        retired = []
        for rid in sorted(self.requests):
            req = self.requests[rid]
            if rid in self._pending:
                continue
            if req["live"] and not any(bool(active[s]) for s in req["slots"]):
                req["live"] = False
                retired.append(rid)
                self._release_path(req["path"])
        if retired:
            self._compact_requests()
        return retired

    def _release_path(self, path):
        """Drop one reference from every node on ``path`` and free, leaf
        first, every node whose refcount reaches zero (in paged mode with
        its pages: an ancestor's pages free only with the node). With
        ``prefix_cache`` such a node goes live -> CACHED instead: its K/V,
        pages and index entry stay, stamped for LRU eviction."""
        for nid in path:
            self.node_refs[nid] -= 1
        for nid in reversed(path):
            if self.node_refs[nid] == 0 and self.node_live[nid]:
                if self.tcfg.prefix_cache:
                    if nid not in self.node_cached:
                        self.lru_clock += 1
                        self.node_cached[nid] = self.lru_clock
                    continue
                self.node_live[nid] = False
                self.node_index.pop(self.node_key[nid], None)
                self.node_key[nid] = None
                self.node_len[nid] = 0
                self.seg_checksums.pop(nid, None)
                if self.paged:
                    self.page_alloc.release(self.node_pages.pop(nid, []))

    def _compact_requests(self):
        """Drop retired request-table entries no slot references anymore:
        the table stays O(slots), and a compacted rid reads as dead."""
        referenced = {rid for rid in self.slot_request if rid >= 0}
        for rid in [r for r, req in self.requests.items()
                    if not req["live"] and r not in referenced]:
            del self.requests[rid]

    def release_retired(self, state: ForestState) -> ForestState:
        """Paged mode: empty the page-table rows of every freed trie node,
        in place, so their pages leave the decode kernel's walk; live
        ancestors shared with surviving requests are untouched. The dense
        store has nothing to release (a freed node keeps its bytes until
        the next admission overwrites them; the kernels read only nodes on
        live paths). Returns ``state``."""
        if self.paged:
            for nid in range(self.tcfg.n_nodes):
                if not self.node_live[nid]:
                    state.cache.free_node(nid)
        return state

    # ---- robustness surface ----
    def cancel_request(self, state: ForestState, rid: int) -> ForestState:
        """Deactivate every slot of a LIVE request (preemption / deadline /
        client cancellation); its nodes free through ``retire_requests``,
        shared ancestors survive. A compacted or retired rid is a no-op. A
        request whose packed prefill is pending has no active slot: its
        prefill is aborted instead (``_abort_pending``), its unwritten
        nodes and their pages freed at once."""
        req = self.requests.get(rid)
        if req is None or not req["live"]:
            return state
        if rid in self._pending:
            return self._abort_pending(state, rid)
        return self.deactivate_slots(state, req["slots"])

    def request_sharing(self, rid: int) -> int:
        """How many of this request's trie nodes another live request
        shares (refcount > 1)."""
        req = self.requests.get(rid)
        if req is None:
            return 0
        return sum(1 for nid in req["path"] if self.node_refs[nid] > 1)

    def _live_segments(self):
        # cached nodes are RESIDENT (node_live stays True): checksum- and
        # audit-visible until actually evicted
        return [n for n in range(self.tcfg.n_nodes) if self.node_live[n]]

    def occupancy(self, state: ForestState) -> dict:
        """Live slot count, the pool's pages in paged mode, and the trie
        nodes (and their pages) held resident as cache entries."""
        occ = super().occupancy(state)
        occ["nodes_cached"] = len(self.node_cached)
        if self.paged:
            occ["pages_cached"] = sum(
                len(self.node_pages.get(n, ())) for n in self.node_cached)
        return occ

    def audit_state(self, state: ForestState, extra_tracked=(),
                    verify_checksums: bool = False) -> bool:
        """``PageAllocator.audit`` against the live nodes' page-table rows
        and the host's page mirrors (``extra_tracked``: pages a caller holds
        outside them); with ``verify_checksums`` every live node's KV bytes
        are re-fingerprinted first (a host round-trip per node: on demand,
        not every round). Raises on the first violation."""
        return self._audit_pages(state, self._live_segments(),
                                 self.node_pages if self.paged else {},
                                 extra_tracked, verify_checksums)

    # ---- durable-state serialization (checkpoint/recovery) ----
    def host_state(self) -> dict:
        if self._pending:
            raise RuntimeError(
                "host_state with packed prefills in flight — drain the "
                "pending chunks (step the engine) before snapshotting; "
                "in-flight fresh-KV buffers are not serializable state "
                "(DurableFrontend defers its snapshot until the engine "
                "is quiescent)")
        d = super().host_state()
        d.update({
            "node_live": [bool(x) for x in self.node_live],
            "node_refs": [int(x) for x in self.node_refs],
            # (parent, token tuple) keys flattened for JSON; node_key is
            # the exact inverse and is rebuilt on load
            "node_index": [[int(parent), [int(t) for t in toks], int(nid)]
                           for (parent, toks), nid
                           in self.node_index.items()],
            "slot_request": [int(x) for x in self.slot_request],
            # (rid, entry) pairs: the table is a compacted dict keyed by
            # monotonic rids, not a dense list
            "requests": [[int(rid),
                          {"path": [int(n) for n in r["path"]],
                           "slots": [int(s) for s in r["slots"]],
                           "live": bool(r["live"])}]
                         for rid, r in sorted(self.requests.items())],
            "next_rid": int(self.next_rid),
            "node_len": [int(x) for x in self.node_len],
            # the cached-node set and the LRU clock survive a snapshot, so
            # the eviction order after recovery is bit-identical
            "node_cached": [[int(n), int(stamp)] for n, stamp
                            in sorted(self.node_cached.items())],
            "lru_clock": int(self.lru_clock),
            "prefix_stats": {k: int(v)
                             for k, v in self.prefix_stats.items()},
        })
        if self.paged:
            d["node_pages"] = [[int(n), [int(p) for p in ids]]
                               for n, ids in self.node_pages.items()]
            d["allocator"] = self.page_alloc.state_dict()
        return d

    def load_host_state(self, d: dict):
        super().load_host_state(d)
        self.node_live = [bool(x) for x in d["node_live"]]
        self.node_refs = [int(x) for x in d["node_refs"]]
        self.node_index = {}
        self.node_key = [None] * self.tcfg.n_nodes
        for parent, toks, nid in d["node_index"]:
            key = (int(parent), tuple(int(t) for t in toks))
            self.node_index[key] = int(nid)
            self.node_key[int(nid)] = key
        self.slot_request = [int(x) for x in d["slot_request"]]
        self.requests = {int(rid): {"path": [int(n) for n in r["path"]],
                                    "slots": [int(s) for s in r["slots"]],
                                    "live": bool(r["live"])}
                         for rid, r in d["requests"]}
        self.next_rid = int(d["next_rid"])
        self.last_rid = self.next_rid - 1
        self.node_len = [int(x) for x in d["node_len"]]
        self.node_cached = {int(n): int(stamp)
                            for n, stamp in d["node_cached"]}
        self.lru_clock = int(d["lru_clock"])
        self.prefix_stats = {k: int(v)
                             for k, v in d["prefix_stats"].items()}
        if self.paged:
            self.node_pages = {int(n): [int(p) for p in ids]
                               for n, ids in d["node_pages"]}
            self.page_alloc.load_state_dict(d["allocator"])
        return self
