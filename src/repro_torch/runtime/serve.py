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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.errors import DecodeCapacityExceeded
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache
from repro_torch.core.policy import BifurcationPolicy


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
        if scfg.cache_dtype != "bfloat16":
            raise NotImplementedError(
                f"cache_dtype={scfg.cache_dtype!r} is not ported")
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
            cache = BifurcatedCache.from_prefill(
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
