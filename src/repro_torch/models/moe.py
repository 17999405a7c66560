"""Mixture-of-Experts FFN with GShard/T5X-style capacity-bounded dispatch.

Top-k routing with a dense one-hot dispatch einsum: tokens are re-grouped
into (G, S) dispatch groups of ``group_size`` tokens so that the
(G, S, E, C) dispatch tensor stays small; expert weights carry an (E, d, f)
layout. A Switch-style load-balancing aux loss is returned beside the
output. Applies to dbrx-132b (16 experts, top 4) and mixtral-8x7b (8, top
2); the attention of those models is the dense family's, bifurcated
attention included.

The reference computes the expert products outside any Pallas kernel, and
so does the port: plain ``torch.einsum`` (batched GEMMs). Routing is fp32
(the ``router`` leaf is fp32, ``convert.FP32_KEYS``). Top-k is a stable
descending sort: ``lax.top_k``'s order, lower expert index first on ties
(the zero rows that pad the last group tie on every expert), and the k
order decides which (token, k) choices a full expert drops.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init, _silu


def init_moe(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
             dtype=None):
    """Stacked (L, ...) MoE params: the router fp32 (d, E); the expert
    weights drawn one layer at a time and cast to ``dtype`` at once (None:
    kept fp32), so that the fp32 peak is one layer's (E, d, f) leaf."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def experts(shape, fan_in):
        out = torch.empty((n_layers, *shape), dtype=dtype or torch.float32,
                          device=gen.device)
        for i in range(n_layers):
            out[i] = _dense_init(gen, shape, fan_in)
        return out

    return {
        "router": _dense_init(gen, (n_layers, d, e), d),
        "experts_wi_gate": experts((e, d, f), d),
        "experts_wi_up": experts((e, d, f), d),
        "experts_wo": experts((e, f, d), f),
    }


def route(router, x2, top_k):
    """fp32 routing of tokens x2 (..., d): (probs (..., E), the top k's
    gate values renormalised over them and their expert ids, (..., K))."""
    probs = torch.softmax(x2.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _experts(params, xe, dtype, spec_in, spec_out):
    """The expert FFN (swiglu) over expert-major tokens ``xe``: the
    einsums of its input side ``spec_in`` (e.g. "gecd,edf->gecf") and of
    its output side ``spec_out`` ("gecf,efd->gecd")."""
    gate = torch.einsum(spec_in, xe, params["experts_wi_gate"].to(dtype))
    up = torch.einsum(spec_in, xe, params["experts_wi_up"].to(dtype))
    return torch.einsum(spec_out, _silu(gate) * up,
                        params["experts_wo"].to(dtype))


def queue_positions(gate_idx, n_experts):
    """The place of each (token, k) choice of ``gate_idx`` (G, S, K) in its
    expert's queue: the exclusive cumsum over the (S*K) order, token major
    and k minor; and the one-hot (G, S, K, E) of the choices."""
    g, s, k = gate_idx.shape
    onehot = F.one_hot(gate_idx, n_experts)
    flat = onehot.reshape(g, s * k, n_experts)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    return (pos_in_expert * flat).sum(-1).reshape(g, s, k), onehot


def capacity(moe, group_tokens: int) -> int:
    """Slots per expert and dispatch group of ``group_tokens`` tokens."""
    return max(int(group_tokens * moe.top_k * moe.capacity_factor
                   / moe.n_experts), 4)


def dispatch_groups(moe, x):
    """x (b, s, d) as (G, S, d) dispatch groups, zero rows padding the
    last one."""
    b, s, d = x.shape
    sg = min(moe.group_size, s)
    xt = x.reshape(b * s, d)
    return F.pad(xt, (0, 0, 0, (-b * s) % sg)).reshape(-1, sg, d)


def apply_moe(cfg: ModelConfig, params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d), aux_loss ())."""
    moe = cfg.moe
    b, s, d = x.shape
    dtype = x.dtype
    e = moe.n_experts
    xg = dispatch_groups(moe, x)

    probs, gate_vals, gate_idx = route(params["router"], xg, moe.top_k)
    # Switch-style load-balance aux loss over the whole batch
    density = probs.mean(dim=(0, 1))
    frac = F.one_hot(probs.argmax(-1), e).float().mean(dim=(0, 1))
    aux_loss = e * torch.sum(density * frac) * moe.router_aux_weight

    # top-k assignment with capacity: a choice past its expert's capacity
    # is dropped
    cap = capacity(moe, xg.shape[1])
    pos, onehot = queue_positions(gate_idx, e)
    keep = pos < cap

    # dispatch / combine (G, S, E, C); a dropped choice's one-hot is zero
    pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)
              ).float() * keep[..., None]                    # (G,S,K,C)
    expert_oh = onehot.float()
    dispatch = torch.einsum("gske,gskc->gsec", expert_oh, pos_oh)
    combine = torch.einsum("gske,gskc->gsec",
                           expert_oh * gate_vals[..., None], pos_oh)

    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(dtype), xg)
    ye = _experts(params, xe, dtype, "gecd,edf->gecf", "gecf,efd->gecd")
    out = torch.einsum("gsec,gecd->gsd", combine.to(dtype), ye)
    out = out.reshape(-1, d)[:b * s]
    return out.reshape(b, s, d), aux_loss


def moe_decode(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Decode-time MoE: per-token top-k without capacity drops. x: (b, n,
    d) with few tokens. As the reference, every expert is computed on the
    tokens (each expert's weights read once a call) and the k selected
    ones are weighted in; an unselected expert's weight is exactly 0. The
    tokens are handed to each expert (E, T, d), so the products are
    batched GEMMs over the (E, d, f) weights as stored (the reference's
    "td,edf->tef" would make torch.einsum copy every expert's weights into
    a (d, E*f) matrix at each call)."""
    moe = cfg.moe
    b, n, d = x.shape
    dtype = x.dtype
    e = moe.n_experts
    xt = x.reshape(b * n, d)
    _, gate_vals, gate_idx = route(params["router"], xt, moe.top_k)
    w = (F.one_hot(gate_idx, e).float() * gate_vals[..., None]).sum(1)  # (T, E)
    ye = _experts(params, xt.expand(e, b * n, d).contiguous(), dtype,
                  "etd,edf->etf", "etf,efd->etd")
    out = torch.einsum("te,etd->td", w.to(dtype), ye)
    return out.reshape(b, n, d)
