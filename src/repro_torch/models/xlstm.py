"""xLSTM (sLSTM + mLSTM): the attention-free family's serving path.

xlstm-1.3b: 48 layers in 6 groups of (7 mLSTM + 1 sLSTM). The mLSTM runs
on the chunked linear-attention substrate (matrix memory, scalar gates, the
normaliser tracked as an extra value column): its prefill is one call of
kernel #13 a layer on the card (``linear_scan.chunked_linear_attention``,
dk = dv = expand * d_model / n_heads, 1024 at full width, 1025 columns
with the normaliser: the kernel's wide path, two launches a call), its
decode the one-token recurrence ``linear_attention_decode``, which updates
the layer's (b, nh, hd, hd + 1) fp32 state in place. The sLSTM is a
per-timestep recurrent cell with a per-head block-diagonal recurrence: the
reference runs it as a ``lax.scan`` with no Pallas kernel, the port as a
PyTorch loop over time.

Bifurcated attention is inapplicable (no KV cache): the shared-prefix
analogue is the prefill's final recurrent state broadcast to the samples
(``runtime/serve.ServeEngine._broadcast_state``).

Leaves the reference applies in float32 (``ln``, ``norm_scale``, the
mLSTM's ``w_gates`` and ``gate_bias``, the sLSTM's ``r_rec`` and ``bias``)
stay float32 (``convert.FP32_KEYS``); the matmul weights are cast to the
activation dtype at use, as there. The activation dtype is the embedding
table's (the reference fixes bf16; with bf16 weights, the serving default,
the two agree), as in the hybrid. Training (``train_logits``) is not
ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import cast_weights
from repro_torch.models import blocks
from repro_torch.models.blocks import _silu, apply_norm, init_norm, rms_normalize
from repro_torch.models.linear_scan import (
    chunked_linear_attention,
    linear_attention_decode,
)
from repro_torch.models.transformer import _layer


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    nh = cfg.n_heads
    return d_inner, nh, d_inner // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm_layers(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                      dtype=torch.float32):
    """Seeded random weights of ``n_layers`` stacked mLSTM layers, of the
    reference's shapes and scale; matmul weights in ``dtype``, made one
    layer at a time, the float32 leaves float32."""
    d = cfg.d_model
    d_inner, nh, hd = _dims(cfg)
    dev = gen.device

    def stacked(shape, fan_in):
        out = torch.empty((n_layers, *shape), dtype=dtype, device=dev)
        for i in range(n_layers):
            out[i] = blocks._dense_init(gen, shape, fan_in)
        return out

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": {"scale": torch.ones(n_layers, d, **f32)},
        "up_proj": stacked((d, 2 * d_inner), d),
        "wqkv": stacked((3, nh, hd, hd), hd),
        "w_gates": torch.stack([blocks._dense_init(gen, (d, 2 * nh), d)
                                for _ in range(n_layers)]),
        "gate_bias": torch.tensor([0.0] * nh + [3.0] * nh,   # forget bias
                                  **f32).repeat(n_layers, 1),
        "norm_scale": torch.ones(n_layers, d_inner, **f32),
        "down_proj": stacked((d_inner, d), d_inner),
    }


def _mlstm_qkv(cfg: ModelConfig, p, x):
    """x: (b, n, d) -> q, k, v (b, n, nh, hd), log_f (b, n, nh) fp32, z."""
    d_inner, nh, hd = _dims(cfg)
    b, n = x.shape[:2]
    u = x @ p["up_proj"].to(x.dtype)
    x_in, z = torch.split(u, d_inner, dim=-1)
    xh = x_in.reshape(b, n, nh, hd)
    w = p["wqkv"].to(x.dtype)
    q = torch.einsum("bnhd,hde->bnhe", xh, w[0])
    k = torch.einsum("bnhd,hde->bnhe", xh, w[1]) * hd**-0.5
    v = torch.einsum("bnhd,hde->bnhe", xh, w[2])
    gates = x.float() @ p["w_gates"] + p["gate_bias"]
    i_pre, f_pre = torch.split(gates, nh, dim=-1)             # (b, n, nh)
    log_f = F.logsigmoid(f_pre)
    k = k * torch.sigmoid(i_pre)[..., None].to(k.dtype)  # input gate in k
    return q, k, v, log_f, z


def _mlstm_out(p, x, out, z):
    b, n = x.shape[:2]
    out = rms_normalize(out.reshape(b, n, -1) * _silu(z), p["norm_scale"])
    return x + out @ p["down_proj"].to(x.dtype)


def apply_mlstm_prefill(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """x: (b, n, d) -> (x', the final state (b, nh, hd, hd + 1) fp32), the
    chunked form through kernel #13 on the card."""
    h = rms_normalize(x, p["ln"]["scale"])
    q, k, v, log_f, z = _mlstm_qkv(cfg, p, h)
    out, S = chunked_linear_attention(q, k, v, log_f, chunk=cfg.ssm.chunk,
                                      normalize=True)
    return _mlstm_out(p, x, out, z), S


def apply_mlstm_decode(cfg: ModelConfig, p, x, state):
    """x: (b, 1, d); state: (b, nh, hd, hd + 1) fp32, UPDATED IN PLACE.
    Returns (x', state)."""
    h = rms_normalize(x, p["ln"]["scale"])
    q, k, v, log_f, z = _mlstm_qkv(cfg, p, h)
    out, _ = linear_attention_decode(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                                     state, normalize=True)
    return _mlstm_out(p, x, out, z), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_layers(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                      dtype=torch.float32):
    """As ``init_mlstm_layers``, for ``n_layers`` stacked sLSTM layers."""
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    dev = gen.device

    def stacked(shape, fan_in, dt=dtype):
        out = torch.empty((n_layers, *shape), dtype=dt, device=dev)
        for i in range(n_layers):
            out[i] = blocks._dense_init(gen, shape, fan_in)
        return out

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": {"scale": torch.ones(n_layers, d, **f32)},
        "w_in": stacked((d, 4 * d), d),
        "r_rec": stacked((nh, 4, hd, hd), hd, torch.float32),
        "bias": torch.zeros(n_layers, 4, nh, hd, **f32),
        "out_proj": stacked((d, d), d),
    }


def _slstm_weights(p):
    """The cell's weights in its head-major layout: r_rec (nh, 4, hd, hd)
    as (nh, hd, 4 hd), so that a step's recurrence is one batched product,
    and the bias as (nh, 1, 4 hd) with the forget gate's +3 folded in (the
    reference adds both after the recurrence: the sums differ by rounding
    alone)."""
    nh, _, hd, _ = p["r_rec"].shape
    r = p["r_rec"].permute(0, 2, 1, 3).reshape(nh, hd, 4 * hd)
    bias = p["bias"].clone()
    bias[1] += 3.0
    return r, bias.permute(1, 0, 2).reshape(nh, 1, 4 * hd)


def _slstm_cell(r, pre_t, h_prev, c_prev, h_out=None):
    """One step of the cell, head-major: pre_t (nh, b, 4 hd) fp32, the
    input's pre-activations with the bias added (``_slstm_weights``), gates
    in the order i, f, z, o; h_prev, c_prev (nh, b, hd) fp32. Returns (h,
    c); h written into ``h_out`` when given. Seven launches a step: the
    loop over 8192 steps is launch-bound."""
    hd = h_prev.shape[-1]
    g = torch.baddbmm(pre_t, h_prev, r)                  # pre + h R
    s = torch.sigmoid(g)
    z = torch.tanh(g[..., 2 * hd:3 * hd])
    c = torch.addcmul(s[..., hd:2 * hd] * c_prev, s[..., :hd], z)
    h = torch.mul(s[..., 3 * hd:], torch.tanh(c), out=h_out)
    return h, c


def _slstm_pre(p, x, bias):
    """The input's pre-activations (b, n, d) -> (n, nh, b, 4 hd) fp32, the
    cell's layout, with the bias added."""
    b, n = x.shape[:2]
    nh, hd = bias.shape[0], bias.shape[-1] // 4
    hn = rms_normalize(x, p["ln"]["scale"])
    pre = (hn @ p["w_in"].to(x.dtype)).reshape(b, n, 4, nh, hd).float()
    return pre.permute(1, 3, 0, 2, 4).reshape(n, nh, b, 4 * hd) + bias


def apply_slstm_prefill(cfg: ModelConfig, p, x):
    """x: (b, n, d) -> (x', (h, c) the final states (b, nh, hd) fp32): the
    cell stepped over time in a loop (the reference's ``lax.scan``)."""
    b, n, d = x.shape
    r, bias = _slstm_weights(p)
    pre = _slstm_pre(p, x, bias)
    nh, hd = bias.shape[0], d // bias.shape[0]
    hs = torch.empty(n, nh, b, hd, dtype=torch.float32, device=x.device)
    h = torch.zeros(nh, b, hd, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    for t in range(n):
        h, c = _slstm_cell(r, pre[t], h, c, h_out=hs[t])
    out = hs.permute(2, 0, 1, 3).reshape(b, n, d).to(x.dtype)
    return (x + out @ p["out_proj"].to(x.dtype),
            (h.transpose(0, 1).contiguous(), c.transpose(0, 1).contiguous()))


def apply_slstm_decode(cfg: ModelConfig, p, x, state):
    """x: (b, 1, d); state: (h, c), each (b, nh, hd) fp32, UPDATED IN
    PLACE. Returns (x', state)."""
    b, _, d = x.shape
    h_prev, c_prev = state
    r, bias = _slstm_weights(p)
    h, c = _slstm_cell(r, _slstm_pre(p, x, bias)[0], h_prev.transpose(0, 1),
                       c_prev.transpose(0, 1))
    h_prev.copy_(h.transpose(0, 1))
    c_prev.copy_(c.transpose(0, 1))
    out = h_prev.reshape(b, 1, d).to(x.dtype)
    return x + out @ p["out_proj"].to(x.dtype), state


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class XLSTMModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "xlstm" or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: not an xLSTM config (family "
                             f"{cfg.family!r})")
        every = cfg.ssm.slstm_every or 8
        if cfg.n_layers % every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"groups of {every}")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // every
        self.m_per_group = every - 1

    # ---- params ----
    def init(self, seed: int = 0, *, device="cuda", dtype=torch.bfloat16):
        """Seeded random weights of the reference's shapes and scale;
        matmul weights in ``dtype``, the leaves the reference applies in
        float32 kept so. Runs on ``device`` (CUDA unless the caller says
        "cpu")."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        G, M, d = self.n_groups, self.m_per_group, cfg.d_model
        mlstm = init_mlstm_layers(cfg, gen, G * M, dtype)

        def regroup(tree):  # (G * M, ...) -> (G, M, ...)
            return {k: (regroup(v) if isinstance(v, dict) else
                        v.reshape(G, M, *v.shape[1:]))
                    for k, v in tree.items()}

        params = {
            "embed": blocks._dense_init(gen, (cfg.padded_vocab, d), d).to(dtype),
            "mlstm": regroup(mlstm),
            "slstm": init_slstm_layers(cfg, gen, G, dtype),
            "final_norm": init_norm(cfg, (d,), dev),
            "lm_head": blocks._dense_init(
                gen, (cfg.padded_vocab, d), d).to(dtype),
        }
        return cast_weights(params, dtype)

    # ---- serving (a state cache; no KV) ----
    def cache_spec(self, batch):
        """{name: (shape, dtype)} of a cache for ``batch`` samples."""
        cfg = self.cfg
        _, nh, hd = _dims(cfg)
        s_hd = cfg.d_model // cfg.n_heads
        G = self.n_groups
        return {
            "mlstm": ((G, self.m_per_group, batch, nh, hd, hd + 1),
                      torch.float32),
            "slstm_h": ((G, batch, nh, s_hd), torch.float32),
            "slstm_c": ((G, batch, nh, s_hd), torch.float32),
        }

    def init_cache(self, batch, capacity=0, *, device="cuda"):
        """A zero cache for ``batch`` samples (``capacity`` is not read: the
        states do not grow with the context)."""
        dev = resolve_device(device)
        cache = {name: torch.zeros(shape, dtype=dt, device=dev)
                 for name, (shape, dt) in self.cache_spec(batch).items()}
        cache["position"] = 0
        return cache

    def _layers(self, params):
        """("m", (group, index), params) for every mLSTM layer and ("s",
        group, params) for every sLSTM layer, in order."""
        for gi in range(self.n_groups):
            for mi in range(self.m_per_group):
                yield "m", (gi, mi), _layer(params["mlstm"], (gi, mi))
            yield "s", gi, _layer(params["slstm"], gi)

    def prefill(self, params, tokens):
        """The chunk-parallel form, keeping every layer's final state.
        Returns (last-position logits (b, V), cache): ``cache`` is
        {"mlstm": (G, M, b, nh, hd, hd + 1), "slstm_h" / "slstm_c": (G, b,
        nh, d / nh), all fp32, "position": n}."""
        cfg = self.cfg
        b, n = tokens.shape
        x = params["embed"][tokens]
        m_states, s_h, s_c = [], [], []
        for kind, _, lp in self._layers(params):
            if kind == "m":
                x, S = apply_mlstm_prefill(cfg, lp, x)
                m_states.append(S)
            else:
                x, (h, c) = apply_slstm_prefill(cfg, lp, x)
                s_h.append(h)
                s_c.append(c)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = blocks.unembed(cfg, params, x[:, -1:])[:, 0]
        cache = {
            "mlstm": torch.stack(m_states).reshape(
                self.n_groups, self.m_per_group, *m_states[0].shape),
            "slstm_h": torch.stack(s_h),
            "slstm_c": torch.stack(s_c),
            "position": n,
        }
        return logits, cache

    def decode_step(self, params, cache, tokens, *, impl: str = "einsum"):
        """tokens: (b, 1). Returns (logits (b, 1, V), cache'): every state
        is written in place, so cache' shares its tensors with ``cache``.
        ``impl`` is the engine's attention choice; xLSTM has no attention
        and does not read it."""
        cfg = self.cfg
        x = params["embed"][tokens]
        for kind, at, lp in self._layers(params):
            if kind == "m":
                x, _ = apply_mlstm_decode(cfg, lp, x, cache["mlstm"][at])
            else:
                x, _ = apply_slstm_decode(
                    cfg, lp, x, (cache["slstm_h"][at], cache["slstm_c"][at]))
        x = apply_norm(cfg, params["final_norm"], x)
        logits = blocks.unembed(cfg, params, x)
        return logits, {**cache,
                        "position": cache["position"] + tokens.shape[1]}
