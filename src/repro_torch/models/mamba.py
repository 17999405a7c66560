"""Mamba2 (SSD) layer on the chunked linear-attention substrate.

The selective scan is evaluated with the chunkwise SSD decomposition
(scalar-per-head decay == GLA with scalar gates): on the card one launch of
kernel #13 per layer (``linear_scan.chunked_linear_attention``). The
depthwise causal conv (width 4) runs in float32 outside any kernel, as the
reference computes it.

Leaves the reference applies in float32 (``ln.scale``, ``norm_scale``,
``A_log``, ``dt_bias``, ``conv_w``, ``conv_b``) stay float32 here
(``convert.FP32_KEYS``); the matmul weights (``in_proj``, ``out_proj``) and
``D`` are cast to the activation dtype at use, as there. The decode path
updates the layer's recurrent state IN PLACE.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _dense_init, _silu, rms_normalize
from repro_torch.models.linear_scan import (
    chunked_linear_attention,
    linear_attention_decode,
)


def mamba_dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = ssm.n_heads or d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.state_dim


def init_mamba_layer(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                     dtype=torch.float32):
    """Seeded random weights of ``n_layers`` stacked Mamba2 layers, of the
    reference's shapes and scale; matmul weights in ``dtype``, made one
    layer at a time (no float32 copy of a whole stack), the rest float32."""
    d = cfg.d_model
    d_inner, nh, state = mamba_dims(cfg)
    conv_ch = d_inner + 2 * state
    proj_out = 2 * d_inner + 2 * state + nh  # z, x, B, C, dt
    dev = gen.device

    def stacked(shape, fan_in):
        out = torch.empty((n_layers, *shape), dtype=dtype, device=dev)
        for i in range(n_layers):
            out[i] = _dense_init(gen, shape, fan_in)
        return out

    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": {"scale": torch.ones(n_layers, d, **f32)},
        "in_proj": stacked((d, proj_out), d),
        "conv_w": torch.randn(n_layers, cfg.ssm.conv_width, conv_ch,
                              generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros(n_layers, conv_ch, **f32),
        "A_log": torch.zeros(n_layers, nh, **f32),  # A = -exp(A_log) = -1
        "D": torch.ones(n_layers, nh, **f32),
        "dt_bias": torch.zeros(n_layers, nh, **f32),
        "norm_scale": torch.ones(n_layers, d_inner, **f32),
        "out_proj": stacked((d_inner, d), d_inner),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in float32. x: (b, n, ch); w: (width, ch):
    out[t] = b + sum_i w[i] x[t - (width - 1) + i], x zero before 0. Written
    as width multiply-adds of shifted views, so no convolution library (and
    no TF32 path in it) decides the precision."""
    width = w.shape[0]
    n = x.shape[1]
    xf, wf = x.float(), w.float()
    out = torch.addcmul(b.float(), xf, wf[width - 1])
    for i in range(width - 1):
        s = width - 1 - i
        if s < n:
            out[:, s:].addcmul_(xf[:, :n - s], wf[i])
    return out.to(x.dtype)


def _mamba_inner(cfg: ModelConfig, p, x: torch.Tensor):
    """Project and split into z, xBC and dt (shared by train and decode)."""
    d_inner, nh, state = mamba_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    return torch.split(proj, [d_inner, d_inner + 2 * state, nh], dim=-1)


def _ssd_operands(cfg: ModelConfig, p, xbc, dt):
    """From the conv'd xBC and the raw dt: xs (b, n, nh, hd), q/k as
    head-broadcast views of C/B (b, n, nh, state), v and the log-decay."""
    d_inner, nh, state = mamba_dims(cfg)
    hd = d_inner // nh
    xs, B, C = torch.split(xbc, [d_inner, state, state], dim=-1)
    b, n = xs.shape[:2]
    dtf = F.softplus(dt.float() + p["dt_bias"])               # (b, n, nh)
    log_decay = -torch.exp(p["A_log"]) * dtf                   # <= 0
    xs = xs.reshape(b, n, nh, hd)
    v = xs * dtf[..., None].to(xs.dtype)
    q = C[:, :, None, :].expand(b, n, nh, state)
    k = B[:, :, None, :].expand(b, n, nh, state)
    return xs, q, k, v, log_decay


def _mamba_out(cfg: ModelConfig, p, x, out, xs, z):
    d_inner = mamba_dims(cfg)[0]
    b, n = x.shape[:2]
    out = out + xs * p["D"][:, None].to(xs.dtype)
    out = rms_normalize(out.reshape(b, n, d_inner) * _silu(z), p["norm_scale"])
    return x + out @ p["out_proj"].to(x.dtype)


def apply_mamba_prefill(cfg: ModelConfig, p, x: torch.Tensor):
    """One Mamba2 layer over a whole sequence: returns (y, final SSD state
    (b, nh, state, hd) fp32, conv state (b, width - 1, ch) bf16: the last
    width - 1 pre-conv xBC rows)."""
    h = rms_normalize(x, p["ln"]["scale"])
    z, xbc_pre, dt = _mamba_inner(cfg, p, h)
    xbc = _silu(_causal_conv(xbc_pre, p["conv_w"], p["conv_b"]))
    xs, q, k, v, log_decay = _ssd_operands(cfg, p, xbc, dt)
    out, S = chunked_linear_attention(q, k, v, log_decay, chunk=cfg.ssm.chunk)
    conv_state = xbc_pre[:, -(cfg.ssm.conv_width - 1):].to(torch.bfloat16)
    return _mamba_out(cfg, p, x, out, xs, z), S, conv_state


def apply_mamba_train(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return apply_mamba_prefill(cfg, p, x)[0]


def mamba_state_spec(cfg: ModelConfig, n_layers: int, batch: int):
    """{name: (shape, dtype)} of the recurrent state of ``n_layers``."""
    d_inner, nh, state = mamba_dims(cfg)
    hd = d_inner // nh
    conv_ch = d_inner + 2 * state
    width = cfg.ssm.conv_width
    return {
        "ssm": ((n_layers, batch, nh, state, hd), torch.float32),
        "conv": ((n_layers, batch, width - 1, conv_ch), torch.bfloat16),
    }


def mamba_state_init(cfg: ModelConfig, n_layers: int, batch: int,
                     device="cpu"):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype)
            in mamba_state_spec(cfg, n_layers, batch).items()}


def apply_mamba_decode(cfg: ModelConfig, p, x: torch.Tensor, lstate: dict
                       ) -> Tuple[torch.Tensor, dict]:
    """x: (b, 1, d); lstate: {'ssm': (b,nh,state,hd), 'conv': (b,w-1,ch)},
    both updated IN PLACE and returned."""
    d_inner, nh, state = mamba_dims(cfg)
    hd = d_inner // nh
    b = x.shape[0]
    h = rms_normalize(x, p["ln"]["scale"])
    z, xbc, dt = _mamba_inner(cfg, p, h)

    conv_buf = torch.cat([lstate["conv"], xbc.to(torch.bfloat16)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", conv_buf.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xbc_t = _silu(conv_out).to(x.dtype)                           # (b, ch)
    lstate["conv"].copy_(conv_buf[:, 1:])

    xs, B, C = torch.split(xbc_t, [d_inner, state, state], dim=-1)
    dt_t = F.softplus(dt[:, 0].float() + p["dt_bias"])             # (b, nh)
    log_decay = -torch.exp(p["A_log"]) * dt_t
    xs = xs.reshape(b, nh, hd)
    v = xs * dt_t[..., None].to(xs.dtype)
    q = C[:, None, :].expand(b, nh, state)
    k = B[:, None, :].expand(b, nh, state)
    out, _ = linear_attention_decode(q, k, v, log_decay, lstate["ssm"])
    out = out + xs * p["D"][:, None].to(xs.dtype)
    out = rms_normalize(out.reshape(b, 1, d_inner) * _silu(z), p["norm_scale"])
    return x + out @ p["out_proj"].to(x.dtype), lstate
