#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its result lines:

  1. print the card's name and power limit (nvidia-smi), build the CUDA
     kernels from src/repro_torch/kernels/csrc with nvcc;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (g=8 kv heads, 64 query rows = 32 samples x 2 query
     heads per kv head, hd=128, m_c=8192, 32 x 24 decode slots, bf16), once
     with random inputs and once with a partly masked decode arm that
     carries most of the softmax mass, and at ragged shapes (m_c off the
     block size, two fresh positions per sample, rows off the row tile,
     hd=80, and fp32, which runs the SIMT copy of the kernels, not the
     tensor-core one that serves bf16). Every gate is max |kernel - plain|
     <= tol x max |plain| (bf16 2e-2, fp32 1e-5), and the script shows that
     plain versions with the decode arm dropped, its mask ignored or another
     sample's slots read miss that gate by far;
  3. serve internlm2-1.8b at its published width (seeded random weights)
     with ServeEngine.generate: bifurcated cache, fused kernel, batch 32,
     context 8192, 16 steps. The fused kernel must launch 24 layers x 15
     decode steps times. Then, after 8 more decode steps so that 9 decode
     slots are live, one decode step on the kernel path against the plain
     impl="flash" path, layer by layer on the same input and for the whole
     step, and the two-pass dispatch (the partials kernel) over the served
     cache against the fused one;
  4. time each kernel at the main path's shapes beside its bound, its plain
     version and, as a yardstick only, one scaled_dot_product_attention call
     computing the same function (the port never calls it);
  5. print the kernels' JSON line, then the result line, last.

Imports torch and the port only; needs a checkout of the repository (it
builds the kernels from its sources) and a CUDA device.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense tensor-core bf16
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gap(got, want):
    """max |got - want| and max |want|, as floats."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def within(got, want, tol=TOL["bfloat16"]):
    """The gate of every comparison here: max |got - want| <= tol x
    max |want|, so it scales with the outputs (one bf16 ulp is 2^-8 of a
    value); returns (ok, max abs error, relative error)."""
    err, ref = gap(got, want)
    return err <= tol * ref, err, err / ref


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"built {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    # ptxas' report, one line per kernel instance: registers, spills, smem
    name = None
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(bf16|f32)_decode_kernelILi(\d+)ELb(\d)E", line)
            name = m and (f"{m.group(1)} hd={m.group(2)} "
                          f"{'fused' if m.group(3) == '1' else 'partials'}")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(g, b, p, n, hd, m_c, c_d, dtype, seed, masked=False,
                  dec_boost=0.0):
    """Random kernel operands. ``masked``: each sample has 1..c_d live decode
    slots, else all c_d. ``dec_boost`` > 0 builds each sample's decode keys
    as that multiple of its query rows' mean (plus noise), so its live slots'
    logits stand ~17 above the context's and the decode arm carries most of
    the softmax mass; its dead slots' logits are as large."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows, ld = b * p * n, b * c_d

    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    lens = torch.randint(1, c_d + 1, (b,), generator=gen, device=DEVICE)
    if not masked:
        lens.fill_(c_d)
    live = torch.arange(c_d, device=DEVICE)[None, :] < lens[:, None]
    bias = torch.where(live.reshape(1, ld), 0.0, -1e30).to(torch.float32)
    q, kd = r(g, rows, hd), r(g, ld, hd)
    if dec_boost:
        q_mean = q.reshape(g, b, p * n, 1, hd).mean(2)
        kd = (dec_boost * q_mean + 0.5 * kd.reshape(g, b, c_d, hd)
              ).reshape(g, ld, hd)
    return dict(q=q.to(dtype), kc=r(g, m_c, hd).to(dtype),
                vc=r(g, m_c, hd).to(dtype), kd=kd.to(dtype),
                vd=r(g, ld, hd).to(dtype), bias=bias, c_d=c_d, pn=p * n,
                scale=hd**-0.5, lens=lens)


def check_case(name, x, dtype_name):
    """Kernel vs plain on one case; returns the max abs errors of the fused
    output and of the partials' normalised output acc / l."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    tol = TOL[dtype_name]
    args = (x["q"], x["kc"], x["vc"], x["kd"], x["vd"], x["bias"])
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    out_k = bd.fused_bifurcated_decode(*args, **kw)
    out_p = bd.fused_bifurcated_decode_plain(*args, **kw)
    acc_k, m_k, l_k = bd.context_flash_partials(*args[:3], scale=x["scale"])
    acc_p, m_p, l_p = bd.context_flash_partials_plain(*args[:3],
                                                      scale=x["scale"])
    torch.cuda.synchronize()
    ok_f, err_f, rel_f = within(out_k, out_p, tol)
    # partials: normalised by their own sumexp, compared as the output;
    # m and l are fp32 sums of the same products in another order
    ok_a, err_a, rel_a = within(acc_k / l_k[..., None],
                                acc_p / l_p[..., None], tol)
    err_m = ((m_k - m_p).abs() / (1 + m_p.abs())).max().item()
    err_l = ((l_k - l_p).abs() / l_p.abs()).max().item()
    print(f"check {name}: fused max_abs_err={err_f:.3e} ({rel_f:.1e} of "
          f"max |out|), partials acc/l {err_a:.3e} ({rel_a:.1e}), m rel "
          f"{err_m:.3e}, l rel {err_l:.3e} (gates: {tol:g} of max |out|; "
          f"m, l 1e-4)")
    check(ok_f, f"{name}: fused kernel disagrees with its plain version")
    check(ok_a and err_m <= 1e-4 and err_l <= 1e-4,
          f"{name}: partials kernel disagrees with its plain version")
    check(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite")
    return err_f, err_a


def check_gate_sensitivity(name, x):
    """On a case whose decode arm carries most of the softmax mass: the
    share it carries, and the error against the plain version of three
    plain versions that each get the decode arm wrong. Each must miss the
    kernel gate (2e-2 of max |out|) by at least tenfold."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    q, kc, vc, kd, vd, bias = (x[k] for k in ("q", "kc", "vc", "kd", "vd",
                                               "bias"))
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    want = bd.fused_bifurcated_decode_plain(q, kc, vc, kd, vd, bias, **kw)
    acc, m, l = bd.context_flash_partials_plain(q, kc, vc, scale=x["scale"])
    # the decode arm's share of each row's softmax mass, from the plain
    # context partials and each row's own live slots
    g, rows, hd = q.shape
    b, c_d = rows // x["pn"], x["c_d"]
    s = torch.einsum("grh,gbch->grbc", q.float(),
                     kd.float().reshape(g, b, c_d, hd)) * x["scale"]
    own = s[:, torch.arange(rows, device=DEVICE),
            torch.arange(rows, device=DEVICE) // x["pn"]]      # (g, rows, c_d)
    own = own + bias.reshape(b, c_d).repeat_interleave(x["pn"], 0)
    top = torch.maximum(m, own.amax(-1))
    dec = torch.exp(own - top[..., None]).sum(-1)
    share = (dec / (dec + l * torch.exp(m - top))).min().item()
    shifted = dict(kd=kd.roll(c_d, 1), vd=vd.roll(c_d, 1),
                   bias=bias.roll(c_d, 1))
    faults = {
        "decode arm dropped": (acc / l[..., None]).to(q.dtype),
        "slot mask ignored": bd.fused_bifurcated_decode_plain(
            q, kc, vc, kd, vd, torch.zeros_like(bias), **kw),
        "another sample's slots": bd.fused_bifurcated_decode_plain(
            q, kc, vc, shifted["kd"], shifted["vd"], shifted["bias"], **kw),
    }
    rels = {k: within(v, want)[2] for k, v in faults.items()}
    print(f"check {name}: decode arm carries >= {share:.3f} of every row's "
          f"softmax mass; a faulty version's error / max |out|: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    check(share >= 0.5, f"{name}: the decode arm does not dominate")
    for k, v in rels.items():
        check(v >= 10 * TOL["bfloat16"], f"{name}: the gate misses '{k}'")


def check_kernels():
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    main = "g=8 rows=64 hd=128 m_c=8192 ld=768 bf16"
    errs = check_case(f"main {main}",
                      kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=0),
                      "bfloat16")
    dominant = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=6,
                             masked=True, dec_boost=3.0)
    check_gate_sensitivity(f"main {main} decode-dominant masked", dominant)
    errs = [max(a, b) for a, b in zip(errs, check_case(
        f"main {main} decode-dominant masked", dominant, "bfloat16"))]
    ragged = [
        ("m_c=8191 masked-arm bf16", (8, 32, 2, 1, 128, 8191, 24, bf16, 1)),
        ("n=2 p=2 m_c=1000 bf16", (8, 8, 2, 2, 128, 1000, 5, bf16, 2)),
        ("rows=6 g=2 m_c=77 bf16", (2, 3, 2, 1, 128, 77, 3, bf16, 3)),
        ("hd=80 rows=96 m_c=700 bf16", (8, 48, 2, 1, 80, 700, 9, bf16, 4)),
        ("hd=128 m_c=2049 n=2 fp32 (SIMT copy, not the served bf16 kernel)",
         (8, 8, 2, 2, 128, 2049, 6, f32, 5)),
    ]
    for name, (g, b, p, n, hd, m_c, c_d, dt, seed) in ragged:
        x = kernel_inputs(g, b, p, n, hd, m_c, c_d, dt, seed, masked=True)
        check_case(name, x, "bfloat16" if dt == bf16 else "float32")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the serving path at the published width
# ---------------------------------------------------------------------------

BATCH, CONTEXT, STEPS = 32, 8192, 16
WARM_STEPS = 8      # decode steps before the step compared across paths


def serve():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.kernels.ops import bifurcated_decode_attention
    from repro_torch.models import blocks, get_model
    from repro_torch.models.transformer import _layer
    from repro_torch.runtime.serve import ServeEngine

    cfg = get_config("internlm2-1.8b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
          f"h={cfg.n_heads} g={cfg.n_kv_heads} hd={cfg.kq_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.padded_vocab}: {n_params / 1e9:.3f} B "
          f"params, init {time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(batch=BATCH, context_len=CONTEXT,
                       decode_capacity=max(16, STEPS + 8), bifurcated=True,
                       use_kernel=True)
    engine = ServeEngine(model, cfg, scfg)
    check(engine.should_bifurcate(BATCH, CONTEXT), "policy did not bifurcate")
    rng = np.random.RandomState(0)
    ctx = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, CONTEXT)),
                          device=DEVICE)

    # warm-up generate (allocator, cuBLAS handles), then the counted run
    engine.generate(params, ctx, n_steps=2)
    torch.cuda.synchronize()
    bd.fused_bifurcated_decode.launches = 0
    bd.context_flash_partials.launches = 0
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_bifurcated_decode": bd.fused_bifurcated_decode.launches,
                "context_flash_partials": bd.context_flash_partials.launches}
    print(f"serve: generate launches {launches}")
    check(launches["fused_bifurcated_decode"] == cfg.n_layers * (STEPS - 1),
          f"fused kernel launched {launches['fused_bifurcated_decode']} "
          f"times, want {cfg.n_layers} x {STEPS - 1}")
    toks, lps = result.tokens, result.logprobs
    check(tuple(toks.shape) == (BATCH, STEPS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()), "logprobs")

    # prefill alone, then WARM_STEPS decode steps so that several decode
    # slots are live, then one decode step: kernel path vs plain flash path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, cache = engine.prefill_shared(params, ctx, BATCH)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_ms = (wall - prefill_s) / (STEPS - 1) * 1e3
    print(f"serve: generate {wall * 1e3:.1f} ms = prefill {prefill_s * 1e3:.1f}"
          f" ms + {STEPS - 1} decode steps at {decode_ms:.2f} ms/step")
    for t in range(WARM_STEPS):
        _, cache = model.decode_step(params, cache, result.tokens[:, t:t + 1],
                                     impl="kernel")
    tok = result.tokens[:, WARM_STEPS:WARM_STEPS + 1]

    def fresh(c):
        return dataclasses.replace(c, k_dec=c.k_dec.clone(),
                                   v_dec=c.v_dec.clone())

    # Layer by layer, three residual streams: the kernel path, the plain
    # flash path, and the kernel path on the kernels' plain versions. On the
    # kernel stream's own layer input, its attention output must be within
    # 2e-2 of max |out| of the other two. Each stream's distance to the
    # flash stream shows how the rounding of two correct bf16 paths grows
    # over the layers (the witness for the whole-step gate below).
    c = fresh(cache)
    position = c.context_len + c.dec_length
    on_cuda = bd._on_cuda

    def attn(i, layer, h, impl, plain=False):
        lc = {"k_ctx": c.k_ctx[i], "v_ctx": c.v_ctx[i],
              "k_dec": c.k_dec[i].clone(), "v_dec": c.v_dec[i].clone()}
        if plain:   # route the wrappers to their plain versions
            bd._on_cuda = lambda *t: False
        try:
            return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                           position=position, bifurcated=True,
                                           impl=impl)
        finally:
            bd._on_cuda = on_cuda

    def mlp(layer, x):
        return x + blocks.apply_mlp(cfg, layer["mlp"],
                                    blocks.apply_norm(cfg, layer["ln2"], x))

    x0 = model._embed(params, tok)
    xs = {"kernel": x0, "flash": x0, "plain": x0}
    rel_lf = rel_lp = 0.0
    growth = {"kernel": [], "plain": []}
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        hs = {k: blocks.apply_norm(cfg, layer["ln1"], x) for k, x in xs.items()}
        o_k = attn(i, layer, hs["kernel"], "kernel")
        for impl, plain, name in (("flash", False, "flash"),
                                  ("kernel", True, "plain")):
            ok, _, rel = within(o_k, attn(i, layer, hs["kernel"], impl, plain))
            check(ok, f"layer {i}: kernel attention disagrees with {name} "
                      f"({rel:.2e} of max |out|)")
            if name == "flash":
                rel_lf = max(rel_lf, rel)
            else:
                rel_lp = max(rel_lp, rel)
        xs = {"kernel": mlp(layer, xs["kernel"] + o_k),
              "flash": mlp(layer, xs["flash"] + attn(i, layer, hs["flash"],
                                                      "flash")),
              "plain": mlp(layer, xs["plain"] + attn(i, layer, hs["plain"],
                                                      "kernel", plain=True))}
        for k in growth:
            growth[k].append(within(xs[k], xs["flash"])[2])
    print(f"serve: {c.dec_length + 1} live decode slots; per-layer attention "
          f"on the kernel stream's input, kernel vs flash {rel_lf:.2e} and vs "
          f"plain versions {rel_lp:.2e} of max |out| (gate 2e-2, "
          f"{cfg.n_layers} layers)")
    for k, v in growth.items():
        print(f"serve: residual stream of the {k} path vs the flash path after"
              f" each layer, max |diff| / max |x|: "
              + " ".join(f"{e:.1e}" for e in v))

    # The whole step: 24 bf16 layers apart, two correct paths differ by a few
    # percent of the largest logit (the growth printed above), so the kernel
    # path must be within 2e-2 of the largest logit of the flash path, or no
    # farther from it than the kernels' plain versions are, with 50% to
    # spare.
    lk, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
    lf, _ = model.decode_step(params, fresh(cache), tok, impl="flash")
    bd._on_cuda = lambda *t: False
    try:
        lp, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
    finally:
        bd._on_cuda = on_cuda
    torch.cuda.synchronize()
    live = lf.abs() < 1e29
    for other in (lk, lp):
        check(bool((other.abs() < 1e29).eq(live).all()), "padded vocab logits")
    check(bool(torch.isfinite(lk.float()[live]).all()), "non-finite logits")
    err_kf, scale = gap(lk[live], lf[live])
    err_pf, _ = gap(lp[live], lf[live])
    err_kp, _ = gap(lk[live], lp[live])
    print(f"serve: decode-step logits, max_abs_err kernel path vs flash "
          f"{err_kf:.3e}, plain versions vs flash {err_pf:.3e}, kernel path "
          f"vs plain versions {err_kp:.3e}; max |logit| {scale:.3f} (gate "
          f"max(2e-2 x max |logit|, 1.5 x plain vs flash))")
    check(err_kf <= max(TOL["bfloat16"] * scale, 1.5 * err_pf),
          "kernel path logits disagree with the flash path")
    profile_step(model, params, fresh(cache), tok)

    # the two-pass dispatch over the served cache: one partials launch per
    # layer, merged on the host; it must equal the fused kernel's result
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    g, p, hd = cfg.n_kv_heads_padded, cfg.n_heads // cfg.n_kv_heads, cfg.kq_dim
    q = torch.randn(BATCH, g, p, 1, hd, generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    c_d = cache.decode_capacity
    k_dec = torch.randn(cfg.n_layers, BATCH, c_d, g, hd, generator=gen,
                        device=DEVICE).to(torch.bfloat16)
    v_dec = torch.randn_like(k_dec)
    mask = (torch.arange(c_d, device=DEVICE)[None, :]
            < torch.randint(1, c_d + 1, (BATCH, 1), generator=gen,
                            device=DEVICE))
    bd.fused_bifurcated_decode.launches = 0
    bd.context_flash_partials.launches = 0
    two_pass = [bifurcated_decode_attention(
        q, cache.k_ctx[i], cache.v_ctx[i], k_dec[i], v_dec[i], mask,
        ctx_layout="gmk", two_pass=True) for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches["context_flash_partials"] = bd.context_flash_partials.launches
    print(f"serve: two-pass dispatch launches "
          f"{bd.context_flash_partials.launches} (fused "
          f"{bd.fused_bifurcated_decode.launches})")
    check(bd.context_flash_partials.launches == cfg.n_layers
          and bd.fused_bifurcated_decode.launches == 0, "two-pass launches")
    rel_tp = 0.0
    for i in range(cfg.n_layers):
        fused = bifurcated_decode_attention(
            q, cache.k_ctx[i], cache.v_ctx[i], k_dec[i], v_dec[i], mask,
            ctx_layout="gmk")
        ok, _, rel = within(two_pass[i], fused)
        rel_tp = max(rel_tp, rel)
        check(ok, f"layer {i}: two-pass dispatch disagrees with fused")
    print(f"serve: two-pass vs fused {rel_tp:.2e} of max |out| (gate 2e-2)")
    return cfg, cache, launches


def profile_step(model, params, cache, tok, top=8):
    """Where one decode step's device time goes: torch.profiler over one
    step, device time by kernel name, beside the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok, impl="kernel")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: one decode step, wall {wall_us:.0f} us under the "
          f"profiler, device busy {busy:.0f} us ({len(rows)} kernel names)")
    for us, n, key in rows[:top]:
        print(f"profile:   {us:9.1f} us  {n:4d}x  {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def time_ms(fn, n_inputs, reps=3, iters=48):
    """Mean ms per call over ``iters`` calls cycling through ``n_inputs``
    input sets (a layer's context each, so the 50 MB L2 holds none of the
    next call's context), best of ``reps`` timed runs, after a warm-up."""
    import torch

    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i % n_inputs)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / iters)
    return best


def time_kernels(cfg, cache, launches, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bifurcated_decode as bd

    L, g, m_c, hd = cache.k_ctx.shape
    b, c_d, p = BATCH, cache.decode_capacity, cfg.n_heads // cfg.n_kv_heads
    rows, ld = b * p, b * c_d
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    q = torch.randn(g, rows, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    kd = torch.randn(L, g, ld, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    vd = torch.randn_like(kd)
    lens = torch.randint(1, c_d + 1, (b,), generator=gen, device=DEVICE)
    live = torch.arange(c_d, device=DEVICE)[None, :] < lens[:, None]
    bias = torch.where(live.reshape(1, ld), 0.0, -1e30).to(torch.float32)
    scale = hd**-0.5
    kc, vc = cache.k_ctx, cache.v_ctx
    fkw = dict(scale=scale, c_d=c_d, pn=p)

    # library yardsticks on the same inputs, prepared outside the timing:
    # fused = attention over [context ⊕ decode slots] under the slot bias and
    # the cross-sample mask; partials = attention over the context
    row_s = torch.arange(rows, device=DEVICE)[:, None] // p
    col_s = torch.arange(ld, device=DEVICE)[None, :] // c_d
    dec_ok = (row_s == col_s) & live.reshape(1, ld)
    attn_mask = torch.cat([torch.ones(rows, m_c, dtype=torch.bool,
                                      device=DEVICE), dec_ok], dim=1)
    k_all = [torch.cat([kc[i], kd[i]], dim=1)[None] for i in range(L)]
    v_all = [torch.cat([vc[i], vd[i]], dim=1)[None] for i in range(L)]
    q4 = q[None]

    def fused(i):
        return bd.fused_bifurcated_decode(q, kc[i], vc[i], kd[i], vd[i], bias, **fkw)

    def fused_plain(i):
        return bd.fused_bifurcated_decode_plain(q, kc[i], vc[i], kd[i], vd[i],
                                                bias, **fkw)

    def fused_lib(i):
        return F.scaled_dot_product_attention(q4, k_all[i], v_all[i],
                                              attn_mask=attn_mask, scale=scale)

    def part(i):
        return bd.context_flash_partials(q, kc[i], vc[i], scale=scale)

    def part_plain(i):
        return bd.context_flash_partials_plain(q, kc[i], vc[i], scale=scale)

    def part_lib(i):
        return F.scaled_dot_product_attention(q4, kc[i][None], vc[i][None],
                                              scale=scale)

    # the library yardsticks must compute what the kernels compute
    acc, _, l = part(0)
    ok_f, _, rel_f = within(fused_lib(0)[0], fused(0))
    ok_p, _, rel_p = within(part_lib(0)[0], acc / l[..., None])
    print(f"time: library yardsticks vs kernels, fused {rel_f:.2e}, partials "
          f"{rel_p:.2e} of max |out| (gate 2e-2)")
    check(ok_f and ok_p, "library yardstick computes another function")

    # What the function needs of these inputs: q, K_c, V_c and the bias
    # read once, the output written once, and of the decode arm only the
    # live slots' K/V (the output does not depend on the dead ones).
    e = 2  # bf16 bytes
    n_live = int(lens.sum())
    ctx_bytes = 2 * g * m_c * hd * e
    fused_bytes = (g * rows * hd * e + ctx_bytes + 2 * g * n_live * hd * e
                   + ld * 4 + g * rows * hd * e)
    part_bytes = g * rows * hd * e + ctx_bytes + g * rows * hd * 4 + 2 * g * rows * 4
    # two products per arm; the decode arm counts each row's own live slots
    fused_flop = 4 * g * (rows * m_c + p * n_live) * hd
    part_flop = 4 * g * rows * m_c * hd

    entries = []
    for name, kern, plain, lib, nbytes, flop, line, err in (
            ("fused_bifurcated_decode", fused, fused_plain, fused_lib,
             fused_bytes, fused_flop, 206, errs[0]),
            ("context_flash_partials", part, part_plain, part_lib,
             part_bytes, part_flop, 1938, errs[1])):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flop = flop / BF16_FLOP_PER_S * 1e3
        ms = time_ms(kern, L)
        plain_ms = time_ms(plain, L, reps=1, iters=L)
        lib_ms = time_ms(lib, L)
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bifurcated_decode.cu",
            "replaces": f"src/repro/kernels/bifurcated_decode.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations",
            "library_ms": lib_ms,
        }
        print(f"time: {name}: {ms * 1e3:.1f} us/launch, bound "
              f"{entry['bound_ms'] * 1e3:.1f} us ({entry['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.2f} GFLOP), plain "
              f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us")
        entries.append(entry)
    return entries


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    build()
    errs = check_kernels()
    cfg, cache, launches = serve()
    entries = time_kernels(cfg, cache, launches, errs)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
