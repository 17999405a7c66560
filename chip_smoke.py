#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its result lines:

  1. print the card's name and power limit (nvidia-smi), build the CUDA
     kernels from src/repro_torch/kernels/csrc with nvcc, one process per
     source, all started together;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (g=8 kv heads, 64 query rows = 32 samples x 2 query
     heads per kv head, hd=128, m_c=8192, 32 x 24 decode slots, bf16; the
     forest kernels over 4 segments of capacity 8192 with live lengths
     8192/6000/2500/777), once with random inputs and once with a partly
     masked decode arm that carries most of the softmax mass, and at ragged
     shapes (m_c off the block size, two fresh positions per sample, rows
     off the row tile, hd=80, one segment against the single-prefix
     kernel, a 0-length segment, a segment id outside [0, G), and fp32,
     which runs the SIMT copy of the bf16 kernels, not the tensor-core one
     that serves bf16). Every gate is max |kernel - plain| <= tol x
     max |plain| (bf16 2e-2, fp32 1e-5), and the script shows that plain
     versions with the decode arm dropped, its mask ignored, another
     sample's slots read, another group's segment read, or the V scales
     dropped miss that gate by far;
  3. serve internlm2-1.8b at its published width (seeded random weights)
     with ServeEngine.generate: bifurcated cache, fused kernel, batch 32,
     context 8192, 16 steps. The fused kernel must launch 24 layers x 15
     decode steps times. Then, after 8 more decode steps so that 9 decode
     slots are live, one decode step on the kernel path against the plain
     impl="flash" path, layer by layer on the same input and for the whole
     step, and the two-pass dispatch (the partials kernel) over the served
     cache against the fused one;
  3b. the same generate with the int8 context arm (cache_dtype="int8"):
     the q8 kernel must launch 24 x 15 times; per-layer attention of the
     kernel path against the kernel's plain versions; int8-vs-bf16
     whole-step logits printed as information;
  3c. ForestServeEngine at the same width, bf16 and int8 segments: 4
     segments of capacity 8192 with contexts of 8192/6000/2500/777 tokens,
     8 samples each in 32 slots, decode capacity 64, grouped kernels. 15
     steps must launch the grouped kernel 24 x 15 times; per-layer and
     whole-step logits are held against the single-prefix kernel path of
     each group; then the 2500-token group is cancelled and retired, a
     4000-token request takes its segment and slots, 8 more steps run, and
     the three untouched groups' greedy tokens must be bit-identical to a
     run without the retire and readmit;
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
    paths = _build.build()
    _build.library()
    print(f"built {', '.join(os.path.relpath(p, ROOT) for p in paths.values())}"
          f" in {time.perf_counter() - t0:.1f} s (one nvcc per source, in "
          f"parallel)")
    # ptxas' report, one line per kernel instance: registers, spills, smem
    kinds = {"100": "fused", "000": "partials", "110": "fused_q8",
             "101": "grouped", "111": "grouped_q8"}
    for path in paths.values():
        name, spill = None, ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(f32_)?decode_kernelILi(\d+)E((?:Lb[01]E)+)",
                              line)
                if m:
                    flags = "".join(re.findall(r"Lb([01])E", m.group(3)))
                    name = (f"f32 hd={m.group(2)} "
                            f"{'fused' if flags == '1' else 'partials'}"
                            if m.group(1) else
                            f"bf16 hd={m.group(2)} {kinds.get(flags, flags)}")
                else:
                    name = None
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; "
                      f"{spill}")
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


def quantized(x):
    """The case ``x`` with its context quantized as the caches quantize it
    (logit scale folded into k_scale); leading axes are kept."""
    from repro_torch.core.quantized import quantize_ctx

    hd = x["kc"].shape[-1]
    kq, ks = quantize_ctx(x["kc"].float(), fold_scale=hd**-0.5)
    vq, vs = quantize_ctx(x["vc"].float())
    return dict(x, kc=kq, vc=vq, ks=ks, vs=vs)


def forest_inputs(n_groups, g, b, p, n, hd, cap, lens, c_d, seed,
                  masked=False, dec_boost=0.0, shuffle=False, bad_id=False,
                  quant=False):
    """Random grouped-kernel operands: ``n_groups`` segments of capacity
    ``cap`` with live lengths ``lens``; b slots, b / n_groups per segment
    (contiguous, or shuffled across segments), the decode arm as in
    ``kernel_inputs``. ``bad_id`` points the first slot at segment
    n_groups, outside the table."""
    import torch

    x = kernel_inputs(g, b, p, n, hd, 8, c_d, torch.bfloat16, seed,
                      masked=masked, dec_boost=dec_boost)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    shape = (n_groups, g, cap, hd)
    x["kc"] = torch.randn(shape, generator=gen, device=DEVICE)
    x["vc"] = torch.randn(shape, generator=gen, device=DEVICE)
    gid = torch.arange(b, device=DEVICE) * n_groups // b
    if shuffle:
        gid = gid[torch.randperm(b, generator=gen, device=DEVICE)]
    if bad_id:
        gid[0] = n_groups
    x["row_group"] = gid.to(torch.int32).repeat_interleave(p * n)
    x["ctx_lens"] = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    if quant:
        return quantized(x)
    x["kc"], x["vc"] = x["kc"].to(torch.bfloat16), x["vc"].to(torch.bfloat16)
    return x


def q8_args(x):
    return (x["q"], x["kc"], x["vc"], x["ks"], x["vs"], x["kd"], x["vd"],
            x["bias"])


def grouped_args(x, quant):
    ctx = ((x["kc"], x["vc"], x["ks"], x["vs"]) if quant
           else (x["kc"], x["vc"]))
    return (x["q"],) + ctx + (x["row_group"], x["ctx_lens"], x["kd"],
                              x["vd"], x["bias"])


def check_q8(name, x):
    """The fused q8 kernel vs its plain version on one case; returns the
    max abs error."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    out_k = bd.fused_bifurcated_decode_q8(*q8_args(x), **kw)
    out_p = bd.fused_bifurcated_decode_q8_plain(*q8_args(x), **kw)
    torch.cuda.synchronize()
    ok, err, rel = within(out_k, out_p)
    print(f"check {name}: q8 max_abs_err={err:.3e} ({rel:.1e} of max |out|,"
          f" gate 2e-2)")
    check(ok, f"{name}: q8 kernel disagrees with its plain version")
    check(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite")
    return err


def check_grouped(name, x, quant):
    """A grouped kernel vs its plain version on one case: both NaN on the
    rows of a segment id outside [0, G) and nowhere else, within the gate
    on the others; returns the max abs error."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kern = (bd.grouped_fused_bifurcated_decode_q8 if quant
            else bd.grouped_fused_bifurcated_decode)
    plain = (bd.grouped_fused_bifurcated_decode_q8_plain if quant
             else bd.grouped_fused_bifurcated_decode_plain)
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    out_k = kern(*grouped_args(x, quant), **kw)
    out_p = plain(*grouped_args(x, quant), **kw)
    torch.cuda.synchronize()
    n_groups = x["ctx_lens"].numel()
    bad = (x["row_group"] < 0) | (x["row_group"] >= n_groups)
    nan_k = torch.isnan(out_k.float()).any(-1).any(0)
    check(bool(torch.equal(nan_k, bad)),
          f"{name}: NaN rows {nan_k.nonzero().flatten().tolist()} are not "
          f"the rows of ids outside the table")
    check(bool(torch.isfinite(out_k[:, ~bad].float()).all()),
          f"{name}: non-finite")
    ok, err, rel = within(out_k[:, ~bad], out_p[:, ~bad])
    print(f"check {name}: {'grouped q8' if quant else 'grouped'} "
          f"max_abs_err={err:.3e} ({rel:.1e} of max |out|, gate 2e-2)"
          + (f"; {int(bad.sum())} rows of an id outside [0, G) NaN"
             if bad.any() else ""))
    check(ok, f"{name}: grouped kernel disagrees with its plain version")
    return err


def check_forest_gate_sensitivity(name, xq, xg):
    """Two more faulty plain versions, on main-shape cases whose context
    carries most of the softmax mass: one drops the V scales of the int8
    arm (``xq``), one reads another group's segment (``xg``). Each must miss
    the kernel gate by at least tenfold."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kw = dict(scale=xq["scale"], c_d=xq["c_d"], pn=xq["pn"])
    want = bd.fused_bifurcated_decode_q8_plain(*q8_args(xq), **kw)
    got = bd.fused_bifurcated_decode_q8_plain(
        *q8_args(dict(xq, vs=torch.ones_like(xq["vs"]))), **kw)
    rel_v = within(got, want)[2]
    n_groups = xg["ctx_lens"].numel()
    kw = dict(scale=xg["scale"], c_d=xg["c_d"], pn=xg["pn"])
    want = bd.grouped_fused_bifurcated_decode_plain(*grouped_args(xg, False),
                                                    **kw)
    other = dict(xg, row_group=(xg["row_group"] + 1) % n_groups)
    got = bd.grouped_fused_bifurcated_decode_plain(*grouped_args(other, False),
                                                   **kw)
    rel_g = within(got, want)[2]
    print(f"check {name}: a faulty version's error / max |out|: V scales "
          f"dropped {rel_v:.2f}, another group's segment {rel_g:.2f}")
    check(rel_v >= 10 * TOL["bfloat16"], f"{name}: the gate misses a q8 "
          f"plain version without V scales")
    check(rel_g >= 10 * TOL["bfloat16"], f"{name}: the gate misses a grouped "
          f"plain version reading another group's segment")


FOREST_LENS = (8192, 6000, 2500, 777)
FOREST_DEC_CAP = 64     # phase 3c's decode capacity


def check_kernels():
    """Phase 2; returns {kernel name: max abs error over its main-shape
    cases}."""
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
    out = {"fused_bifurcated_decode": errs[0],
           "context_flash_partials": errs[1]}

    # the int8 context arm (#3)
    x_q = quantized(kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=10))
    err_q = max(check_q8(f"main {main} int8 ctx", x_q),
                check_q8(f"main {main} int8 ctx decode-dominant masked",
                         quantized(dominant)))
    for name, (g, b, p, n, hd, m_c, c_d, seed) in [
            ("m_c=8191 masked-arm int8", (8, 32, 2, 1, 128, 8191, 24, 11)),
            ("n=2 p=2 m_c=1000 int8", (8, 8, 2, 2, 128, 1000, 5, 12)),
            ("rows=6 g=2 m_c=77 int8", (2, 3, 2, 1, 128, 77, 3, 13)),
            ("hd=80 rows=96 m_c=700 int8", (8, 48, 2, 1, 80, 700, 9, 14))]:
        check_q8(name, quantized(kernel_inputs(g, b, p, n, hd, m_c, c_d, bf16,
                                               seed, masked=True)))
    out["fused_bifurcated_decode_q8"] = err_q

    # the forest (#4, #5): main shapes (phase 3c's decode arm, 32 slots of
    # capacity 64), then ragged ones
    fmain = (f"G=4 cap=8192 lens={'/'.join(map(str, FOREST_LENS))} g=8 "
             f"rows=64 hd=128 ld={BATCH * FOREST_DEC_CAP} bf16")
    x_g = None
    for quant, kname in ((False, "grouped_fused_bifurcated_decode"),
                         (True, "grouped_fused_bifurcated_decode_q8")):
        tag = "int8 " if quant else ""
        x = forest_inputs(4, 8, 32, 2, 1, 128, 8192, FOREST_LENS,
                          FOREST_DEC_CAP, seed=20, quant=quant)
        if not quant:
            x_g = x
        err = max(check_grouped(f"main {tag}{fmain}", x, quant),
                  check_grouped(f"main {tag}{fmain} decode-dominant masked",
                                forest_inputs(4, 8, 32, 2, 1, 128, 8192,
                                              FOREST_LENS, FOREST_DEC_CAP,
                                              seed=21,
                                              masked=True, dec_boost=3.0,
                                              quant=quant), quant))
        for name, args, kw in [
                ("rows shuffled, 0-length segment, id outside [0, G)",
                 (3, 8, 32, 2, 1, 128, 1000, (1000, 0, 77), 24, 22),
                 dict(masked=True, shuffle=True, bad_id=True)),
                ("n=2 p=2 G=3 cap=1000", (3, 8, 9, 2, 2, 128, 1000,
                                          (1000, 513, 64), 5, 23),
                 dict(masked=True, shuffle=True)),
                ("hd=80 G=2 rows=96", (2, 8, 48, 2, 1, 80, 700, (700, 333),
                                       9, 24), dict(masked=True))]:
            check_grouped(f"{tag}{name}", forest_inputs(*args, quant=quant,
                                                        **kw), quant)
        # one segment: the single-prefix kernel's function
        x1 = forest_inputs(1, 8, 32, 2, 1, 128, 2049, (2049,), 24, seed=25,
                           masked=True, quant=quant)
        kw = dict(scale=x1["scale"], c_d=x1["c_d"], pn=x1["pn"])
        from repro_torch.kernels import bifurcated_decode as bd
        if quant:
            one = bd.fused_bifurcated_decode_q8(
                x1["q"], x1["kc"][0], x1["vc"][0], x1["ks"][0], x1["vs"][0],
                x1["kd"], x1["vd"], x1["bias"], **kw)
            grp = bd.grouped_fused_bifurcated_decode_q8(
                *grouped_args(x1, True), **kw)
        else:
            one = bd.fused_bifurcated_decode(
                x1["q"], x1["kc"][0], x1["vc"][0], x1["kd"], x1["vd"],
                x1["bias"], **kw)
            grp = bd.grouped_fused_bifurcated_decode(
                *grouped_args(x1, False), **kw)
        torch.cuda.synchronize()
        ok, e1, rel = within(grp, one)
        print(f"check {tag}G=1 m_c=2049 grouped vs single-prefix kernel: "
              f"max_abs_err={e1:.3e} ({rel:.1e} of max |out|, gate 2e-2; "
              f"bit-equal {bool(torch.equal(grp, one))})")
        check(ok, f"{tag}G=1: grouped kernel disagrees with the single-prefix "
                  f"kernel")
        out[kname] = err
    check_forest_gate_sensitivity(f"main {main} int8 ctx; main {fmain}",
                                  x_q, x_g)
    return out


# ---------------------------------------------------------------------------
# phase 3: the serving path at the published width
# ---------------------------------------------------------------------------

BATCH, CONTEXT, STEPS = 32, 8192, 16
WARM_STEPS = 8      # decode steps before the step compared across paths


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from repro_torch.kernels import bifurcated_decode as bd

    for kern in bd.KERNELS:
        kern.launches = 0


def read_launches():
    from repro_torch.kernels import bifurcated_decode as bd

    return {kern.__name__: kern.launches for kern in bd.KERNELS}


def expect_launches(counts, name, want):
    """The path just run launched kernel ``name`` ``want`` times and no
    other kernel."""
    for k, v in counts.items():
        check(v == (want if k == name else 0),
              f"{k} launched {v} times, want {want if k == name else 0}")


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
    reset_launches()
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = {k: counts[k] for k in ("fused_bifurcated_decode",
                                       "context_flash_partials")}
    print(f"serve: generate launches {counts}")
    expect_launches(counts, "fused_bifurcated_decode",
                    cfg.n_layers * (STEPS - 1))
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
    reset_launches()
    two_pass = [bifurcated_decode_attention(
        q, cache.k_ctx[i], cache.v_ctx[i], k_dec[i], v_dec[i], mask,
        ctx_layout="gmk", two_pass=True) for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    launches["context_flash_partials"] = bd.context_flash_partials.launches
    print(f"serve: two-pass dispatch launches "
          f"{bd.context_flash_partials.launches} (fused "
          f"{bd.fused_bifurcated_decode.launches})")
    expect_launches(read_launches(), "context_flash_partials", cfg.n_layers)
    rel_tp = 0.0
    for i in range(cfg.n_layers):
        fused = bifurcated_decode_attention(
            q, cache.k_ctx[i], cache.v_ctx[i], k_dec[i], v_dec[i], mask,
            ctx_layout="gmk")
        ok, _, rel = within(two_pass[i], fused)
        rel_tp = max(rel_tp, rel)
        check(ok, f"layer {i}: two-pass dispatch disagrees with fused")
    print(f"serve: two-pass vs fused {rel_tp:.2e} of max |out| (gate 2e-2)")
    return cfg, model, params, ctx, result.tokens, cache, launches


def _per_layer_residual(cfg, model, params, x0, layer_attn):
    """Walk one decode step's residual stream layer by layer:
    ``layer_attn(i, layer, h)`` returns the attention output the stream
    takes at layer i; returns the final residual."""
    from repro_torch.models import blocks
    from repro_torch.models.transformer import _layer

    x = x0
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        x = x + layer_attn(i, layer, blocks.apply_norm(cfg, layer["ln1"], x))
        x = x + blocks.apply_mlp(cfg, layer["mlp"],
                                 blocks.apply_norm(cfg, layer["ln2"], x))
    return x


def serve_int8(cfg, model, params, ctx, tokens, cache_bf16):
    """Phase 3b: the int8 context arm on the same workload. Returns the
    served int8 cache (for phase 4) and the q8 kernel's launch count of
    the counted generate."""
    import dataclasses

    import torch
    from repro_torch.configs import ServeConfig
    from repro_torch.core.quantized import QuantBifurcatedCache
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.models import blocks
    from repro_torch.runtime.serve import ServeEngine

    scfg = ServeConfig(batch=BATCH, context_len=CONTEXT,
                       decode_capacity=max(16, STEPS + 8), bifurcated=True,
                       use_kernel=True, cache_dtype="int8")
    engine = ServeEngine(model, cfg, scfg)
    engine.generate(params, ctx, n_steps=2)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"serve int8: generate launches {counts}")
    expect_launches(counts, "fused_bifurcated_decode_q8",
                    cfg.n_layers * (STEPS - 1))
    toks, lps = result.tokens, result.logprobs
    check(tuple(toks.shape) == (BATCH, STEPS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()), "logprobs")
    t0 = time.perf_counter()
    _, cache = engine.prefill_shared(params, ctx, BATCH)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(isinstance(cache, QuantBifurcatedCache), "int8 cache family")
    print(f"serve int8: generate {wall * 1e3:.1f} ms = prefill (with the "
          f"quantization) {prefill_s * 1e3:.1f} ms + {STEPS - 1} decode steps"
          f" at {(wall - prefill_s) / (STEPS - 1) * 1e3:.2f} ms/step")
    # the bf16 cache of phase 3 saw these WARM_STEPS tokens too
    for t in range(WARM_STEPS):
        _, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                     impl="kernel")
    tok = tokens[:, WARM_STEPS:WARM_STEPS + 1]
    position = cache.context_len + cache.dec_length
    on_cuda = bd._on_cuda

    def attn(i, layer, h, plain=False):
        lc = {"k_ctx": cache.k_ctx[i], "v_ctx": cache.v_ctx[i],
              "k_scale": cache.k_scale[i], "v_scale": cache.v_scale[i],
              "k_dec": cache.k_dec[i].clone(), "v_dec": cache.v_dec[i].clone()}
        if plain:
            bd._on_cuda = lambda *t: False
        try:
            return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                           position=position, bifurcated=True,
                                           impl="kernel")
        finally:
            bd._on_cuda = on_cuda

    rel_max = [0.0]

    def kernel_vs_plain(i, layer, h):
        o = attn(i, layer, h)
        ok, _, rel = within(o, attn(i, layer, h, plain=True))
        check(ok, f"int8 layer {i}: kernel attention disagrees with the "
                  f"plain versions ({rel:.2e} of max |out|)")
        rel_max[0] = max(rel_max[0], rel)
        return o

    _per_layer_residual(cfg, model, params, model._embed(params, tok),
                        kernel_vs_plain)
    print(f"serve int8: {cache.dec_length + 1} live decode slots; per-layer "
          f"attention on the kernel stream's input, q8 kernel vs its plain "
          f"versions {rel_max[0]:.2e} of max |out| (gate 2e-2, "
          f"{cfg.n_layers} layers)")

    def fresh(c):
        return dataclasses.replace(c, k_dec=c.k_dec.clone(),
                                   v_dec=c.v_dec.clone())

    lq, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
    lb, _ = model.decode_step(params, fresh(cache_bf16), tok, impl="kernel")
    bd._on_cuda = lambda *t: False
    try:
        lp, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
    finally:
        bd._on_cuda = on_cuda
    torch.cuda.synchronize()
    live = lb.abs() < 1e29
    check(bool(torch.isfinite(lq.float()[live]).all()), "non-finite logits")
    err_qp, top = gap(lq[live], lp[live])
    err_qb, _ = gap(lq[live], lb[live])
    agree = (lq.argmax(-1) == lb.argmax(-1)).float().mean().item()
    print(f"serve int8 (information, no gate): decode-step logits, q8 kernel "
          f"path vs its plain versions {err_qp:.3e}, int8 vs bf16 context "
          f"{err_qb:.3e} ({err_qb / top:.2e} of max |logit| {top:.3f}); "
          f"greedy tokens agree on {agree:.3f} of the samples")
    return cache, counts["fused_bifurcated_decode_q8"]


def _single_prefix_cache(fcache, gi, length, idx, depth, quant):
    """The single-prefix cache that group ``gi`` of the forest cache
    ``fcache`` describes, for the slots ``idx`` (a copy: the context's live
    prefix and those slots' decode arms)."""
    from repro_torch.core.kv_cache import BifurcatedCache
    from repro_torch.core.quantized import QuantBifurcatedCache

    ctx = {n: getattr(fcache, n)[:, gi, ..., :length, :].contiguous()
           for n in ("k_ctx", "v_ctx")}
    dec = dict(k_dec=fcache.k_dec[:, idx].clone(),
               v_dec=fcache.v_dec[:, idx].clone(), dec_length=depth,
               ctx_layout="gmk")
    if not quant:
        return BifurcatedCache(**ctx, **dec)
    sc = {n: getattr(fcache, n)[:, gi, :, :length].contiguous()
          for n in ("k_scale", "v_scale")}
    return QuantBifurcatedCache(**ctx, **sc, **dec)


def _fork(fcache):
    """The forest cache with its decode arms and depths copied, so that a
    decode step on it leaves ``fcache`` as it was."""
    import dataclasses

    return dataclasses.replace(fcache, k_dec=fcache.k_dec.clone(),
                               v_dec=fcache.v_dec.clone(),
                               dec_lens=fcache.dec_lens.clone())


def forest_vs_single(cfg, model, params, fcache, tokens, slots, quant):
    """One decode step of the forest, per layer on the forest stream's own
    input: the grouped kernel against its plain version, and against the
    single-prefix kernel path of each group; then the whole step against
    that path. Each group's single-prefix batch is its 8 slots tiled to the
    forest's 32, so the model's matrix products have the same shapes.
    Returns the per-layer kernel-vs-plain max abs error."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.models import blocks

    depth = int(fcache.dec_lens[slots[0][0]])
    idx = [torch.tensor(s * (BATCH // len(s)), device=DEVICE) for s in slots]
    rel_layer = [0.0]
    plain_err = [0.0, 0.0]      # max abs error, and its share of max |out|
    on_cuda = bd._on_cuda

    def forest_attn(i, layer, h, plain=False):
        lc = {n: getattr(fcache, n)[i] for n in ("k_ctx", "v_ctx")}
        if quant:
            lc.update({n: getattr(fcache, n)[i]
                       for n in ("k_scale", "v_scale")})
        lc.update(k_dec=fcache.k_dec[i].clone(), v_dec=fcache.v_dec[i].clone())
        if plain:
            bd._on_cuda = lambda *t: False
        try:
            return blocks.attention_decode_forest(
                cfg, layer["attn"], h, lc, group_ids=fcache.group_ids,
                ctx_lens=fcache.ctx_lens, dec_lens=fcache.dec_lens,
                impl="kernel")
        finally:
            bd._on_cuda = on_cuda

    def attn(i, layer, h):
        o = forest_attn(i, layer, h)
        ok, err, rel = within(o, forest_attn(i, layer, h, plain=True))
        check(ok, f"forest layer {i}: grouped kernel attention disagrees "
                  f"with its plain versions ({rel:.2e} of max |out|)")
        plain_err[:] = max(plain_err[0], err), max(plain_err[1], rel)
        for gi, s in enumerate(slots):
            length = FOREST_LENS[gi]
            lcs = {n: getattr(fcache, n)[i, gi, :, :length].contiguous()
                   for n in (("k_ctx", "v_ctx", "k_scale", "v_scale") if quant
                             else ("k_ctx", "v_ctx"))}
            lcs.update(k_dec=fcache.k_dec[i][idx[gi]],
                       v_dec=fcache.v_dec[i][idx[gi]])
            o_s = blocks.attention_decode(
                cfg, layer["attn"], h[idx[gi]], lcs, position=length + depth,
                bifurcated=True, impl="kernel")
            ok, _, rel = within(o[s], o_s[:len(s)])
            check(ok, f"forest layer {i} group {gi}: grouped kernel attention"
                      f" disagrees with the single-prefix kernel path "
                      f"({rel:.2e} of max |out|)")
            rel_layer[0] = max(rel_layer[0], rel)
        return o

    _per_layer_residual(cfg, model, params, model._embed(params, tokens), attn)
    lf, _ = model.decode_step(params, _fork(fcache), tokens, impl="kernel")
    bd._on_cuda = lambda *t: False
    try:
        lp, _ = model.decode_step(params, _fork(fcache), tokens, impl="kernel")
    finally:
        bd._on_cuda = on_cuda
    worst = None
    for gi, s in enumerate(slots):
        single = _single_prefix_cache(fcache, gi, FOREST_LENS[gi], idx[gi],
                                      depth, quant)
        ls, _ = model.decode_step(params, single, tokens[idx[gi]],
                                  impl="kernel")
        del single
        live = ls.abs() < 1e29
        want = ls[:len(s)][live[:len(s)]]
        err_fs, top = gap(lf[s][live[:len(s)]], want)
        err_ps, _ = gap(lp[s][live[:len(s)]], want)
        check(bool(torch.isfinite(lf[s].float()[live[:len(s)]]).all()),
              "non-finite forest logits")
        check(err_fs <= max(TOL["bfloat16"] * top, 1.5 * err_ps),
              f"forest group {gi}: logits disagree with the single-prefix "
              f"kernel path ({err_fs:.3e}, max |logit| {top:.3f})")
        if worst is None or err_fs / top > worst[0] / worst[1]:
            worst = (err_fs, top, err_ps, gi)
    n_slots, c_d = fcache.k_dec.shape[1:3]
    print(f"serve forest{' int8' if quant else ''}: {depth + 1} live decode "
          f"slots of {c_d} (ld {n_slots * c_d}); per-layer attention, "
          f"grouped kernel vs its plain versions max_abs_err="
          f"{plain_err[0]:.3e} ({plain_err[1]:.2e} of max |out|), vs the "
          f"single-prefix kernel path of each group {rel_layer[0]:.2e} of "
          f"max |out| (gates 2e-2); decode-step logits, worst group "
          f"{worst[3]}: {worst[0]:.3e} against max |logit| {worst[1]:.3f} "
          f"(plain versions {worst[2]:.3e}; gate max(2e-2 x max |logit|, "
          f"1.5 x plain))")
    return plain_err[0]


FOREST_STEPS, FOREST_MORE, READMIT_LEN = 15, 8, 4000


def serve_forest(cfg, model, params, quant):
    """Phase 3c: ForestServeEngine at the published width. Returns the
    forest cache of the run without retirement (for phase 4), the grouped
    kernel's launch count of the counted chunk and its per-layer max abs
    error against its plain versions."""
    import numpy as np
    import torch
    from repro_torch.configs import ForestConfig
    from repro_torch.runtime.serve import ForestServeEngine

    tag = "serve forest int8" if quant else "serve forest"
    kname = ("grouped_fused_bifurcated_decode_q8" if quant
             else "grouped_fused_bifurcated_decode")
    fcfg = ForestConfig(n_groups=4, slots=BATCH, ctx_capacity=CONTEXT,
                        decode_capacity=FOREST_DEC_CAP, use_kernel=True,
                        cache_dtype="int8" if quant else "bfloat16")
    rng = np.random.RandomState(1)
    ctxs = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                            device=DEVICE) for m in FOREST_LENS]
    new_ctx = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                          (1, READMIT_LEN)), device=DEVICE)

    def start():
        eng = ForestServeEngine(model, cfg, fcfg)
        st = eng.init_state(device=DEVICE)
        slots = []
        for c in ctxs:
            st, s = eng.admit(params, st, c, BATCH // len(ctxs))
            slots.append(s)
        return eng, st, slots

    # run B, without retirement: the reference of the bit-identity check
    # (and the path's warm-up)
    t0 = time.perf_counter()
    eng_b, st_b, slots = start()
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    st_b = eng_b.step_chunk(params, st_b, FOREST_STEPS)
    # run A, counted: the same admissions, then the same chunk
    eng, st, slots_a = start()
    check(slots_a == slots, "the two runs assigned different slots")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.step_chunk(params, st, FOREST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"{tag}: 4 admissions ({'/'.join(map(str, FOREST_LENS))} tokens, "
          f"8 samples each) {admit_s * 1e3:.1f} ms; {FOREST_STEPS} steps "
          f"{wall * 1e3:.1f} ms ({wall / FOREST_STEPS * 1e3:.2f} ms/step); "
          f"launches {counts}")
    expect_launches(counts, kname, cfg.n_layers * FOREST_STEPS)
    check(eng.outputs == eng_b.outputs, "two identical runs differ")
    for s in sum(slots, []):
        toks = eng.outputs[s]
        check(len(toks) == FOREST_STEPS + 1, f"slot {s}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks), "token range")
        check(all(np.isfinite(eng.logps[s])), "logprobs")
    path_err = forest_vs_single(cfg, model, params, st_b.cache, st_b.tokens,
                                slots, quant)

    # cancel and retire the 2500-token group, readmit into its segment and
    # slots, decode on; the untouched groups must not move by one bit
    st = eng.cancel_group(st, 2)
    check(eng.retire_groups(st) == [2], "retire")
    st, s_new = eng.admit(params, st, new_ctx, BATCH // len(ctxs))
    check(s_new == slots[2], f"readmitted into slots {s_new}")
    want = list(FOREST_LENS)
    want[2] = READMIT_LEN
    check(st.cache.ctx_lens.tolist() == want,
          f"ctx_lens {st.cache.ctx_lens.tolist()}")
    st = eng.step_chunk(params, st, FOREST_MORE)
    st_b = eng_b.step_chunk(params, st_b, FOREST_MORE)
    same = all(eng.outputs[s] == eng_b.outputs[s]
               for gi in (0, 1, 3) for s in slots[gi])
    print(f"{tag}: group 2 retired, a {READMIT_LEN}-token request readmitted "
          f"into its segment and slots {s_new[0]}-{s_new[-1]}, "
          f"{FOREST_MORE} more steps: untouched groups' "
          f"{1 + FOREST_STEPS + FOREST_MORE} tokens per slot bit-identical "
          f"to the run without retirement: {same}")
    check(same, "the retire and readmit moved another group's tokens")
    check(all(len(eng.outputs[s]) == FOREST_MORE + 1 for s in s_new),
          "readmitted slots' outputs")
    del eng, st
    return st_b.cache, counts[kname], path_err


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


def _timed_entry(name, source, line, kern, plain, lib, nbytes, flop,
                 launches, err, n_inputs):
    """Time one kernel, its plain version and its library yardstick over
    ``n_inputs`` input sets; returns its JSON entry."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flop = flop / BF16_FLOP_PER_S * 1e3
    ms = time_ms(kern, n_inputs)
    plain_ms = time_ms(plain, n_inputs, reps=1, iters=n_inputs)
    lib_ms = time_ms(lib, n_inputs)
    entry = {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": f"src/repro/kernels/bifurcated_decode.py:{line}",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_flop),
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
        "library_ms": lib_ms,
    }
    print(f"time: {name}: {ms * 1e3:.1f} us/launch, bound "
          f"{entry['bound_ms'] * 1e3:.1f} us ({entry['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.2f} GFLOP), plain "
          f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us")
    return entry


def _decode_arm_operands(L, g, b, c_d, hd, seed):
    """Random decode arms for L layers, with 1..c_d live slots per sample:
    (k_dec, v_dec) (L, g, b*c_d, hd) bf16, bias (1, b*c_d), live (b, c_d)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ld = b * c_d
    kd = torch.randn(L, g, ld, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    vd = torch.randn(L, g, ld, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    lens = torch.randint(1, c_d + 1, (b,), generator=gen, device=DEVICE)
    live = torch.arange(c_d, device=DEVICE)[None, :] < lens[:, None]
    bias = torch.where(live.reshape(1, ld), 0.0, -1e30).to(torch.float32)
    return kd, vd, bias, live


def _dequantized(kq, sc):
    """int8 values with their (folded) scales, as bf16: the library
    yardstick's keys and values for the int8 arm."""
    import torch

    return (kq.float() * sc[..., None]).to(torch.bfloat16)


def time_kernels(cfg, cache, q8cache, fcaches, launches, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bifurcated_decode as bd

    L, g, m_c, hd = cache.k_ctx.shape
    b, c_d, p = BATCH, cache.decode_capacity, cfg.n_heads // cfg.n_kv_heads
    rows, ld = b * p, b * c_d
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    q = torch.randn(g, rows, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    kd, vd, bias, live = _decode_arm_operands(L, g, b, c_d, hd, seed=3)
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
    n_live = int(live.sum())
    io_bytes = 2 * g * rows * hd * e                     # q and the output
    dec_bytes = 2 * g * n_live * hd * e + ld * 4         # live slots + bias
    ctx_bytes = 2 * g * m_c * hd * e
    fused_bytes = io_bytes + ctx_bytes + dec_bytes
    part_bytes = g * rows * hd * e + ctx_bytes + g * rows * hd * 4 + 2 * g * rows * 4
    # two products per arm; the decode arm counts each row's own live slots
    dec_flop = 4 * g * p * n_live * hd
    fused_flop = 4 * g * rows * m_c * hd + dec_flop
    part_flop = 4 * g * rows * m_c * hd

    entries = [
        _timed_entry("fused_bifurcated_decode", "bifurcated_decode.cu", 206,
                     fused, fused_plain, fused_lib, fused_bytes, fused_flop,
                     launches["fused_bifurcated_decode"],
                     errs["fused_bifurcated_decode"], L),
        _timed_entry("context_flash_partials", "bifurcated_decode.cu", 1938,
                     part, part_plain, part_lib, part_bytes, part_flop,
                     launches["context_flash_partials"],
                     errs["context_flash_partials"], L)]

    # #3: the int8 served cache of phase 3b, the same q and decode arms.
    # Its yardstick runs SDPA at scale 1 over the dequantized context (the
    # logit scale is folded into k_scale) and decode keys scaled by hd**-0.5
    kq, vq, ks, vs = (q8cache.k_ctx, q8cache.v_ctx, q8cache.k_scale,
                      q8cache.v_scale)
    kq_all = [torch.cat([_dequantized(kq[i], ks[i]),
                         (kd[i].float() * scale).to(torch.bfloat16)],
                        dim=1)[None] for i in range(L)]
    vq_all = [torch.cat([_dequantized(vq[i], vs[i]), vd[i]], dim=1)[None]
              for i in range(L)]

    def q8(i):
        return bd.fused_bifurcated_decode_q8(q, kq[i], vq[i], ks[i], vs[i],
                                             kd[i], vd[i], bias, **fkw)

    def q8_plain(i):
        return bd.fused_bifurcated_decode_q8_plain(
            q, kq[i], vq[i], ks[i], vs[i], kd[i], vd[i], bias, **fkw)

    def q8_lib(i):
        return F.scaled_dot_product_attention(q4, kq_all[i], vq_all[i],
                                              attn_mask=attn_mask, scale=1.0)

    ok, _, rel = within(q8_lib(0)[0], q8(0))
    print(f"time: library yardstick vs q8 kernel {rel:.2e} of max |out| "
          f"(gate 2e-2)")
    check(ok, "q8 library yardstick computes another function")
    q8_bytes = (io_bytes + dec_bytes + 2 * g * m_c * hd + 2 * g * m_c * 4)
    entries.append(_timed_entry(
        "fused_bifurcated_decode_q8", "forest_q8_decode.cu", 350, q8,
        q8_plain, q8_lib, q8_bytes, fused_flop,
        launches["fused_bifurcated_decode_q8"],
        errs["fused_bifurcated_decode_q8"], L))

    # #4, #5: the forest caches of phase 3c (live lengths FOREST_LENS, 8
    # slots per segment) with their own decode arms (32 slots of capacity
    # FOREST_DEC_CAP, live up to each slot's depth, as the next step reads
    # them), the same q. The yardstick: SDPA over [each segment's live keys
    # ⊕ decode slots], a row seeing its own segment and its own live slots
    from repro_torch.kernels.ops import _decode_operands

    for quant, kname, line in ((False, "grouped_fused_bifurcated_decode", 510),
                               (True, "grouped_fused_bifurcated_decode_q8",
                                651)):
        fc = fcaches[quant]
        f_cd = fc.k_dec.shape[2]
        f_live = (torch.arange(f_cd, device=DEVICE)[None, :]
                  <= fc.dec_lens[:, None])                  # (slots, f_cd)
        arms = [_decode_operands(fc.k_dec[i], fc.v_dec[i], f_live)
                for i in range(L)]
        kd, vd = [a[0] for a in arms], [a[1] for a in arms]
        f_bias = arms[0][2]
        del arms
        f_col = torch.arange(b * f_cd, device=DEVICE)[None, :] // f_cd
        f_dec_ok = (row_s == f_col) & f_live.reshape(1, b * f_cd)
        n_live = int(f_live.sum())
        f_dec_bytes = 2 * g * n_live * hd * e + b * f_cd * 4
        f_dec_flop = 4 * g * p * n_live * hd
        gkw = dict(scale=scale, c_d=f_cd, pn=p)
        row_group = fc.group_ids.repeat_interleave(p)
        ctx_lens = fc.ctx_lens
        lens = ctx_lens.tolist()
        starts = [sum(lens[:j]) for j in range(len(lens))]
        seg_of_key = torch.cat([torch.full((n,), j, device=DEVICE)
                                for j, n in enumerate(lens)])
        mask = torch.cat([row_group[:, None] == seg_of_key[None, :],
                          f_dec_ok], dim=1)
        if quant:
            ctx_k = [torch.cat([_dequantized(fc.k_ctx[i, j, :, :n],
                                             fc.k_scale[i, j, :, :n])
                                for j, n in enumerate(lens)], dim=1)
                     for i in range(L)]
            ctx_v = [torch.cat([_dequantized(fc.v_ctx[i, j, :, :n],
                                             fc.v_scale[i, j, :, :n])
                                for j, n in enumerate(lens)], dim=1)
                     for i in range(L)]
            kds = [(kd[i].float() * scale).to(torch.bfloat16) for i in range(L)]
            lib_scale = 1.0
        else:
            ctx_k = [torch.cat([fc.k_ctx[i, j, :, :n]
                                for j, n in enumerate(lens)], dim=1)
                     for i in range(L)]
            ctx_v = [torch.cat([fc.v_ctx[i, j, :, :n]
                                for j, n in enumerate(lens)], dim=1)
                     for i in range(L)]
            kds, lib_scale = kd, scale
        g_k = [torch.cat([ctx_k[i], kds[i]], dim=1)[None] for i in range(L)]
        g_v = [torch.cat([ctx_v[i], vd[i]], dim=1)[None] for i in range(L)]
        del ctx_k, ctx_v
        ctx_ops = ((lambda i: (fc.k_ctx[i], fc.v_ctx[i], fc.k_scale[i],
                               fc.v_scale[i])) if quant
                   else (lambda i: (fc.k_ctx[i], fc.v_ctx[i])))
        kern = getattr(bd, kname)
        plain = getattr(bd, kname + "_plain")

        def grouped(i, kern=kern, ctx_ops=ctx_ops, kd=kd, vd=vd):
            return kern(q, *ctx_ops(i), row_group, ctx_lens, kd[i], vd[i],
                        f_bias, **gkw)

        def grouped_plain(i, plain=plain, ctx_ops=ctx_ops, kd=kd, vd=vd):
            return plain(q, *ctx_ops(i), row_group, ctx_lens, kd[i], vd[i],
                         f_bias, **gkw)

        def grouped_lib(i, g_k=g_k, g_v=g_v, mask=mask, lib_scale=lib_scale):
            return F.scaled_dot_product_attention(q4, g_k[i], g_v[i],
                                                  attn_mask=mask,
                                                  scale=lib_scale)

        ok, _, rel = within(grouped_lib(0)[0], grouped(0))
        print(f"time: library yardstick vs {kname} {rel:.2e} of max |out| "
              f"(gate 2e-2; segment starts {starts}; decode arm ld "
              f"{b * f_cd}, {n_live} live slots)")
        check(ok, f"{kname}: library yardstick computes another function")
        if not quant:
            # information, no gate: #1 on its own context with this decode
            # arm, to part the decode arm's cost from the segments'
            wide = time_ms(lambda i: bd.fused_bifurcated_decode(
                q, kc[i], vc[i], kd[i], vd[i], f_bias, **gkw), L)
            print(f"time (information): fused_bifurcated_decode at m_c "
                  f"{m_c} with this decode arm (ld {b * f_cd}): "
                  f"{wide * 1e3:.1f} us/launch")
        live_keys = sum(lens)
        per_key = 2 * hd * (1 if quant else e) + (2 * 4 if quant else 0)
        nbytes = (io_bytes + f_dec_bytes + g * live_keys * per_key
                  + rows * 4 + len(lens) * 4)
        rows_per_seg = rows // len(lens)
        flop = 4 * g * rows_per_seg * live_keys * hd + f_dec_flop
        entries.append(_timed_entry(
            kname, "forest_q8_decode.cu", line, grouped, grouped_plain,
            grouped_lib, nbytes, flop, launches[kname], errs[kname], L))
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
    cfg, model, params, ctx, tokens, cache, launches = serve()
    q8cache, launches["fused_bifurcated_decode_q8"] = serve_int8(
        cfg, model, params, ctx, tokens, cache)
    fcaches = {}
    for quant, kname in ((False, "grouped_fused_bifurcated_decode"),
                         (True, "grouped_fused_bifurcated_decode_q8")):
        fcaches[quant], launches[kname], path_err = serve_forest(
            cfg, model, params, quant)
        errs[kname] = max(errs[kname], path_err)
    entries = time_kernels(cfg, cache, q8cache, fcaches, launches, errs)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
