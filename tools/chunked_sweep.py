"""Kernel #13 (``chunked_linear_attention``) at the slice's shape on the
card: its one free parameter, the CTAs an SM holds (``ctas_per_sm``),
swept.

The shape is zamba2-7b's Mamba2 layer over an 8192-token prefill: b 1,
n 8192, 112 heads, dk = dv = 64, chunk 256, q and k head-broadcast views
(stride 0 over the heads) as the model hands them. Random bf16 inputs from
a seed; the log-decay slow to fast over the heads. Each setting is checked
against the plain version row by row (each (position, head) row within
2e-2 of that row's max |plain|, each head's final state likewise) and bit
for bit against the default, then timed with CUDA events over ``--iters``
calls cycling through ``--inputs`` input sets (L2 holds none of the next),
best of three, in two rounds of opposite order.

Run from the root of the checkout, on a machine with the card:

    PYTHONPATH=src python tools/chunked_sweep.py [--caps 1 2 3 4]

Prints the card, one line per setting (its occupancy as the card reports
it, µs per call in each round) and last a JSON object of the µs.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import chunked_linear as cl

B, N, H, DK, DV, CHUNK = 1, 8192, 112, 64, 64, 256


def inputs(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k = (r(B, N, 1, DK).to(torch.bfloat16).expand(B, N, H, DK)
            for _ in range(2))
    v = r(B, N, H, DV).to(torch.bfloat16)
    a = -F.softplus(r(B, N, H) + torch.linspace(-4.0, 1.0, H, device="cuda"))
    return q, k, v, a


def rows_within(got, want, tol=2e-2):
    err = (got.float() - want.float()).abs().amax(-1)
    return bool((err <= tol * want.float().abs().amax(-1)).all())


def time_us(call, n_inputs, iters):
    for i in range(n_inputs):
        call(i)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            call(i % n_inputs)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / iters * 1e3)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", type=int, nargs="*", default=[1, 2, 3, 4])
    ap.add_argument("--inputs", type=int, default=3)
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunked_sweep: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    xs = [inputs(seed) for seed in range(args.inputs)]
    want, st_want = cl.chunked_linear_attention_plain(*xs[0], chunk=CHUNK)
    settings = [None] + list(args.caps)
    ref = None
    for cap in settings:
        out, st = cl.chunked_linear_attention(*xs[0], chunk=CHUNK,
                                              ctas_per_sm=cap)
        torch.cuda.synchronize()
        if not (rows_within(out, want)
                and rows_within(st.flatten(2), st_want.flatten(2))):
            raise SystemExit(f"ctas_per_sm={cap}: #13 disagrees with its "
                             f"plain version")
        if ref is None:
            ref = (out, st)
        elif not (torch.equal(out, ref[0]) and torch.equal(st, ref[1])):
            raise SystemExit(f"ctas_per_sm={cap}: the bits moved")
    us = {str(c): [] for c in settings}
    for order in (settings, settings[::-1]):
        for cap in order:
            us[str(cap)].append(time_us(
                lambda i, cap=cap: cl.chunked_linear_attention(
                    *xs[i], chunk=CHUNK, ctas_per_sm=cap),
                args.inputs, args.iters))
    for cap in settings:
        occ = cl.occupancy(DK, DV, CHUNK, cap)
        print(f"ctas_per_sm={cap}{' (default)' if cap is None else ''}: "
              f"{occ} CTAs an SM, "
              + ", ".join(f"{t:.1f}" for t in us[str(cap)]) + " us/call "
              f"(b {B}, n {N}, {H} heads, dk {DK}, dv {DV}, chunk {CHUNK}; "
              f"CUDA events, rounds in opposite order)")
    print(json.dumps({"card": card.strip(), "us": us}))


if __name__ == "__main__":
    main()
