"""zamba2-7b's prefill on the card, at its published width: the ms of
``ServeEngine.prefill_shared`` over an 8192-token context for batch 32
(seeded random weights made on the card, bifurcated cache, kernels on),
and one profiled prefill's device time, kernel #13's
(``chunked_linear_kernel``, one launch per Mamba2 layer) beside the
whole.

It uses only the port's public entry points, so the same file times
another checkout of the port (the commit before a change to #13, say): run
it from that checkout's root, with its ``src`` on the path, and in turns
with this one, on one card and in one call.

    PYTHONPATH=src python <this file> [--reps 5] [--tag label]

Prints the card, the prefill ms of each rep, the profile line, and last a
JSON object of them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

CONTEXT, BATCH = 8192, 32


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hybrid_prefill: no CUDA device")
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    cfg = get_config("zamba2-7b")
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    ctx = torch.randint(0, cfg.vocab_size, (1, CONTEXT),
                        generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    engine = ServeEngine(model, cfg, ServeConfig(
        batch=BATCH, context_len=CONTEXT, decode_capacity=24,
        bifurcated=True, use_kernel=True))
    engine.prefill_shared(params, ctx, BATCH)           # warm-up, build
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        logits, cache = engine.prefill_shared(params, ctx, BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del logits, cache
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = engine.prefill_shared(params, ctx, BATCH)
        torch.cuda.synchronize()
    del out
    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in dev)
    k13 = [e for e in dev if "chunked_linear_kernel" in e.key]
    k13_us = sum(getattr(e, "self_device_time_total", 0.0) for e in k13)
    k13_n = sum(e.count for e in k13)
    print(f"prefill{args.tag}: {cfg.name}, context {CONTEXT}, batch {BATCH}:"
          f" " + ", ".join(f"{t:.1f}" for t in ms) + " ms (host clock to a "
          f"synchronise)")
    print(f"profile{args.tag}: one prefill, device time {total / 1e3:.2f} ms "
          f"in {sum(e.count for e in dev)} launches; #13 "
          f"{k13_us / 1e3:.2f} ms in {k13_n} launches "
          f"({k13_us / max(total, 1e-9):.1%})")
    print(json.dumps({"tag": args.tag, "card": card.strip(), "prefill_ms": ms,
                      "device_ms": total / 1e3, "k13_ms": k13_us / 1e3,
                      "k13_launches": k13_n}))


if __name__ == "__main__":
    main()
