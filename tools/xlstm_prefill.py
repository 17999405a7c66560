"""xlstm-1.3b's prefill on the card, at its published width and depth: the
ms of ``ServeEngine.prefill_shared`` over an 8192-token context for batch
32 (seeded random weights made on the card; the states broadcast to the
batch included), four decode steps on its states (ms/step and the states'
bytes), then one ``model.prefill`` with the sLSTM layers'
time-step loops timed (host clock around each layer, synchronised) and
kernel #13's calls timed on the device (CUDA events around each call: the
wide path, two launches per mLSTM layer), and #13 alone at the mLSTM's
shape (CUDA events). No profiler: a prefill is ~350,000 launches, most of
them the sLSTM loops'.

It uses only the port's public entry points, so the same file times
another checkout of the port: run it from that checkout's root, with its
``src`` on the path, in turns with this one, on one card and in one call.

    PYTHONPATH=src python <this file> [--reps 3] [--tag label]

Prints the card, the prefill ms of each rep, decode ms/step, the sLSTM and
#13 shares,
#13's time alone, and last a JSON object of them.
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
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_prefill: no CUDA device")
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels import chunked_linear as cl
    from repro_torch.models import get_model
    from repro_torch.models import xlstm
    from repro_torch.runtime.serve import ServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    cfg = get_config("xlstm-1.3b")
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    ctx = torch.randint(0, cfg.vocab_size, (1, CONTEXT),
                        generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    engine = ServeEngine(model, cfg, ServeConfig(
        batch=BATCH, context_len=CONTEXT, decode_capacity=24))
    t = args.tag
    t0 = time.perf_counter()
    engine.prefill_shared(params, ctx, BATCH)           # warm-up, build
    torch.cuda.synchronize()
    print(f"warm-up{t}: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        logits, cache = engine.prefill_shared(params, ctx, BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"prefill{t}: {cfg.name}, context {CONTEXT}, batch {BATCH}: "
          + ", ".join(f"{x:.1f}" for x in ms) + " ms (prefill_shared, host "
          "clock to a synchronise)", flush=True)
    tok = torch.argmax(logits, dim=-1)[:, None]
    step_ms = []
    for _ in range(4):      # decode steps on the last prefill's states
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    state_bytes = sum(x.numel() * x.element_size() for x in cache.values()
                      if isinstance(x, torch.Tensor))
    print(f"decode{t}: " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f" ms/step at batch {BATCH}; states {state_bytes} bytes",
          flush=True)
    del logits, cache

    # the sLSTM loops, each layer timed to a synchronise, and #13's calls
    # timed on the device
    real_s, slstm_ms = xlstm.apply_slstm_prefill, []
    real_k, events = xlstm.chunked_linear_attention, []

    def timed_s(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_s(*a, **kw)
        torch.cuda.synchronize()
        slstm_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    def timed_k(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_k(*a, **kw)
        ev[1].record()
        events.append(ev)
        return res

    xlstm.apply_slstm_prefill, xlstm.chunked_linear_attention = (timed_s,
                                                                 timed_k)
    n0 = cl.chunked_linear_attention.launches
    try:
        t0 = time.perf_counter()
        out = model.prefill(params, ctx)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
    finally:
        xlstm.apply_slstm_prefill = real_s
        xlstm.chunked_linear_attention = real_k
    del out
    k13_ms = sum(a.elapsed_time(b) for a, b in events)
    k13_n = cl.chunked_linear_attention.launches - n0
    print(f"slstm{t}: model.prefill {whole:.1f} ms, of which the "
          f"{len(slstm_ms)} sLSTM layers {sum(slstm_ms):.1f} ms "
          f"({sum(slstm_ms) / whole:.1%}; per layer "
          + ", ".join(f"{x:.0f}" for x in slstm_ms) + ")")
    print(f"k13{t}: {len(events)} calls, {k13_n} launches, {k13_ms:.2f} ms "
          f"on the device (CUDA events; {k13_ms / whole:.1%} of the "
          f"prefill)", flush=True)

    # #13 alone at the mLSTM's shape, on one layer's operands
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, nh, hd = xlstm._dims(cfg)
    q, k, v = (torch.randn(1, CONTEXT, nh, hd, generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    a = torch.nn.functional.logsigmoid(
        torch.randn(1, CONTEXT, nh, generator=gen, device="cuda") + 3.0)
    call = lambda: cl.chunked_linear_attention(  # noqa: E731
        q, k, v, a, chunk=cfg.ssm.chunk, normalize=True)
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        call()
    stop.record()
    stop.synchronize()
    k13_call_ms = start.elapsed_time(stop) / 10

    print(f"k13 alone{t}: {k13_call_ms * 1e3:.1f} us a call (two launches) "
          f"at b 1, n {CONTEXT}, H {nh}, dk {hd}, dv {hd} + 1, chunk "
          f"{cfg.ssm.chunk}")
    print(json.dumps({"tag": t, "card": card.strip(), "prefill_ms": ms,
                      "decode_ms": step_ms, "state_bytes": state_bytes,
                      "model_prefill_ms": whole, "slstm_ms": slstm_ms,
                      "k13_ms": k13_ms,
                      "k13_launches": k13_n, "k13_call_ms": k13_call_ms}))


if __name__ == "__main__":
    main()
