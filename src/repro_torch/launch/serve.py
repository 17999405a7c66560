"""Serving CLI: single-context batch sampling with bifurcated attention.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --batch 16 --context 512 --steps 32 [--no-bifurcated] [--kernel]

Takes the flags of ``python -m repro.launch.serve``, plus ``--device``
(default cuda). Reduced config by default; --full serves the published
width, with seeded random weights. Prints the reference's banner plus the
device and the kernel launch counts of the run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ServeConfig, get_config, reduced_config
from repro_torch.kernels.bifurcated_decode import (
    context_flash_partials,
    fused_bifurcated_decode,
)
from repro_torch.models import get_model
from repro_torch.runtime.serve import ServeEngine, rank_by_mean_logprob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--no-bifurcated", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="use the fused CUDA decode kernel")
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=["bfloat16", "int8"],
                    help="context-arm KV dtype (int8 is not ported yet)")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    scfg = ServeConfig(
        batch=args.batch, context_len=args.context,
        decode_capacity=max(16, args.steps + 8),
        bifurcated=not args.no_bifurcated, use_kernel=args.kernel,
        cache_dtype=args.cache_dtype,
    )
    model = get_model(cfg)
    params = model.init(0, device=dev)
    engine = ServeEngine(model, cfg, scfg)

    rng = np.random.RandomState(0)
    ctx = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, args.context)),
                          device=dev)
    fused_bifurcated_decode.launches = 0
    context_flash_partials.launches = 0
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=args.steps, batch=args.batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} bifurcated={engine.should_bifurcate(args.batch, args.context)} "
          f"cache_dtype={scfg.cache_dtype} "
          f"batch={args.batch} ctx={args.context} steps={args.steps}")
    print(f"device={dev} "
          f"fused_bifurcated_decode_launches={fused_bifurcated_decode.launches} "
          f"context_flash_partials_launches={context_flash_partials.launches}")
    print(f"wall {dt*1e3:.1f} ms  ({dt/args.steps*1e3:.2f} ms/step incl. prefill)")
    best = rank_by_mean_logprob(result, top_k=args.top_k)
    print(f"top-{args.top_k} by mean logprob: samples {best} "
          f"scores {[round(float(result.mean_logprob[i]), 3) for i in best]}")


if __name__ == "__main__":
    main()
