"""Serving CLI: single-context batch sampling with bifurcated attention.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --batch 16 --context 512 --steps 32 [--no-bifurcated] [--kernel]

``--arch zamba2-7b`` serves the Mamba2 hybrid: its prefill runs kernel
#13 (``chunked_linear_attention``) in every Mamba2 layer, and with
``--kernel`` its shared attention block decodes through the fused kernels.
``--arch xlstm-1.3b`` serves xLSTM: its prefill runs #13's wide path (two
launches a call) in every mLSTM layer; it has no attention to decode.
``--arch dbrx-132b`` / ``mixtral-8x7b`` serve the mixture-of-experts
family, ``internvl2-26b`` the VLM (``n_image_tokens`` random patch
embeddings before the context) and ``whisper-medium`` the encoder-decoder
(``--context`` random frames beside the ``--context`` decoder tokens), as
the reference's CLI makes those inputs.

Takes the flags of ``python -m repro.launch.serve``, plus ``--device``
(default cuda). Reduced config by default; --full serves the published
width, with seeded random weights. ``--cache-dtype int8`` quantizes the
shared context once and decodes it with the fused q8 kernel. Prints the
reference's banner plus the device and the kernel launch counts of the
run (the decode kernels' and #13's).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ServeConfig, get_config, reduced_config
from repro_torch.kernels import KERNELS
from repro_torch.kernels.bifurcated_decode import (
    context_flash_partials,
    fused_bifurcated_decode,
    fused_bifurcated_decode_q8,
)
from repro_torch.kernels.chunked_linear import chunked_linear_attention
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
                    help="context-arm KV dtype")
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
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["patch_embeds"] = torch.as_tensor(
            rng.randn(1, cfg.n_image_tokens, cfg.d_model) * 0.02,
            dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        kwargs["frames"] = torch.as_tensor(
            rng.randn(1, args.context, cfg.d_model) * 0.02,
            dtype=torch.float32, device=dev)
        if scfg.bifurcated:
            kwargs["sample_batch"] = args.batch
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=args.steps, batch=args.batch,
                             **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} bifurcated={engine.should_bifurcate(args.batch, args.context)} "
          f"cache_dtype={scfg.cache_dtype} "
          f"batch={args.batch} ctx={args.context} steps={args.steps}")
    print(f"device={dev} "
          f"fused_bifurcated_decode_launches={fused_bifurcated_decode.launches} "
          f"context_flash_partials_launches={context_flash_partials.launches} "
          f"fused_bifurcated_decode_q8_launches="
          f"{fused_bifurcated_decode_q8.launches} "
          f"chunked_linear_attention_launches="
          f"{chunked_linear_attention.launches}")
    print(f"wall {dt*1e3:.1f} ms  ({dt/args.steps*1e3:.2f} ms/step incl. prefill)")
    best = rank_by_mean_logprob(result, top_k=args.top_k)
    print(f"top-{args.top_k} by mean logprob: samples {best} "
          f"scores {[round(float(result.mean_logprob[i]), 3) for i in best]}")


if __name__ == "__main__":
    main()
