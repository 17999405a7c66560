"""Ablations of the port's flash prefill kernel (#12) on the card: where its
time goes.

Builds copies of ``src/repro_torch/kernels/csrc/flash_prefill.cu``, each
with one part of the kernel's work taken out, into ``build/ablation/``, and
times each beside the kernel as it stands and one
``scaled_dot_product_attention`` call at the main prefill shape (b 1, n
8192, h 16, g 8, hd 128, causal), in two rounds of opposite order. The
copies compute wrong outputs: they say only what each part costs.

  no_softmax   the products and the pipeline; P is the raw logits
  no_products  the softmax and the pipeline; no wgmma is issued
  no_exp2      the softmax with a multiply in place of each exp2

Run from the root of the checkout, on a machine with the card:

    PYTHONPATH=src python tools/flash_ablation.py [--reps 20]

Prints the card, one line per version, and last a JSON object of the
µs per launch of each version in each round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import flash_prefill as fp

SHAPE = dict(b=1, n=8192, h=16, g=8, hd=128)
ABLATIONS = {
    "no_softmax": [("      softmax(w.jb);\n", ""),
                   ("        softmax(j);\n", "")],
    "no_products": [
        ("      wgmma_ss_n128(\n", "      if (a.causal > 1) wgmma_ss_n128(\n"),
        ("      wgmma_rs<HD>(o, pf[kk],\n",
         "      if (a.causal > 1) wgmma_rs<HD>(o, pf[kk],\n")],
    "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                 "y = x * 1e-3f;")],
}


def build_ablations():
    """Compile every ablated copy in parallel; return {name: C function}."""
    src = _build.SOURCES["flash_prefill"].read_text()
    out = _build.BUILD_DIR.parent / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r}")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
        fn = ctypes.CDLL(str(so)).flash_prefill_attention
        fn.argtypes = _build.SIGNATURES["flash_prefill"][
            "flash_prefill_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn):
    """A call of C function ``fn`` as the wrapper makes it, at one split."""
    def call(q, k, v):
        b, n, h, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None, b, n, k.shape[1], h, k.shape[2], hd, 0, 0, 1, 1,
                 hd**-0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def time_us(fn, xs, reps):
    """µs per call over ``reps`` calls cycling the input sets, warmed up."""
    for x in xs:
        fn(*x)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(*xs[i % len(xs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else
          torch.cuda.get_device_name(0))
    b, n, h, g, hd = (SHAPE[k] for k in ("b", "n", "h", "g", "hd"))
    if fp.split_count(b, n, n, g, h // g, causal=True, window=0, q_offset=0,
                      sms=torch.cuda.get_device_properties(0)
                      .multi_processor_count) != 1:
        raise SystemExit("the shape would split its keys")
    xs = []
    for seed in range(3):    # ~100 MB each: L2 holds none of the others
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xs.append([torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((b, n, h, hd), (b, n, g, hd), (b, n, g, hd))])
    versions = {"kernel": lambda q, k, v: fp.flash_prefill_attention(q, k, v)}
    versions.update({name: launcher(fn)
                     for name, fn in build_ablations().items()})
    versions["sdpa"] = lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    flop = 4 * hd * b * h * n * (n + 1) // 2
    times = {name: [] for name in versions}
    for order in (list(versions), list(versions)[::-1]):
        for name in order:
            times[name].append(time_us(versions[name], xs, args.reps))
    for name, ts in times.items():
        print(f"{name}: " + ", ".join(f"{t:.1f}" for t in ts) + " us/launch "
              f"({flop / min(ts) / 1e6:.0f} TFLOP/s of the causal work)")
    print(json.dumps({name: [round(t, 1) for t in ts]
                      for name, ts in times.items()}))


if __name__ == "__main__":
    main()
