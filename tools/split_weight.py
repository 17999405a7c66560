"""The bf16 context weight of the split walk (``kCtxWeightBf16`` in
``src/repro_torch/kernels/csrc/decode_common.cuh``, mirrored by
``CTX_WEIGHT_BF16`` in ``kernels/bifurcated_decode.py``), measured on the
card.

The weight is a bf16 context block's CTA time in decode blocks: it sets
how the split walk of the fused decode kernel (#1, ``fused_bifurcated_
decode``) balances its CTAs, never its bits. This builds copies of
``csrc/bifurcated_decode.cu`` with the weight set to each of WEIGHTS into
``build/split_weight/``, and times each at its default split, by CUDA
graph replay, at the main decode shape (g 8, 64 rows, hd 128, m_c 8192,
32 x 24 decode slots) and at zamba2's shared block (g 32, 32 rows, hd
112), in two rounds of opposite order; the outputs of every copy are
checked bit-equal to the first's.

Run from the root of the checkout, on a machine with the card:

    PYTHONPATH=src python tools/split_weight.py [--replays 20]

Prints the card, one line per shape and weight, and last a JSON object of
the µs per call of each weight in each round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bifurcated_decode as bd

WEIGHTS = (1, 2, 3)
# (name, g, b, p, hd, m_c, c_d)
SHAPES = (("main", 8, 32, 2, 128, 8192, 24),
          ("hd 112", 32, 32, 1, 112, 8192, 24))
N_INPUTS = 8     # context sets cycled per call: L2 holds none of the next


def build_weights():
    """Compile one copy of the bf16 decode library per weight, in
    parallel; return {weight: C function fused_bifurcated_decode}."""
    header = _build.HEADERS[0].read_text()
    pat = r"constexpr int kCtxWeightBf16 = \d+;"
    if not re.search(pat, header):
        raise RuntimeError("the header no longer holds kCtxWeightBf16")
    src = _build.SOURCES["bifurcated_decode"].read_text()
    procs = {}
    for w in WEIGHTS:
        out = _build.BUILD_DIR.parent / "split_weight" / f"w{w}"
        out.mkdir(parents=True, exist_ok=True)
        # the copy's own header first on the include path (same directory)
        (out / "decode_common.cuh").write_text(
            re.sub(pat, f"constexpr int kCtxWeightBf16 = {w};", header))
        (out / "bifurcated_decode.cu").write_text(src)
        so = out / "bifurcated_decode.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
               str(out / "bifurcated_decode.cu")]
        procs[w] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
    fns = {}
    for w, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed at weight {w}:\n{err[-4000:]}")
        fn = ctypes.CDLL(str(so)).fused_bifurcated_decode
        fn.argtypes = _build.SIGNATURES["bifurcated_decode"][
            "fused_bifurcated_decode"]
        fn.restype = ctypes.c_int
        fns[w] = fn
    return fns


def inputs(g, b, p, hd, m_c, c_d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    ld = b * c_d
    live = (torch.arange(c_d, device="cuda")[None, :]
            < torch.randint(1, c_d + 1, (b, 1), generator=gen, device="cuda"))
    bias = torch.where(live.reshape(1, ld), 0.0, -1e30).float()
    q = r(g, b * p, hd)
    ctx = [(r(g, m_c, hd), r(g, m_c, hd)) for _ in range(N_INPUTS)]
    return q, ctx, r(g, ld, hd), r(g, ld, hd), bias


def launcher(fn, q, ctx, kd, vd, bias, c_d, pn, splits):
    """Call i of C function ``fn`` on context set i, as the wrapper makes
    it, into its own output."""
    g, rows, hd = q.shape
    m_c = ctx[0][0].shape[1]
    n_pieces = bd.max_pieces(1, m_c, c_d)
    part = bd._split_scratch(q, splits, n_pieces)
    outs = [torch.empty_like(q) for _ in ctx]

    def call(i):
        err = fn(q.data_ptr(), ctx[i][0].data_ptr(), ctx[i][1].data_ptr(),
                 kd.data_ptr(), vd.data_ptr(), bias.data_ptr(),
                 outs[i].data_ptr(), part.data_ptr(), g, rows, m_c,
                 kd.shape[1], hd, c_d, pn, splits, n_pieces, hd**-0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call, outs


def graph_us(call, n, replays):
    """µs per call of ``call(0..n-1)`` captured in one CUDA graph and
    replayed ``replays`` times (after a warm-up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n):
            call(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * n)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else
          torch.cuda.get_device_name(0))
    fns = build_weights()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for name, g, b, p, hd, m_c, c_d in SHAPES:
        q, ctx, kd, vd, bias = inputs(g, b, p, hd, m_c, c_d, seed=hd)
        splits = bd.split_count(b * p, g, sms=sms)
        calls = {w: launcher(fn, q, ctx, kd, vd, bias, c_d, p, splits)
                 for w, fn in fns.items()}
        for w, (call, outs) in calls.items():
            call(0)
        torch.cuda.synchronize()
        first = calls[WEIGHTS[0]][1][0]
        for w, (_, outs) in calls.items():
            if not torch.equal(outs[0], first):
                raise SystemExit(f"{name}: weight {w} changed the bits")
        times = {w: [] for w in WEIGHTS}
        for order in (WEIGHTS, WEIGHTS[::-1]):
            for w in order:
                times[w].append(graph_us(calls[w][0], N_INPUTS, args.replays))
        for w, ts in times.items():
            n_ctx, n_dec = -(-m_c // bd.KEY_BLOCK), -(-b * c_d // bd.KEY_BLOCK)
            shares = bd.split_shares([n_ctx], n_dec, splits, ctx_weight=w)
            (i0, i1), (b0, b1) = max(
                shares, key=lambda sh: w * (sh[0][1] - sh[0][0])
                + sh[1][1] - sh[1][0])
            print(f"{name} (g {g}, {b * p} rows, hd {hd}, m_c {m_c}, S "
                  f"{splits}): weight {w}: " + ", ".join(f"{t:.1f}" for t in ts)
                  + f" us/call (graph replay); heaviest share {i1 - i0} "
                  f"context + {b1 - b0} decode blocks")
        result[name] = {w: [round(t, 2) for t in ts]
                        for w, ts in times.items()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
