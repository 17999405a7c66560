"""The chunk rows' piece size and the share counts of the packed-step
kernels' split walk (#11, ``packed_fused_bifurcated_decode_q8``, int8
nodes; #10, ``packed_fused_bifurcated_decode``, bf16 nodes), measured on
the card.

The piece size (``kChunkPieceBlocks`` in
``src/repro_torch/kernels/csrc/decode_common.cuh``, mirrored by
``CHUNK_PIECE_BLOCKS`` in ``kernels/bifurcated_decode.py``) sets how many
fp32 partials each chunk row writes and the merge reads back, and how
finely a chunk tile's work can be shared out; it moves the chunk rows'
rounding, never their function or the decode rows' bits. This builds
copies of ``csrc/packed_decode.cu`` with the piece set to each of PIECES
blocks into ``build/packed_pieces/``, checks each against the plain
version at the same pieces and its decode rows bit-equal to the first
copy's, and times each at the share pairs of SHARES (decode rows' tiles,
chunk rows' tiles) by CUDA graph replay, in two rounds of opposite order,
at ``chip_smoke.py``'s main packed shape (phase 3d's trie, int8 or bf16
nodes, on pages of 128, its 32 x 64 decode arm, a 512-position chunk of
1024 rows under [SYS, TPL_A] at rows 300..811 of its envelope), cycling
N_INPUTS input sets; then torch.profiler's device time of the split and
merge kernels at ``packed_split_count``'s pair.

Run from the root of the checkout, on a machine with the card:

    PYTHONPATH=src python tools/packed_pieces.py [--nodes int8|bf16]

Prints the card, one line per piece size and share pair, and last a JSON
object of the µs per call in each round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (the main packed case and timers)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bifurcated_decode as bd  # noqa: E402

PIECES = (16, 32, 64)        # 64-key blocks a chunk row's piece holds
SHARES = ((8, 2), (8, 4), (16, 1), (16, 2), (16, 4), (16, 8), (33, 2),
          (33, 4))
N_INPUTS = 6
NAMES = {"int8": "packed_fused_bifurcated_decode_q8",
         "bf16": "packed_fused_bifurcated_decode"}


def build_pieces(name):
    """Compile one copy of the packed library per piece size, in parallel;
    return {blocks: library namespace with that copy's kernel ``name``}."""
    header = _build.HEADERS[0].read_text()
    pat = r"constexpr int kChunkPieceBlocks = \d+;"
    if not re.search(pat, header):
        raise RuntimeError("the header no longer holds kChunkPieceBlocks")
    src = _build.SOURCES["packed_decode"].read_text()
    procs = {}
    for n in PIECES:
        out = _build.BUILD_DIR.parent / "packed_pieces" / f"p{n}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "decode_common.cuh").write_text(
            re.sub(pat, f"constexpr int kChunkPieceBlocks = {n};", header))
        (out / "packed_decode.cu").write_text(src)
        so = out / "packed_decode.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
               str(out / "packed_decode.cu")]
        procs[n] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
    base = _build.library()
    libs = {}
    for n, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed at {n} blocks:\n{err[-4000:]}")
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes = _build.SIGNATURES["packed_decode"][name]
        fn.restype = ctypes.c_int
        libs[n] = types.SimpleNamespace(**dict(vars(base), **{name: fn}))
    return libs


def use(libs, n):
    """Route the wrapper to the copy of ``n``-block pieces (its scratch
    sized for them, its plain version cutting them)."""
    bd.CHUNK_PIECE_BLOCKS = n
    _build.library = lambda: libs[n]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", choices=sorted(NAMES), default="int8")
    quant = ap.parse_args().nodes == "int8"
    name = NAMES["int8" if quant else "bf16"]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(cs.card_line())
    libs = build_pieces(name)
    nan = float("nan")
    lens, req_paths = cs.served_trie()
    slot_paths = [req_paths[s * len(req_paths) // cs.BATCH]
                  for s in range(cs.BATCH)]
    fs = cs.TREE_TOKENS["SYS"] + cs.TREE_TOKENS["TPL_A"]
    cases = []
    for i in range(N_INPUTS):
        xt = cs.tree_inputs(cs.TREE_NODES, 8, cs.BATCH, 2, 1, 128,
                            cs.TREE_CAP, lens, slot_paths, cs.TREE_DEC_CAP,
                            seed=50 + i, quant=quant)
        yt = cs.paged_case(xt, quant, 128, seed=51 + i, spare=24, fill=nan)
        cases.append(cs.packed_case(yt, quant, cs.PACKED_CHUNK,
                                    cs.PACKED_BUF, fs, [0, 1], cs.TREE_CAP,
                                    52 + i))
    kern = getattr(bd, name)
    default = cs.packed_splits(cases[0])
    nd = cases[0]["nd"]

    def call(i, splits):
        z = cases[i]
        return kern(*cs.packed_args(z, quant), **cs.packed_kw(z),
                    splits=splits)

    first = None
    for n in PIECES:
        use(libs, n)
        out = call(0, default)
        want = getattr(bd, name + "_plain")(
            *cs.packed_args(cases[0], quant), **cs.packed_kw(cases[0]),
            splits=default)
        torch.cuda.synchronize()
        ok, err, rel = cs.within(out, want)
        first = out if first is None else first
        same = bool(torch.equal(out[:, :nd], first[:, :nd]))
        print(f"pieces of {n * 64} keys at S={default}: vs the plain "
              f"version max_abs_err={err:.3e} ({rel:.1e} of max |out|, gate "
              f"2e-2); decode rows bit-equal to {PIECES[0] * 64}-key "
              f"pieces' {same}")
        cs.check(ok and same, f"pieces of {n * 64} keys disagree")
    rounds = []
    for order in (PIECES, PIECES[::-1]):
        times = {}
        for n in order:
            use(libs, n)
            for s in SHARES:
                times[f"{n * 64} {s}"] = 1e3 * cs.time_ms_graph(
                    lambda i, s=s: call(i, s), N_INPUTS)
        rounds.append(times)
    for key in rounds[0]:
        print(f"pieces {key}: " + ", ".join(
            f"{r[key]:.1f}" for r in rounds) + " us/call")
    for n in PIECES:
        use(libs, n)
        cs.merge_share(f"{name} pieces of {n * 64} keys S={default}",
                       lambda i: call(i, default), N_INPUTS)
    print(json.dumps({"card": cs.card_line(), "kernel": name,
                      "default": list(default), "rounds": rounds}))


if __name__ == "__main__":
    main()
