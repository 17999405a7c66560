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
     8192/6000/2500/777, the tree kernels over phase 3d's trie, 8 nodes of
     capacity 4096, both over the served 32 x 64 decode slots), once with
     random inputs and once with a partly masked decode arm that carries
     most of the softmax mass, and at ragged shapes (m_c off the block
     size, two fresh positions per sample, rows off the row tile, hd=80,
     one segment against the single-prefix kernel, a 0-length segment, a
     segment id outside [0, G); node lengths 0/1/63/64/65, a depth-1 path
     beside depth-3 ones, a node twice on one path, ids outside [-1, N),
     and every path one level deep against the grouped kernels, bit for
     bit). The paged kernels run on pools of shuffled pages: the single
     prefix on 64 pages of 128 (bit for bit the single-prefix kernels),
     the trie on pages of 128, 64, 48 and 16 (bit for bit the tree
     kernels), a hole, a page id past the pool (its rows NaN), and free
     pages full of NaN against zeros there (bit-identical). The packed
     kernels run on the paged trie with a chunk of 512 positions (1024
     rows) under [SYS, TPL_A] at rows 300..811 of its envelope (position
     6144): a decode-only call bit for bit the paged kernels', the decode
     rows' bits unmoved by the chunk, and on the ragged trie (pages of 48,
     a tile of decode and chunk rows) fresh_len 0/1/63/64/65, a chunk at
     position 0 with no ancestors, an id outside [-1, N] on the chunk's
     path (its rows NaN; N itself poisons nothing). fp32 queries must
     raise TypeError (the kernels take bf16 only). Every decode kernel
     runs split (the default: S = split_count CTAs per row tile and kv
     head; #10 / #11 packed_split_count, a pair for their decode rows' and
     their chunk rows' tiles) against its plain version at the same S, #1
     / #2 / #3 at the main, ragged and hd 112 shapes, #2 also at S 4 and
     16 and on m_c 1000 at S 64, #4 and #5 on every forest above and the
     same at S 4 and 64; #8 = #6 and #9 = #7 bit for bit at the default
     split on every trie above, #1 = #8 and #3 = #9 on the single prefix
     on 64 shuffled pages of 128 (at the default split and at splits=1),
     #5 = #7 and #4 = #6 on the depth-1 trie (at the default split and at
     splits=1), #5 = #3 and #4 = #1 at G = 1 (at the default split; within
     the gate, the line saying whether the bits differ), and #10 = #8 (#11
     = #9) on the decode rows at the same S with and without the chunk,
     and at splits=1, their output the same at S 4 and at twice their
     chunk tiles' S; the default split lies within the gate of splits=1 at
     the main shapes; S = 64 against plain (#1 / #3 at m_c 1000, n 2; the
     ragged trie on pages of 48, #8 = #6 and #9 = #7 there); and a merge
     without the rescale exp(m_s - m) or with a row's last piece dropped
     misses the gate by far for #1-#7 and #10 (#10 on both its decode rows
     and its chunk rows, on a case whose envelope dominates).
     Every gate is max |kernel - plain| <= tol x max |plain| (bf16 2e-2),
     and the script shows that plain versions with the decode arm
     dropped, its mask ignored, another sample's slots read, another
     group's segment read, the V scales dropped, the trie's root level
     dropped, another request's leaf read, another segment's page table
     read, the ragged tail of a page read, the chunk's causal mask dropped,
     fresh_start off by one, the decode arm leaking into the chunk rows or
     the envelope leaking into the decode rows miss that gate by far.
     Flash prefill (#12) runs at the main prefill shape (b 1, n 8192, h 16,
     g 8, hd 128, causal), at phase 3h's suffix (A2's 500 tokens at
     q_offset 6144 over [SYS, TPL_A]'s keys), with a window of 4096 at n
     8192, g 1, hd 80, n and m off the tile, n 1, non-causal, and a window
     of 512 whose softmax is decided at its edge key. Its gate is taken
     row by row (each query and head's max error <= 2e-2 x that row's max
     |plain|), since a causal prefill's late rows are much smaller than
     its first; fp32 raises TypeError; plain versions with the causal mask
     dropped, q_offset ignored, the window one key wider, query head h on
     kv head h % g, and, past n / 2 only, l x 1.5 or each tile's own key
     block dropped miss that gate by far. #1/#2/#3 also run at zamba2's
     shared-block shape (32 kv heads of hd 112, 32 rows each, m_c 8192 and
     1000). Chunked linear attention (#13) runs at the slice's shape (b 1,
     n 8192, 112 heads, dk = dv = 64, chunk 256, q and k head-broadcast
     views as Mamba2 hands them), at n 8000, 33 and 1, dk 32 / dv 16, with
     the normaliser column, from an initial state, at b 4 and at the
     reduced config's 8-wide heads; its gate is per (batch, position,
     head) row of the output and per head of the final state; fp32 raises
     TypeError; plain versions with the state not carried across chunks,
     the inter-chunk term without e^{A_i}, an exclusive cumsum, the causal
     mask dropped, the padded rows given a nonzero decay (the state gate),
     and, from an initial state, the state handed to the wrong chunk or
     the initial state dropped, miss it by far. #13's wide path (heads past
     128, two launches a call) runs at the mLSTM's shape (b 1, n 8192, 4
     heads, dk = dv = 1024, normalised: 1025 columns, chunk 256), at n
     1000 and 1, from an initial state, at dk 512 / dv 1024, b 3 and
     136-wide heads, under the same per-row gate; the same call twice
     gives the same bits and leaves the sync words zero; plain versions
     with the first dk block dropped from the inter sum, the first state
     block's chain not carried, or the normaliser taken from another
     block's column miss it by far;
  3. serve internlm2-1.8b at its published width (seeded random weights)
     with ServeEngine.generate: bifurcated cache, fused kernel, batch 32,
     context 8192, 16 steps. The fused kernel must launch 24 layers x 15
     decode steps times. Prints decode ms/step of the same generate with
     the fused kernel at splits=1 and at its default split, in turns, and
     the wrapper's host us per call at each. Then, after 8 more decode
     steps so that 9 decode slots are live, one decode step on the kernel
     path against the plain impl="flash" path, layer by layer on the same
     input and for the whole step, torch.profiler over one step (the fused
     kernel's device time per step, split + merge, beside the same at
     splits=1), and the two-pass dispatch (the partials kernel) over the
     served cache against the fused one;
  3b. the same generate with the int8 context arm (cache_dtype="int8"):
     the q8 kernel must launch 24 x 15 times; decode ms/step and host us
     per call at splits=1 and the default split as in 3; per-layer
     attention of the kernel path against the kernel's plain versions;
     int8-vs-bf16 whole-step logits printed as information;
  3c. ForestServeEngine at the same width, bf16 and int8 segments: 4
     segments of capacity 8192 with contexts of 8192/6000/2500/777 tokens,
     8 samples each in 32 slots, decode capacity 64, grouped kernels. 15
     steps must launch the grouped kernel 24 x 15 times; per-layer and
     whole-step logits are held against the single-prefix kernel path of
     each group; then the 2500-token group is cancelled and retired, a
     4000-token request takes its segment and slots, 8 more steps run, and
     the three untouched groups' greedy tokens must be bit-identical to a
     run without the retire and readmit; torch.profiler over one forest
     step of each (#4's and #5's device time, split + merge, beside the
     same at splits=1) and #4's and #5's wrapper's host us per call;
  3d. TreeServeEngine at the same width, bf16 and int8 nodes: a prefix trie
     of 8 nodes of capacity 4096 (a 4096-token system prompt, templates of
     2048 and 1024 tokens under it, leaves of 1200 and 500 under the first
     and of 1800 and 300 under the second), one request of 8 samples per
     leaf in 32 slots, decode capacity 64, tree kernels. 15 steps must
     launch the tree kernel 24 x 15 times; per-layer and whole-step logits
     are held against the single-prefix kernel path of each request over
     its path's nodes concatenated; then the 500-token leaf's request is
     cancelled and retired, [system prompt, first template, a 900-token
     leaf] is admitted (two levels reused, one node written), 8 more steps
     run, and the three untouched requests' greedy tokens must be
     bit-identical to a run without the cancel and readmit; torch.profiler
     over one bf16 trie step (the tree kernel's device time and share,
     split + merge, beside the same at splits=1);
  3e. the three engines with ctx_store="paged" (pages of 128), bf16 and
     int8: ServeEngine on phase 3's workload, ForestServeEngine on phase
     3c's over a 160-page pool (below its 256-page envelope: the
     readmission must raise PoolExhausted before the retire and fit after
     it, into freed pages filled with NaN first), TreeServeEngine on phase
     3d's trie (reused ancestors cost no page). Each must launch the paged
     kernel 24 x 15 times and hold per layer against its plain versions.
     Gated token comparisons, bit for bit: the single prefix's tokens (#8,
     #9 at the default split) against phase 3's and 3b's (#1, #3 at the
     default split: the same pieces); the forest's against phase 3c's
     (#8 = #4, #9 = #5 at the default split); the trie's against phase
     3d's (#8 = #6, #9 = #7 at the same split);
  3f. TreeServeEngine(step_mode="packed", suffix_prefill=True,
     prefill_chunk=512) on the paged store (pages of 128), bf16 and int8
     nodes, phase 3d's prompts: [SYS, TPL_A, A1] is prefilled in 15 chunks
     riding on 15 steps; [SYS, TPL_A, A2] (1 chunk) and [SYS, TPL_B, B1]
     (6 chunks) while it decodes; [SYS, TPL_B, B2] must raise
     PrefillInFlight while TPL_B is pending and change nothing, and is
     admitted after it lands (1 chunk); then 8 decode-only steps. The
     packed kernel must launch 24 x 23 times and the paged kernel 24 x 8,
     no other; per layer on a step with live decode rows and a chunk, the
     packed kernel against its plain versions at the kernel's default S;
     torch.profiler over one bf16 packed step (#10's device time, split +
     merge, beside the same at splits=1); each request's first-token
     logits against a synchronous admission of its path, and every node
     the chunks wrote against a full prefill, within max(2e-2 x max, 1.5 x
     a run of the plain versions); reused ancestors cost no page; no slot
     emits before its request activates. For bf16 nodes the same requests
     and steps run again in fp32 (forward, nodes and decode arms; the
     plain versions), where each request's packed first-token logits must
     agree with its synchronous admission's within 1e-3 x max |logit|:
     the bf16 gap is precision, not a fault of the chunk path. Prints
     packed-step and decode-only ms/step and each admission's time to its
     first token;
  3g. ServeEngine.generate with train_attn="flash" at phase 3's workload:
     #12 must launch 24 times per prefill and the fused decode kernel 24 x
     15 times; prefill logits and the first decode step's logits against
     the chunked path within max(2e-2 x max |logit|, 1.5 x the plain
     versions' distance); prefill ms, flash beside chunked, in turns;
  3h. TreeServeEngine(prefix_cache=True, suffix_prefill=True) under
     train_attn="flash", dense and paged (pages of 128), bf16 and int8
     nodes, 5 nodes (paged: 75 pages), phase 3d's prompts, beside an
     evict-eagerly engine: [SYS, TPL_A, A1] admitted, 2 steps, retired (3
     nodes cached, pages held); [SYS, TPL_A, A2] revives two levels, #12
     launching 24 times at q_offset 6144, 6144 tokens reused, the revived
     K/V bit-equal, first-token logits against the eager engine's within
     the whole-step gate; then [SYS, TPL_B, B1] must evict A1's node and
     [SYS, TPL_A, A3] A2's (and, paged, B1's for pages), and three fresh
     levels must raise SegmentsExhausted and change nothing; prints the
     revival's admission ms beside the eager engine's cold one;
  3j. the serving layer (runtime/frontend, faults, journal, recovery,
     checkpoint.ServeCheckpointer) at the same width: a DurableFrontend
     over a paged TreeServeEngine (12 nodes, a pool of 64 pages of 128,
     packed steps of 512-token chunks, the prefix cache, the sharing
     policy, greedy), bf16 and int8 nodes, serving 8 requests of 4 samples
     ([a 4096-token system prompt, one of two 512-token templates, a
     256-token suffix]) 16 tokens each, snapshots every 3 rounds in a
     temporary directory removed at the end. Gates: two KILL_PROCESS
     events, each recovered from snapshot + journal, end every ticket's
     status and greedy tokens bit-identical to an uninterrupted control on
     the same card; under a mixed plan (bf16: pages stolen, a request
     cancelled mid-decode, the newest snapshot corrupted, the journal's
     tail torn, a kill) every ticket no fault touched is bit-identical to
     the control, recovery falls back past the corrupt snapshot, an audit
     passes every round and the KV checksums after each recovery; a
     flipped bit of a live node's K fails audit_state(verify_checksums=
     True) with KVCorruption; #8/#9 and #10/#11 launch 24 times per
     decode-only and packed step run, replays included, and no other
     kernel; no request is quarantined. Then a dense bf16
     ForestServeEngine (4 segments of capacity 2048) killed twice ends
     bit-identical to its control (#4, 24 launches a step). Only
     ProcessKilled is caught; nothing runs under supervise. Prints the
     admission work and the node checksums' share of it, snapshot bytes
     and save ms (fsync'd), load and recovery ms, the journal records
     replayed and decode ms/step under the frontend;
  4. (first, then phase 3's model and caches are freed) time each kernel
     at the main path's shapes beside its bound, its plain
     version and, as a yardstick only, one scaled_dot_product_attention call
     computing the same function (the port never calls it); the paged
     kernels at the single-prefix shape and on the paged trie, the packed
     kernels at phase 2's main packed shape over phase 3e's paged trie,
     flash prefill at the main prefill shape and at phase 3h's suffix.
     #1-#11 (split, faster than their wrapper's host work)
     and their yardsticks are timed by CUDA graph replay, with their plain
     versions at the same S, a sweep over S = 1, 4, 8, 16, 32 (#2, #10,
     #11: 1, 2, 4, 8, 16, 32; #10 / #11 also their chunk tiles' S alone)
     and the default on one line per kernel and shape, and for #1-#6,
     #8, #10 and #11 the merge kernel's share of the call
     (torch.profiler), and #10's / #11's wrapper's host us per call;
  3i. serve zamba2-7b at its published width (81 Mamba2 layers, d 3584,
     the shared attention block applied 13 times, hd 112; seeded random
     weights made on the card) with ServeEngine.generate: bifurcated
     cache, fused kernels, batch 32, context 8192, 16 steps, bf16 and int8
     context. Each generate must launch #13 exactly 81 times (its prefill)
     and the fused kernel (int8: its q8 twin) 13 x 15 times, no other
     kernel; #13's output and final state at Mamba2 layers 0, 40 and 80 of
     the prefill against its plain version on the same inputs (per-row
     gate); prefill logits and the first decode step's logits of the
     kernel path against an fp32 run of the same path on the plain
     versions (weights widened from the same bf16), within max(2e-2 x
     max |logit|, 1.5 x the bf16 plain versions' distance from it); prints
     prefill ms and decode ms/step (and at splits=1, in turns), the
     wrapper's host us per call, the fused kernel's device time per
     profiled step at the default split and at splits=1, and #13's device
     time in one profiled bf16 prefill;
  4i. time #13 on phase 3i's recorded inputs (three layers of the bf16
     prefill) beside its bound and its plain version (no library call
     computes it), swept over the CTAs an SM holds (its ctas_per_sm cap 1,
     2, 3 and none; the bits unmoved), and #1 and #3 at the hybrid's shape
     over its 13 served context caches as in phase 4 (graph-timed, the S
     sweep, the merge's share);
  3k. serve xlstm-1.3b at its published width and depth (48 layers: 6
     groups of 7 mLSTM + 1 sLSTM, d 2048, 4 heads, mLSTM heads of 1024,
     chunk 256; seeded random weights made on the card) with
     ServeEngine.generate: batch 32, context 8192, 16 steps, bf16, sampled.
     The generate must launch #13 exactly 2 x 42 times (its wide path in
     each mLSTM layer of the prefill) and no other kernel; #13's output and
     final state at mLSTM layers 0, 20 and 41 against its plain version on
     the same inputs (per-row gate); the first 4 samples' prefill logits
     and first decode step's logits against an fp32 run of the same path
     on the plain versions at batch 4 (weights widened from the same
     bf16), within max(2e-2 x max |logit|, 1.5 x the bf16 plain versions'
     distance from it), and, since a random-weight xLSTM this deep ends
     its bf16 and fp32 paths far apart whatever the kernels do, every
     layer of the prefill and the first decode step fed the fp32 path's
     own input, its increment held to the witness's within max(2e-2 x
     max, 1.5 x the plain versions' distance). Prints prefill ms, the
     sLSTM loops' share of it,
     #13's device time in the prefill (CUDA events around each call),
     decode ms/step and the states' bytes;
  4k. time #13's wide path on phase 3k's recorded inputs (three mLSTM
     layers of the prefill) beside its bound and its plain version;
  3l. the other model families at their published widths, seeded random
     weights made on the card (each leaf cast as drawn), batch 32, one
     model on the card at a time: dbrx-132b at 8 of its 40 layers (16
     experts of 6144 x 10752, top 4; 48 q / 8 kv heads: p 6, 192 query
     rows a kv head) with ServeEngine.generate over a context of 8192, 16
     steps, bf16 then int8 context (#1 then #3, 8 x 15 launches each), then
     a ForestServeEngine of two prompts (8192 and 2500 tokens, 8 samples
     each, one chunk of 8 steps: #4, 8 x 8 launches); mixtral-8x7b at 16 of
     its 32 layers under train_attn="flash" (#12 with its 4096 window, 16
     launches a prefill; its 8 decode steps leave the kernels for the
     flash path, as in the reference); internvl2-26b whole (48 layers,
     1024 patch embeddings before the 8192 text tokens: #1/#3 over 9216
     keys at p 6); whisper-medium whole (8192 frames and 8192 decoder
     tokens, as the CLI makes them at --context 8192: #1/#3 at g 16, p 1,
     hd 64; its prefill also under flash, #12 non-causal in the encoder
     and the cross-attention). Each generate must launch its kernel L
     times per decode step and no other kernel; every decode kernel at
     these shapes on every layer's served context (#4 on the forest's
     segments) against its plain version (2e-2 of max |out|); one decode
     step walked layer by layer on the plain versions' own stream, each
     layer's attention on the kernel path against its plain versions, and
     for the MoE the router's expert choices for the kernel stream's
     input against the plain's: a row may choose differently only where
     the plain row's k-th and (k+1)-th router logits lie within 2e-2 of
     its largest |logit| (a near-tie that rounding flips; the flipped rows
     are printed), and moe_decode on the other rows within 2e-2; the whole
     step's logits, kernel path against the plain impl="flash" path, within
     max(2e-2 x max |logit|, 1.5 x the kernels' plain versions' distance);
     the flash prefills' last logits against the chunked ones within the
     same gate; for the MoE the kernel and plain-version runs of these
     whole-path gates take the reference run's expert choices (a flipped
     near-tie moves a token by a whole expert's share, and in a prefill
     every later token through attention and capacity), the choices they
     would have flipped printed; and mixtral's flash prefill layer by
     layer: #12 against its plain version row by row and the routing of
     every token as above. Prints each model's prefill ms and decode
     ms/step and its elapsed line, then times #1 and #3 at p 6 (dbrx's
     served caches) and at hd 64 (whisper's) by CUDA graph replay, and #12
     at mixtral's windowed and whisper's non-causal shapes, beside their
     bounds, plain versions and SDPA yardsticks;
  5. print the kernels' JSON line (#13 at both widths; #1, #3 and #12 also
     at phase 3l's shapes, named by shape), then the result line, last.

Imports torch and the port only; needs a checkout of the repository (it
builds the kernels from its sources) and a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense tensor-core bf16
TOL = 2e-2    # bf16: every gate is max |err| <= TOL x max |ref|
DEVICE = "cuda"
CARD = ["not read yet"]     # nvidia-smi's name and power limit, set by main


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gap(got, want):
    """max |got - want| and max |want|, as floats."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def within(got, want, tol=TOL):
    """The gate of every comparison here: max |got - want| <= tol x
    max |want|, so it scales with the outputs (one bf16 ulp is 2^-8 of a
    value); returns (ok, max abs error, relative error)."""
    err, ref = gap(got, want)
    return err <= tol * ref, err, err / ref


def within_rows(got, want, tol=TOL):
    """#12's gate, row by row: every (batch, query, head) row's max
    |got - want| <= tol x that row's max |want|. A causal prefill's first
    rows average a few values and are large, its late rows average
    thousands and are small, so the whole-output gate of ``within`` would
    pass a fault confined to late rows. Returns (ok, max abs error, the
    worst row's relative error)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    rel = (err / want.abs().amax(-1).clamp(min=1e-30)).max().item()
    return rel <= tol, err.max().item(), rel


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
    # (template arguments: head dim, FUSED, Q8, mode)
    kinds = {"100": "fused", "000": "partials", "110": "fused_q8",
             "101": "grouped", "111": "grouped_q8", "102": "tree",
             "112": "tree_q8", "103": "paged", "113": "paged_q8",
             "104": "packed", "114": "packed_q8"}
    for path in paths.values():
        name, spill = None, ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"decode_kernelILi(\d+)ELb([01])ELb([01])"
                              r"ELi(\d)E", line)
                sp = re.search(r"split_kernelILi(\d+)ELi(\d)ELb([01])E",
                               line)
                mg = re.search(r"merge_kernelILi(\d+)ELb([01])E", line)
                f = re.search(r"flash_prefill_kernelILi(\d+)E", line)
                c = re.search(r"chunked_linear_kernelILi(\d+)E", line)
                if m:
                    flags = "".join(m.group(2, 3, 4))
                    name = f"hd={m.group(1)} {kinds.get(flags, flags)}"
                elif sp:
                    mode = {"0": "single", "1": "grouped", "2": "tree",
                            "3": "paged", "4": "packed"}[sp.group(2)]
                    name = (f"hd={sp.group(1)} split {mode}"
                            f"{' q8' if sp.group(3) == '1' else ''} "
                            f"({path.stem.split('-')[0]})")
                elif mg:
                    name = (f"hd={mg.group(1)} merge"
                            f"{'' if mg.group(2) == '1' else ' partials'} "
                            f"({path.stem.split('-')[0]})")
                elif f:
                    name = f"hd={f.group(1)} flash prefill"
                else:
                    name = f"d={c.group(1)} chunked linear" if c else None
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


def partials_gaps(got, want):
    """#2's (acc, m, l) against another's: (ok, acc max abs error, its
    share of max |acc|, acc / l's share of max |acc / l|, m's and l's
    largest relative errors). Gates: acc and acc / l within TOL of their
    max; m and l (fp32 sums of the same products in another order) 1e-4."""
    (acc_k, m_k, l_k), (acc_p, m_p, l_p) = got, want
    ok_a, err_a, rel_a = within(acc_k, acc_p)
    ok_n, _, rel_n = within(acc_k / l_k[..., None], acc_p / l_p[..., None])
    err_m = ((m_k - m_p).abs() / (1 + m_p.abs())).max().item()
    err_l = ((l_k - l_p).abs() / l_p.abs()).max().item()
    ok = ok_a and ok_n and err_m <= 1e-4 and err_l <= 1e-4
    return ok, err_a, rel_a, rel_n, err_m, err_l


def check_case(name, x, splits=None):
    """Kernel vs plain on one case (#1 and #2 at ``splits``, default their
    default split, their plain versions at the same S); returns the max
    abs errors of the fused output and of the partials' acc."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    args = (x["q"], x["kc"], x["vc"], x["kd"], x["vd"], x["bias"])
    sk = split_kw(x, splits)
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"], **sk)
    out_k = bd.fused_bifurcated_decode(*args, **kw)
    out_p = bd.fused_bifurcated_decode_plain(*args, **kw)
    part_k = bd.context_flash_partials(*args[:3], scale=x["scale"], **sk)
    part_p = bd.context_flash_partials_plain(*args[:3], scale=x["scale"],
                                             **sk)
    torch.cuda.synchronize()
    ok_f, err_f, rel_f = within(out_k, out_p)
    ok_a, err_a, rel_a, rel_n, err_m, err_l = partials_gaps(part_k, part_p)
    print(f"check {name}: fused S={kw['splits']} max_abs_err={err_f:.3e} "
          f"({rel_f:.1e} of max |out|), partials S={kw['splits']} acc "
          f"{err_a:.3e} ({rel_a:.1e} of max |acc|), acc/l {rel_n:.1e}, m "
          f"rel {err_m:.3e}, l rel {err_l:.3e} (gates: {TOL:g} of max; m, "
          f"l 1e-4)")
    check(ok_f, f"{name}: fused kernel disagrees with its plain version")
    check(ok_a, f"{name}: partials kernel disagrees with its plain version")
    check(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite")
    return err_f, err_a


def check_fp32_raises(x):
    """The kernels take bf16 queries only: fp32 CUDA operands raise
    TypeError and launch nothing (fp32 runs the plain versions on the
    CPU)."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    args = (x["q"], x["kc"], x["vc"], x["kd"], x["vd"], x["bias"])
    before = read_launches()
    for call in (lambda: bd.fused_bifurcated_decode(
                     *args, scale=x["scale"], c_d=x["c_d"], pn=x["pn"]),
                 lambda: bd.context_flash_partials(*args[:3],
                                                   scale=x["scale"]),
                 lambda: bd.fused_bifurcated_decode_q8(
                     *q8_args(quantized(x)), scale=x["scale"], c_d=x["c_d"],
                     pn=x["pn"])):
        try:
            call()
        except TypeError:
            continue
        raise AssertionError("a kernel took fp32 queries on the card")
    torch.cuda.synchronize()
    check(read_launches() == before, "an fp32 call launched a kernel")
    print("check fp32 queries: TypeError from the fused, partials and fused "
          "q8 wrappers, no launch")


def decode_arm_share(x, m, l):
    """The least share of any row's softmax mass (per kv head) that its
    decode arm carries, given the context arm's running max ``m`` and sum
    ``l`` (both (g, rows), f32) and each row's own live decode slots."""
    import torch

    q, kd, bias = x["q"], x["kd"], x["bias"]
    g, rows, hd = q.shape
    b, c_d = rows // x["pn"], x["c_d"]
    s = torch.einsum("grh,gbch->grbc", q.float(),
                     kd.float().reshape(g, b, c_d, hd)) * x["scale"]
    own = s[:, torch.arange(rows, device=DEVICE),
            torch.arange(rows, device=DEVICE) // x["pn"]]      # (g, rows, c_d)
    own = own + bias.reshape(b, c_d).repeat_interleave(x["pn"], 0)
    top = torch.maximum(m, own.amax(-1))
    dec = torch.exp(own - top[..., None]).sum(-1)
    return (dec / (dec + l * torch.exp(m - top))).min().item()


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
    share = decode_arm_share(x, m, l)
    c_d = x["c_d"]
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
        check(v >= 10 * TOL, f"{name}: the gate misses '{k}'")


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


def check_q8(name, x, splits=None):
    """The fused q8 kernel vs its plain version on one case (#3 at
    ``splits``, default the default split, its plain version at the same
    S); returns the max abs error."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"],
              **split_kw(x, splits))
    out_k = bd.fused_bifurcated_decode_q8(*q8_args(x), **kw)
    out_p = bd.fused_bifurcated_decode_q8_plain(*q8_args(x), **kw)
    torch.cuda.synchronize()
    ok, err, rel = within(out_k, out_p)
    print(f"check {name}: q8 S={kw['splits']} max_abs_err={err:.3e} ({rel:.1e}"
          f" of max |out|, gate 2e-2)")
    check(ok, f"{name}: q8 kernel disagrees with its plain version")
    check(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite")
    return err


def check_grouped(name, x, quant, splits=None):
    """A grouped kernel vs its plain version on one case (#4 / #5 at
    ``splits``, default the default split, its plain version at the same
    S): both NaN on the rows of a segment id outside [0, G) and nowhere
    else, within the gate on the others; returns the max abs error."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kern = (bd.grouped_fused_bifurcated_decode_q8 if quant
            else bd.grouped_fused_bifurcated_decode)
    plain = (bd.grouped_fused_bifurcated_decode_q8_plain if quant
             else bd.grouped_fused_bifurcated_decode_plain)
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"],
              **split_kw(x, splits))
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
    print(f"check {name}: {'grouped q8' if quant else 'grouped'}"
          f" S={kw['splits']} max_abs_err={err:.3e} ({rel:.1e} of max "
          f"|out|, gate 2e-2)"
          + (f"; {int(bad.sum())} rows of an id outside [0, G) NaN"
             if bad.any() else ""))
    check(ok, f"{name}: grouped kernel disagrees with its plain version")
    return err


def check_forest_split(x, xd, quant):
    """Phase 2's split cases of #4 / #5 (``quant``) beyond check_grouped's
    default split: the main forest ``x`` at S 4 and 64 bit-equal to the
    default, and the default within the gate of splits=1; two faulty
    merges of the plain version missing the gate on the decode-dominant
    main forest ``xd``."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    kern = (bd.grouped_fused_bifurcated_decode_q8 if quant
            else bd.grouped_fused_bifurcated_decode)
    num = "#5" if quant else "#4"
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    S = default_splits(x["q"])
    out = kern(*grouped_args(x, quant), **kw)
    same = [same_bits(kern(*grouped_args(x, quant), **kw, splits=s), out)
            for s in (4, 64)]
    ok, err, rel = within(out, kern(*grouped_args(x, quant), **kw, splits=1))
    print(f"check {'int8' if quant else 'bf16'} main forest: S=4 and S=64 "
          f"bit-equal to the default (S={S}) {same}; the default vs "
          f"splits=1 max_abs_err={err:.3e} ({rel:.1e} of max |out|, gate "
          f"2e-2)")
    check(all(same), f"{num}'s output moves with S")
    check(ok, f"{num}'s split walk disagrees with its single walk")
    args = grouped_args(xd, quant)
    if not quant:       # _grouped_plain's scales: none for bf16 segments
        args = args[:3] + (None, None) + args[3:]
    pkw = dict(scale=xd["scale"], c_d=xd["c_d"], pn=xd["pn"],
               block_m=bd.BLOCK_M, splits=S)
    want = bd._grouped_plain(*args, **pkw)
    rels = {k: within(bd._grouped_plain(*args, **pkw, merge=f), want)[2]
            for k, f in faulty_merges().items()}
    print(f"check {num} split merge, main forest decode-dominant masked "
          f"S={S}: a faulty merge's error / max |out|: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(v >= 10 * TOL, f"{num} split merge: the gate misses '{k}'")


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
    check(rel_v >= 10 * TOL, f"{name}: the gate misses a q8 "
          f"plain version without V scales")
    check(rel_g >= 10 * TOL, f"{name}: the gate misses a grouped "
          f"plain version reading another group's segment")


FOREST_LENS = (8192, 6000, 2500, 777)
FOREST_DEC_CAP = 64     # phase 3c's decode capacity

# phase 3d's trie: a system prompt, two templates under it, two leaves
# under each template; four requests (one per leaf), 8 samples each
TREE_TOKENS = {"SYS": 4096, "TPL_A": 2048, "TPL_B": 1024, "A1": 1200,
               "A2": 500, "B1": 1800, "B2": 300, "A3": 900}
TREE_REQUESTS = (("SYS", "TPL_A", "A1"), ("SYS", "TPL_A", "A2"),
                 ("SYS", "TPL_B", "B1"), ("SYS", "TPL_B", "B2"))
TREE_READMIT = ("SYS", "TPL_A", "A3")       # replaces the A2 request
TREE_NODES, TREE_DEPTH, TREE_CAP, TREE_DEC_CAP = 8, 3, 4096, 64
TREE_STEPS, TREE_MORE = 15, 8


def served_trie():
    """Phase 3d's node ids in admission order, their lengths (N,), and each
    request's path: SYS 0, TPL_A 1, A1 2, A2 3, TPL_B 4, B1 5, B2 6; node 7
    stays free."""
    ids, paths = {}, []
    for req in TREE_REQUESTS:
        for name in req:
            ids.setdefault(name, len(ids))
        paths.append([ids[name] for name in req])
    lens = [0] * TREE_NODES
    for name, nid in ids.items():
        lens[nid] = TREE_TOKENS[name]
    return lens, paths


def tree_inputs(n_nodes, g, b, p, n, hd, cap, lens, slot_paths, c_d, seed,
                masked=False, dec_boost=0.0, quant=False):
    """Random tree-kernel operands: ``n_nodes`` nodes of capacity ``cap``
    with live lengths ``lens``; slot i reads the nodes of
    ``slot_paths[i]`` (padded with -1 to the deepest path); the decode arm
    as in ``kernel_inputs``."""
    import torch

    x = kernel_inputs(g, b, p, n, hd, 8, c_d, torch.bfloat16, seed,
                      masked=masked, dec_boost=dec_boost)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    shape = (n_nodes, g, cap, hd)
    x["kc"] = torch.randn(shape, generator=gen, device=DEVICE)
    x["vc"] = torch.randn(shape, generator=gen, device=DEVICE)
    depth = max(len(pth) for pth in slot_paths)
    table = [list(pth) + [-1] * (depth - len(pth)) for pth in slot_paths]
    x["paths"] = torch.tensor(table, dtype=torch.int32, device=DEVICE
                              ).T.repeat_interleave(p * n, dim=1).contiguous()
    x["node_lens"] = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    if quant:
        return quantized(x)
    x["kc"], x["vc"] = x["kc"].to(torch.bfloat16), x["vc"].to(torch.bfloat16)
    return x


def default_splits(q):
    """The share count #1-#3 and #6-#9 take by default for queries ``q``
    on this card (``split_count``)."""
    from repro_torch.kernels import bifurcated_decode as bd

    return bd.split_count(q.shape[1], q.shape[0],
                          sms=bd._sm_count(q.device.index))


def split_kw(x, splits=None):
    """The ``splits`` keyword of a kernel that splits (#1-#3, #6-#9):
    ``splits``, or the default split, so that a plain version walks the
    kernel's shares."""
    return {"splits": default_splits(x["q"]) if splits is None else splits}


@contextlib.contextmanager
def single_walk():
    """#1-#11 at splits=1 for the duration of a ``with`` block (their
    wrappers' default split forced to 1): for the single walk's profiles
    and timings (``profile_splits``, ``decode_ms_in_turns``)."""
    from repro_torch.kernels import bifurcated_decode as bd

    saved = bd.split_count, bd.packed_split_count
    bd.split_count = lambda *a, **k: 1
    bd.packed_split_count = lambda *a, **k: (1, 1)
    try:
        yield
    finally:
        bd.split_count, bd.packed_split_count = saved


def tree_args(x, quant):
    ctx = ((x["kc"], x["vc"], x["ks"], x["vs"]) if quant
           else (x["kc"], x["vc"]))
    return (x["q"],) + ctx + (x["paths"], x["node_lens"], x["kd"], x["vd"],
                              x["bias"])


def tree_kernel(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.tree_fused_bifurcated_decode_q8 if quant
            else bd.tree_fused_bifurcated_decode)


def tree_plain(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.tree_fused_bifurcated_decode_q8_plain if quant
            else bd.tree_fused_bifurcated_decode_plain)


def check_tree(name, x, quant, splits=None):
    """A tree kernel vs its plain version on one case (at ``splits``,
    default the default split, its plain version at the same S): both NaN
    on the rows whose path holds an id outside [-1, N) and nowhere else,
    within the gate on the others; returns the max abs error."""
    import torch

    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"],
              **split_kw(x, splits))
    out_k = tree_kernel(quant)(*tree_args(x, quant), **kw)
    out_p = tree_plain(quant)(*tree_args(x, quant), **kw)
    torch.cuda.synchronize()
    n_nodes = x["node_lens"].numel()
    bad = ((x["paths"] < -1) | (x["paths"] >= n_nodes)).any(0)
    for out, which in ((out_k, "kernel"), (out_p, "plain version")):
        nan = torch.isnan(out.float()).any(-1).any(0)
        check(bool(torch.equal(nan, bad)),
              f"{name}: the {which}'s NaN rows "
              f"{nan.nonzero().flatten().tolist()} are not the rows of ids "
              f"outside the table")
    check(bool(torch.isfinite(out_k[:, ~bad].float()).all()),
          f"{name}: non-finite")
    ok, err, rel = within(out_k[:, ~bad], out_p[:, ~bad])
    print(f"check {name}: {'tree q8' if quant else 'tree'} "
          f"S={kw['splits']} max_abs_err={err:.3e} ({rel:.1e} of max "
          f"|out|, gate 2e-2)"
          + (f"; {int(bad.sum())} rows of an id outside [-1, N) NaN"
             if bad.any() else ""))
    check(ok, f"{name}: tree kernel disagrees with its plain version")
    return err


def check_tree_gate_sensitivity(name, x):
    """Two faulty plain versions of #6 on the main-shape trie: one drops
    the root level, one reads another request's leaf. Each must miss the
    kernel gate by at least tenfold."""
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    plain = tree_plain(False)
    want = plain(*tree_args(x, False), **kw)
    paths = x["paths"]
    rows_per_req = paths.shape[1] // len(TREE_REQUESTS)
    faults = {"root level dropped": paths.clone(),
              "another request's leaf": paths.clone()}
    faults["root level dropped"][0] = -1
    faults["another request's leaf"][-1] = paths[-1].roll(rows_per_req)
    rels = {k: within(plain(*tree_args(dict(x, paths=v), False), **kw),
                      want)[2] for k, v in faults.items()}
    print(f"check {name}: a faulty version's error / max |out|: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(v >= 10 * TOL, f"{name}: the gate misses '{k}'")


def check_tree_decode_share(name, x):
    """The decode arm's least share of any row's softmax mass on a trie
    case, with the context mass taken over each row's distinct path nodes'
    live keys; it must be at least half."""
    import torch

    q, kc = x["q"].float(), x["kc"].float()
    n_nodes, g, cap, hd = kc.shape
    rows = q.shape[1]
    on = torch.zeros(rows, n_nodes, dtype=torch.bool, device=DEVICE)
    for lvl in x["paths"].long():
        ok = (lvl >= 0) & (lvl < n_nodes)
        on[ok.nonzero().flatten(), lvl[ok]] = True
    live = (torch.arange(cap, device=DEVICE)[None, :]
            < x["node_lens"][:, None])                       # (N, cap)
    s = torch.einsum("grh,ngkh->grnk", q, kc) * x["scale"]
    s = s.masked_fill(~(on[:, :, None] & live[None]), float("-inf"))
    s = s.flatten(2)
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).nan_to_num(0.0).sum(-1)
    share = decode_arm_share(x, m, l)
    print(f"check {name}: decode arm carries >= {share:.3f} of every row's "
          f"softmax mass")
    check(share >= 0.5, f"{name}: the decode arm does not dominate")


def check_tree_depth_one(quant):
    """Every path one level deep: the tree kernel must compute the
    grouped kernel's bits, #7 = #5 and #6 = #4 at the default split and on
    the single walk (splits=1)."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    gen = torch.Generator().manual_seed(26)
    slot_paths = [[int(i)] for i in torch.randint(0, 4, (32,),
                                                  generator=gen)]
    x = tree_inputs(4, 8, 32, 2, 1, 128, 2049, (2049, 0, 77, 1000),
                    slot_paths, 24, seed=26, masked=True, quant=quant)
    kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
    ctx = tree_args(x, quant)[:-5]
    kern = (bd.grouped_fused_bifurcated_decode_q8 if quant
            else bd.grouped_fused_bifurcated_decode)
    for splits in (None, 1):
        sk = split_kw(x, splits)
        tree = tree_kernel(quant)(*tree_args(x, quant), **kw, **sk)
        grouped = kern(*ctx, x["paths"][0].contiguous(), x["node_lens"],
                       x["kd"], x["vd"], x["bias"], **kw, **sk)
        torch.cuda.synchronize()
        same = bool(torch.equal(tree, grouped))
        err = within(tree, grouped)[1]
        print(f"check {'int8 ' if quant else ''}depth-1 trie N=4 lens "
              f"2049/0/77/1000: tree vs grouped kernel at S={sk['splits']} "
              f"bit-equal {same} (max_abs_err={err:.3e})")
        check(same, f"depth 1, S={sk['splits']}: the tree kernel is not the "
                    f"grouped kernel")


def check_tree_kernels():
    """Phase 2's cases of #6 and #7; returns {kernel name: max abs error
    over the main-shape cases}."""
    lens, req_paths = served_trie()
    slot_paths = [req_paths[s * len(req_paths) // BATCH]
                  for s in range(BATCH)]
    tmain = (f"N={TREE_NODES} cap={TREE_CAP} lens="
             f"{'/'.join(map(str, lens))} depth={TREE_DEPTH} g=8 rows=64 "
             f"hd=128 ld={BATCH * TREE_DEC_CAP} bf16")
    out = {}
    for quant, kname in ((False, "tree_fused_bifurcated_decode"),
                         (True, "tree_fused_bifurcated_decode_q8")):
        tag = "int8 " if quant else ""
        x = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                        slot_paths, TREE_DEC_CAP, seed=30, quant=quant)
        dominant = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP,
                               lens, slot_paths, TREE_DEC_CAP, seed=31,
                               masked=True, dec_boost=3.0, quant=quant)
        if not quant:
            check_tree_gate_sensitivity(f"main {tmain}", x)
            # the int8 case below is this case's data, quantized
            check_tree_decode_share(f"main {tmain} decode-dominant masked",
                                    dominant)
        out[kname] = max(
            check_tree(f"main {tag}{tmain}", x, quant),
            check_tree(f"main {tag}{tmain} decode-dominant masked",
                       dominant, quant))
        # node lengths 0/1/63/64/65, a depth-1 slot beside depth-3 ones,
        # a node twice on one path, ids N and -2 outside the table
        ragged = [[5, 1, 2], [3], [5, 4, 4], [0, 3, 6], [2, 2], [6, 1],
                  [5, 1, 2], [7], [4, -2, 1]]
        check_tree(f"{tag}N=7 lens 0/1/63/64/65/200/130, depth 1 beside 3, "
                   f"a repeated node, ids outside [-1, N)",
                   tree_inputs(7, 8, 9, 2, 1, 128, 200,
                               (0, 1, 63, 64, 65, 200, 130), ragged, 5,
                               seed=32, masked=True, quant=quant), quant)
        cycle = [[0, 1], [0, 4], [3], [0, 1, 2], [4, 3]]
        check_tree(f"{tag}n=2 p=2 hd=80 rows=96 N=5 cap=700",
                   tree_inputs(5, 8, 24, 2, 2, 80, 700, (700, 333, 0, 64, 129),
                               [cycle[i % 5] for i in range(24)], 9, seed=33,
                               masked=True, quant=quant), quant)
        check_tree_depth_one(quant)
    return out


def single_case(x, quant):
    """A single-prefix case of ``kernel_inputs`` as a one-node trie: its
    context the node, every row's path [0]."""
    import torch

    if quant:
        x = quantized(x)
    y = dict(x, node_lens=torch.tensor([x["kc"].shape[1]], dtype=torch.int32,
                                       device=DEVICE),
             paths=torch.zeros(1, x["q"].shape[1], dtype=torch.int32,
                               device=DEVICE))
    for n in ("kc", "vc", "ks", "vs"):
        if n in y:
            y[n] = y[n][None]
    return y


def paged_case(x, quant, pm, seed, spare=0, fill=0.0):
    """The trie case ``x`` (of ``tree_inputs``) with its nodes moved onto
    shuffled pool pages of ``pm`` keys, ``spare`` pool pages more than the
    live ones. Every page no table entry names holds ``fill`` (the int8
    values 127 when ``fill`` is not 0); a live page's tail holds the node's
    dense keys past its length. Adds kp, vp (ksp, vsp), tables (N, ppn)
    int32 and seg_lens."""
    import torch

    n_nodes, g, cap, hd = x["kc"].shape
    lens = x["node_lens"].tolist()
    ppn = -(-cap // pm)
    need = [min(-(-max(m, 0) // pm), ppn) for m in lens]
    n_pages = sum(need) + spare
    perm = torch.randperm(n_pages,
                          generator=torch.Generator().manual_seed(seed))
    tables = torch.full((n_nodes, ppn), -1, dtype=torch.int32)
    at = 0
    for nid, k in enumerate(need):
        tables[nid, :k] = perm[at:at + k].to(torch.int32)
        at += k
    tables = tables.to(DEVICE)
    live = tables >= 0
    y = dict(x, tables=tables, seg_lens=x["node_lens"])
    names = [("kc", "kp"), ("vc", "vp")]
    if quant:
        names += [("ks", "ksp"), ("vs", "vsp")]
    for src, dst in names:
        c = x[src]
        rest = tuple(c.shape[3:])
        f = fill if c.dtype != torch.int8 else (127 if fill != 0 else 0)
        pad = torch.zeros((n_nodes, g, ppn * pm - cap) + rest, dtype=c.dtype,
                          device=DEVICE)
        slabs = torch.cat([c, pad], dim=2).reshape(
            (n_nodes, g, ppn, pm) + rest).transpose(1, 2)
        pool = torch.full((n_pages, g, pm) + rest, f, dtype=c.dtype,
                          device=DEVICE)
        pool[tables[live].long()] = slabs[live]
        y[dst] = pool
    return y


def paged_args(y, quant):
    pool = ((y["kp"], y["vp"], y["ksp"], y["vsp"]) if quant
            else (y["kp"], y["vp"]))
    return (y["q"],) + pool + (y["tables"], y["seg_lens"], y["paths"],
                               y["kd"], y["vd"], y["bias"])


def paged_kernel(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.paged_fused_bifurcated_decode_q8 if quant
            else bd.paged_fused_bifurcated_decode)


def paged_plain(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.paged_fused_bifurcated_decode_q8_plain if quant
            else bd.paged_fused_bifurcated_decode_plain)


def paged_bad_rows(y):
    """The rows the paged kernels write as NaN: a path id outside [-1, N),
    or a segment whose live pages name an id outside [-1, P)."""
    import torch

    tables, paths = y["tables"], y["paths"].long()
    n_segs, ppn = tables.shape
    pm, n_pages = y["kp"].shape[2], y["kp"].shape[0]
    need = (y["seg_lens"].long() + pm - 1) // pm
    live = torch.arange(ppn, device=DEVICE)[None, :] < need[:, None]
    poisoned = (live & ((tables < -1) | (tables >= n_pages))).any(1)
    inside = (paths >= 0) & (paths < n_segs)
    return (((paths < -1) | (paths >= n_segs))
            | (inside & poisoned[paths.clamp(0, n_segs - 1)])).any(0)


def check_paged(name, y, quant, splits=None):
    """A paged kernel vs its plain version on one case (at ``splits``,
    default the default split, its plain version at the same S): both NaN
    on the rows of ``paged_bad_rows`` and nowhere else, within the gate on
    the others. Returns (max abs error, the kernel's output)."""
    import torch

    kw = dict(scale=y["scale"], c_d=y["c_d"], pn=y["pn"],
              **split_kw(y, splits))
    out_k = paged_kernel(quant)(*paged_args(y, quant), **kw)
    out_p = paged_plain(quant)(*paged_args(y, quant), **kw)
    torch.cuda.synchronize()
    bad = paged_bad_rows(y)
    for out, which in ((out_k, "kernel"), (out_p, "plain version")):
        nan = torch.isnan(out.float()).any(-1).any(0)
        check(bool(torch.equal(nan, bad)),
              f"{name}: the {which}'s NaN rows "
              f"{nan.nonzero().flatten().tolist()} are not the rows of bad "
              f"ids")
    check(bool(torch.isfinite(out_k[:, ~bad].float()).all()),
          f"{name}: non-finite")
    ok, err, rel = within(out_k[:, ~bad], out_p[:, ~bad])
    print(f"check {name}: {'paged q8' if quant else 'paged'} "
          f"S={kw['splits']} max_abs_err={err:.3e} ({rel:.1e} of max "
          f"|out|, gate 2e-2)"
          + (f"; {int(bad.sum())} rows of bad ids NaN" if bad.any() else ""))
    check(ok, f"{name}: paged kernel disagrees with its plain version")
    return err, out_k


def same_bits(a, b):
    """Bit-equal, NaN rows included (NaN where the other is NaN)."""
    import torch

    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


def check_paged_gate_sensitivity(yt, yr):
    """Two faulty plain versions of #8 miss the gate: one reads another
    segment's page table (main trie ``yt``), one ignores the ragged tail
    (reads whole pages; the ragged trie ``yr``, whose pages' tails hold
    other keys)."""
    import torch

    plain = paged_plain(False)

    def rel(y, **fault):
        kw = dict(scale=y["scale"], c_d=y["c_d"], pn=y["pn"])
        want = plain(*paged_args(y, False), **kw)
        got = plain(*paged_args(dict(y, **fault), False), **kw)
        bad = paged_bad_rows(y)
        return within(got[:, ~bad], want[:, ~bad])[2]

    pm = yr["kp"].shape[2]
    whole_pages = ((yr["seg_lens"] + pm - 1) // pm * pm).clamp(
        max=yr["tables"].shape[1] * pm).to(torch.int32)
    rels = {"another segment's page table":
            rel(yt, tables=yt["tables"].roll(1, 0).contiguous()),
            "ragged tail ignored": rel(yr, seg_lens=whole_pages)}
    print("check paged plain versions: a faulty version's error / max "
          "|out|: " + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(v >= 10 * TOL, f"paged: the gate misses '{k}'")


def check_paged_kernels():
    """Phase 2's cases of #8 and #9; returns {kernel name: max abs error
    over the main-shape cases}."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    nan = float("nan")
    lens, req_paths = served_trie()
    slot_paths = [req_paths[s * len(req_paths) // BATCH]
                  for s in range(BATCH)]
    ragged = [[5, 1, 2], [3], [5, 4, 4], [0, 3, 6], [2, 2], [6, 1],
              [5, 1, 2], [7], [4, -2, 1]]
    out = {}
    yt0 = yr0 = None
    for quant, kname in ((False, "paged_fused_bifurcated_decode"),
                         (True, "paged_fused_bifurcated_decode_q8")):
        tag = "int8 " if quant else ""
        kern = paged_kernel(quant)
        kw = dict(scale=128**-0.5, c_d=24, pn=2)
        # the main single prefix: 8192 keys on 64 shuffled pages of 128, in
        # a pool with 16 free pages of NaN; bit for bit #1 (#3)
        x1 = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, torch.bfloat16,
                           seed=40)
        y1 = paged_case(single_case(x1, quant), quant, 128, seed=41,
                        spare=16, fill=nan)
        err1, out1 = check_paged(
            f"main {tag}single prefix g=8 rows=64 hd=128: 8192 keys on 64 "
            f"shuffled pages of 128, 16 free pages of NaN, ld=768", y1,
            quant)
        # #1 (#3) cuts #8's (#9's) pieces: the same bits at the default
        # split, and at splits=1 (the single walks)
        xs = quantized(x1) if quant else x1
        fname = "fused q8" if quant else "fused"

        def fused(**k):
            if quant:
                return bd.fused_bifurcated_decode_q8(*q8_args(xs), **kw, **k)
            return bd.fused_bifurcated_decode(xs["q"], xs["kc"], xs["vc"],
                                              xs["kd"], xs["vd"], xs["bias"],
                                              **kw, **k)

        for splits, paged_out in ((None, out1), (1, None)):
            one = fused(**({} if splits is None else {"splits": 1}))
            if paged_out is None:
                paged_out = kern(*paged_args(y1, quant), **kw, splits=1)
            torch.cuda.synchronize()
            same = bool(torch.equal(paged_out, one))
            at = (f"the default split (S={default_splits(xs['q'])})"
                  if splits is None else "splits=1")
            print(f"check {tag}single prefix: {fname} vs paged kernel at "
                  f"{at} bit-equal {same}")
            check(same, f"{at}: the paged kernel is not the single-prefix "
                        f"kernel")
        # phase 3d's trie in an oversubscribed pool (112 pages against an
        # envelope of 256), free pages NaN, against the same pool with
        # zeros there and against #6 (#7) on the dense nodes
        xt = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                         slot_paths, TREE_DEC_CAP, seed=42, quant=quant)
        yt = paged_case(xt, quant, 128, seed=43, spare=24, fill=nan)
        zt = paged_case(xt, quant, 128, seed=43, spare=24)
        tkw = dict(scale=xt["scale"], c_d=xt["c_d"], pn=xt["pn"])
        err2, out2 = check_paged(
            f"main {tag}trie N={TREE_NODES} lens {'/'.join(map(str, lens))} "
            f"on 88 shuffled pages of 128 + 24 free of NaN", yt, quant)
        zero = kern(*paged_args(zt, quant), **tkw)
        tree = tree_kernel(quant)(*tree_args(xt, quant), **tkw)
        torch.cuda.synchronize()
        nan_same, tree_same = (bool(torch.equal(out2, zero)),
                               bool(torch.equal(out2, tree)))
        print(f"check {tag}main trie: free pages NaN vs 0 bit-identical "
              f"{nan_same}; paged vs tree kernel bit-equal {tree_same}")
        check(nan_same, "a free page of the pool was read")
        check(tree_same, "the paged kernel is not the tree kernel")
        # its decode-dominant masked twin, on pages of 64
        xd = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                         slot_paths, TREE_DEC_CAP, seed=44, masked=True,
                         dec_boost=3.0, quant=quant)
        err3, out3 = check_paged(f"main {tag}trie decode-dominant masked, "
                                 f"pages of 64",
                                 paged_case(xd, quant, 64, seed=45), quant)
        check(bool(torch.equal(out3, tree_kernel(quant)(
            *tree_args(xd, quant), **tkw))),
            "decode-dominant: the paged kernel is not the tree kernel")
        out[kname] = max(err1, err2, err3)
        # the ragged trie: lengths 0/1/63/64/65/200/130 inside pages of 16,
        # 48 (a block straddles pages) and 64, ids outside [-1, N)
        xr = tree_inputs(7, 8, 9, 2, 1, 128, 200,
                         (0, 1, 63, 64, 65, 200, 130), ragged, 5, seed=46,
                         masked=True, quant=quant)
        rkw = dict(scale=xr["scale"], c_d=xr["c_d"], pn=xr["pn"])
        tr = tree_kernel(quant)(*tree_args(xr, quant), **rkw)
        for pm in (16, 48, 64):
            yr = paged_case(xr, quant, pm, seed=47 + pm, spare=5, fill=nan)
            _, outr = check_paged(
                f"{tag}N=7 lens 0/1/63/64/65/200/130 on pages of {pm}, ids "
                f"outside [-1, N)", yr, quant)
            same = same_bits(outr, tr)
            print(f"check {tag}ragged trie, pages of {pm}: paged vs tree "
                  f"kernel bit-equal {same}")
            check(same, f"pages of {pm}: the paged kernel is not the tree "
                        f"kernel")
            if pm == 64 and not quant:
                yr0 = yr
        # a hole inside the root's live keys (masked, never read), and a
        # live page id past the pool on node 5 (its rows NaN)
        tables = yt["tables"].clone()
        tables[0, 3] = -1
        tables[5, 0] = yt["kp"].shape[0] + 7
        check_paged(f"{tag}main trie, a hole in the root's table row and a "
                    f"page id past the pool", dict(yt, tables=tables), quant)
        if not quant:
            yt0 = zt
    # fp32 queries raise
    x = tree_inputs(7, 8, 9, 2, 1, 128, 200, (0, 1, 63, 64, 65, 200, 130),
                    ragged[:8] + [[1]], 5, seed=48)
    y = paged_case(x, False, 64, seed=49)
    f32 = dict(y, q=y["q"].float(), kp=y["kp"].float(), vp=y["vp"].float(),
               kd=y["kd"].float(), vd=y["vd"].float())
    before = read_launches()
    try:
        paged_kernel(False)(*paged_args(f32, False), scale=y["scale"],
                            c_d=y["c_d"], pn=y["pn"])
    except TypeError:
        pass
    else:
        raise AssertionError("the paged kernel took fp32 queries")
    check(read_launches() == before, "an fp32 call launched a kernel")
    print("check fp32 queries: TypeError from the paged wrapper, no launch")
    check_paged_gate_sensitivity(yt0, yr0)
    return out


def faulty_merges():
    """Two faulty merges of a row's split-walk partials [(acc, m, l), ...]
    into its output: those of ``faulty_raw_merges``, normalised."""
    import torch

    def normalised(raw):
        def merge(parts):
            acc, _, l = raw(parts)
            return acc / torch.clamp(l, min=1e-30)
        return merge

    return {k: normalised(f) for k, f in faulty_raw_merges().items()}


def faulty_raw_merges():
    """Two faulty merges of a row's split-walk partials [(acc, m, l), ...]
    into the unnormalised (acc, m, l) (#2's): the pieces summed without
    the rescale exp(m_s - m), and the row's last piece (#1, #3, #7: a
    decode piece) dropped."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    def no_rescale(parts):
        return (sum(p[0] for p in parts),
                torch.stack([p[1] for p in parts]).amax(0),
                sum(p[2] for p in parts))

    return {"merge without the rescale": no_rescale,
            "a piece dropped": lambda parts: bd.merge_partials_raw(
                parts[:-1])}


def check_partials_split():
    """Phase 2's split cases of #2 beyond check_case's default split: the
    main shape at S 4 and 16; m_c 1000 (n 2, p 2) at the default and at S
    64 (most shares empty), m_c 8191 at the default; each against its
    plain version at the same S; and two faulty merges of the plain
    version missing the gate on a main case whose last 200 keys (the last
    piece) carry most of each row's softmax mass."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    bf16 = torch.bfloat16
    main = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=0)
    cases = [("main g=8 rows=64 hd=128 m_c=8192", main, 4),
             ("main g=8 rows=64 hd=128 m_c=8192", main, 16)]
    for name, shape, seed in (("n=2 p=2 m_c=1000", (8, 8, 2, 2, 128, 1000),
                               72),
                              ("m_c=8191", (8, 32, 2, 1, 128, 8191), 73)):
        x = kernel_inputs(*shape, 24, bf16, seed=seed)
        cases += [(name, x, None)] + ([(name, x, 64)] if seed == 72 else [])
    for name, x, splits in cases:
        sk = split_kw(x, splits)
        args = (x["q"], x["kc"], x["vc"])
        got = bd.context_flash_partials(*args, scale=x["scale"], **sk)
        want = bd.context_flash_partials_plain(*args, scale=x["scale"], **sk)
        torch.cuda.synchronize()
        ok, err, rel, rel_n, err_m, err_l = partials_gaps(got, want)
        print(f"check #2 {name} S={sk['splits']}: partials vs plain at the "
              f"same S acc max_abs_err={err:.3e} ({rel:.1e} of max |acc|), "
              f"acc/l {rel_n:.1e}, m rel {err_m:.3e}, l rel {err_l:.3e} "
              f"(gates {TOL:g} of max; m, l 1e-4)")
        check(ok, f"#2 {name} S={sk['splits']}: the partials kernel "
                  f"disagrees with its plain version")
    # the last piece carries most of the mass: its keys 40 along each kv
    # head's mean query direction
    x = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=74)
    kc = x["kc"].float()
    q_dir = x["q"].float().mean(1, keepdim=True)
    kc[:, -200:] = 40.0 * q_dir / q_dir.norm(dim=-1, keepdim=True) \
        + 0.5 * kc[:, -200:]
    args = (x["q"], kc.to(bf16).contiguous(), x["vc"])
    kw = dict(scale=x["scale"], splits=default_splits(x["q"]))
    want = bd.context_flash_partials_plain(*args, **kw)
    rels = {k: partials_gaps(bd.context_flash_partials_plain(*args, **kw,
                                                             merge=f),
                             want)[2]
            for k, f in faulty_raw_merges().items()}
    print(f"check #2 split merge, main tail-dominant S={kw['splits']}: a "
          f"faulty merge's acc error / max |acc|: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(v >= 10 * TOL, f"#2 split merge: the gate misses '{k}'")


def single_args(x, quant):
    ctx = ((x["kc"], x["vc"], x["ks"], x["vs"]) if quant
           else (x["kc"], x["vc"], None, None))
    return (x["q"],) + ctx + (x["kd"], x["vd"], x["bias"])


def check_single_split_kernels(dominant):
    """Phase 2's split cases of #1 and #3 beyond their plain-version gates
    at the default split: the default split within the gate of splits=1 at
    the main shape; S = 64 against the plain version (m_c 1000, n 2, p 2,
    most shares empty); two faulty merges of the plain versions on the
    decode-dominant main case ``dominant`` missing the gate. (#3 = #9 at
    the default split is gated in check_paged_kernels.)"""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    main = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, torch.bfloat16,
                         seed=70)
    ragged = kernel_inputs(8, 8, 2, 2, 128, 1000, 5, torch.bfloat16,
                           seed=71, masked=True)
    for quant, name in ((False, "#1"), (True, "#3")):
        x = quantized(main) if quant else main
        kern = (bd.fused_bifurcated_decode_q8 if quant
                else bd.fused_bifurcated_decode)
        args = q8_args(x) if quant else (x["q"], x["kc"], x["vc"], x["kd"],
                                         x["vd"], x["bias"])
        kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
        split = kern(*args, **kw)
        single = kern(*args, **kw, splits=1)
        torch.cuda.synchronize()
        ok, err, rel = within(split, single)
        print(f"check {name} main g=8 rows=64 hd=128 m_c=8192: default split "
              f"(S={default_splits(x['q'])}) vs splits=1 max_abs_err="
              f"{err:.3e} ({rel:.1e} of max |out|, gate 2e-2)")
        check(ok, f"{name}: the split walk disagrees with the single walk")
        tag = f"{name} n=2 p=2 m_c=1000 masked-arm, S=64"
        if quant:
            check_q8(tag, quantized(ragged), splits=64)
        else:
            check_case(tag, ragged, splits=64)
        xd = quantized(dominant) if quant else dominant
        pkw = dict(scale=xd["scale"], c_d=xd["c_d"], pn=xd["pn"],
                   block_m=bd.BLOCK_M, splits=default_splits(xd["q"]))
        want = bd._single_plain(*single_args(xd, quant), **pkw)
        rels = {k: within(bd._single_plain(*single_args(xd, quant), **pkw,
                                           merge=f), want)[2]
                for k, f in faulty_merges().items()}
        print(f"check {name} split merge, main decode-dominant masked "
              f"S={pkw['splits']}: a faulty merge's error / max |out|: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
        for k, v in rels.items():
            check(v >= 10 * TOL, f"{name} split merge: the gate misses '{k}'")


def check_split_kernels():
    """Phase 2's split cases of #6-#9: the default split against the
    single walk (splits=1) on the main shapes; a forced S = 64 on the
    ragged trie (most shares empty or masked), each kernel against its
    plain version at that S and #8 = #6 (#9 = #7) bit for bit; two faulty
    merges of #6's and #7's plain versions on the decode-dominant main trie
    missing the gate."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    nan = float("nan")
    lens, req_paths = served_trie()
    slot_paths = [req_paths[s * len(req_paths) // BATCH]
                  for s in range(BATCH)]
    ragged = [[5, 1, 2], [3], [5, 4, 4], [0, 3, 6], [2, 2], [6, 1],
              [5, 1, 2], [7], [4, -2, 1]]
    for quant in (False, True):
        tag = "int8 " if quant else ""
        n_tree, n_paged = ("#7", "#9") if quant else ("#6", "#8")
        x1 = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, torch.bfloat16,
                           seed=60)
        x1 = quantized(x1) if quant else x1
        y1 = paged_case(single_case(x1, False), quant, 128, seed=61)
        xt = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                         slot_paths, TREE_DEC_CAP, seed=62, quant=quant)
        yt = paged_case(xt, quant, 128, seed=63)
        for name, kern, args, x in (
                (f"{n_paged} main single prefix", paged_kernel(quant),
                 paged_args(y1, quant), y1),
                (f"{n_paged} main trie", paged_kernel(quant),
                 paged_args(yt, quant), yt),
                (f"{n_tree} main trie", tree_kernel(quant),
                 tree_args(xt, quant), xt)):
            kw = dict(scale=x["scale"], c_d=x["c_d"], pn=x["pn"])
            split = kern(*args, **kw)
            single = kern(*args, **kw, splits=1)
            torch.cuda.synchronize()
            ok, err, rel = within(split, single)
            print(f"check {name}: default split (S={default_splits(x['q'])})"
                  f" vs splits=1 max_abs_err={err:.3e} ({rel:.1e} of max "
                  f"|out|, gate 2e-2)")
            check(ok, f"{name}: the split walk disagrees with the single "
                      f"walk")
        # forced S = 64 on the ragged trie: ids outside [-1, N), lengths
        # 0/1/63/64/65/200/130, pages of 48 (a block straddles pages)
        xr = tree_inputs(7, 8, 9, 2, 1, 128, 200,
                         (0, 1, 63, 64, 65, 200, 130), ragged, 5, seed=64,
                         masked=True, quant=quant)
        yr = paged_case(xr, quant, 48, seed=65, spare=5, fill=nan)
        rtag = "N=7 lens 0/1/63/64/65/200/130, ids outside [-1, N), S=64"
        check_tree(f"{tag}{rtag}", xr, quant, splits=64)
        _, out_p = check_paged(f"{tag}{rtag}, pages of 48", yr, quant,
                               splits=64)
        out_t = tree_kernel(quant)(*tree_args(xr, quant), scale=xr["scale"],
                                   c_d=xr["c_d"], pn=xr["pn"], splits=64)
        torch.cuda.synchronize()
        same = same_bits(out_p, out_t)
        print(f"check {tag}ragged trie S=64: paged (pages of 48) vs tree "
              f"kernel bit-equal {same}")
        check(same, "S=64: the paged kernel is not the tree kernel")
        # the gate catches a faulty merge
        xd = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                         slot_paths, TREE_DEC_CAP, seed=66, masked=True,
                         dec_boost=3.0, quant=quant)
        kw = dict(scale=xd["scale"], c_d=xd["c_d"], pn=xd["pn"],
                  block_m=bd.BLOCK_M, splits=default_splits(xd["q"]))
        targs = tree_args(xd, quant)
        if not quant:                    # _tree_plain takes the scales
            targs = targs[:3] + (None, None) + targs[3:]
        want = bd._tree_plain(*targs, **kw)
        rels = {k: within(bd._tree_plain(*targs, **kw, merge=f), want)[2]
                for k, f in faulty_merges().items()}
        print(f"check {n_tree} split merge, main trie decode-dominant masked "
              f"S={kw['splits']}: a faulty merge's error / max |out|: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
        for k, v in rels.items():
            check(v >= 10 * TOL, f"{n_tree} split merge: the gate misses "
                                 f"'{k}'")


def packed_case(y, quant, cp, buf, fresh_start, fresh_path, env, seed):
    """The paged case ``y`` (of ``paged_case``) as a packed step: ``cp``
    chunk positions (pn rows each) after the decode rows, reading the
    nodes of ``fresh_path`` and an envelope of ``env`` random bf16 rows,
    ``buf + cp`` of them live from position ``fresh_start``, the chunk at
    rows buf..buf+cp-1 (cp = 0: a decode-only call). Adds q (decode ++
    chunk rows), kf, vf, paths (one level more: -1 on the decode rows, N on
    the chunk rows), row_pos, row_slot, fresh_len, fresh_start and nd (the
    decode rows)."""
    import torch

    q, paths = y["q"], y["paths"]
    g, nd, hd = q.shape
    pn, n_segs, depth = y["pn"], y["tables"].shape[0], paths.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    qc = torch.randn(g, cp * pn, hd, generator=gen, device=DEVICE)
    kf, vf = (torch.randn(env, g, hd, generator=gen, device=DEVICE
                          ).to(torch.bfloat16) for _ in range(2))
    i32 = dict(dtype=torch.int32, device=DEVICE)
    fp = torch.tensor(list(fresh_path) + [-1] * (depth - len(fresh_path))
                      + [n_segs], **i32)
    path_rows = torch.cat([
        torch.cat([paths, torch.full((1, nd), -1, **i32)]),
        fp[:, None].expand(depth + 1, cp * pn)], dim=1).contiguous()
    pos = fresh_start + buf + torch.arange(cp, device=DEVICE)
    row_pos = torch.cat([torch.zeros(nd, **i32),
                         pos.to(torch.int32).repeat_interleave(pn)])
    row_slot = torch.cat([torch.arange(nd, **i32) // pn,
                          torch.full((cp * pn,), -1, **i32)])
    return dict(y, q=torch.cat([q, qc.to(q.dtype)], 1).contiguous(), kf=kf,
                vf=vf, paths=path_rows, row_pos=row_pos.contiguous(),
                row_slot=row_slot.contiguous(), fresh_len=buf + cp if cp
                else 0, fresh_start=fresh_start, nd=nd)


def packed_args(z, quant):
    pool = ((z["kp"], z["vp"], z["ksp"], z["vsp"]) if quant
            else (z["kp"], z["vp"]))
    return (z["q"],) + pool + (z["kf"], z["vf"], z["tables"], z["seg_lens"],
                               z["paths"], z["row_pos"], z["row_slot"],
                               z["kd"], z["vd"], z["bias"])


def packed_kw(z):
    return dict(fresh_len=z["fresh_len"], fresh_start=z["fresh_start"],
                scale=z["scale"], c_d=z["c_d"], pn=z["pn"])


def packed_kernel(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.packed_fused_bifurcated_decode_q8 if quant
            else bd.packed_fused_bifurcated_decode)


def packed_plain(quant):
    from repro_torch.kernels import bifurcated_decode as bd

    return (bd.packed_fused_bifurcated_decode_q8_plain if quant
            else bd.packed_fused_bifurcated_decode_plain)


def packed_bad_rows(z):
    """The rows the packed kernels write as NaN: a path id outside
    [-1, N] (N, the pseudo-segment, is the chunk's own), or a segment whose
    live pages name an id outside [-1, P)."""
    n_segs = z["tables"].shape[0]
    paths = z["paths"].long()
    return paged_bad_rows(dict(z, paths=paths.masked_fill(paths == n_segs,
                                                          -1)))


def packed_splits(z):
    """#10's / #11's default shares (decode tiles', chunk tiles') on this
    card for the packed case ``z`` (``packed_split_count``)."""
    from repro_torch.kernels import bifurcated_decode as bd

    g, rows, _ = z["q"].shape
    return bd.packed_split_count(z["nd"], rows - z["nd"], g,
                                 sms=bd._sm_count(z["q"].device.index))


def check_packed(name, z, quant, splits=None):
    """A packed kernel vs its plain version on one case (at ``splits``,
    default its default split, its plain version at the same S): both NaN
    on the rows of ``packed_bad_rows`` and nowhere else, within the gate on
    the decode rows and on the chunk rows. Returns (max abs error, the
    kernel's output)."""
    import torch

    sk = {"splits": packed_splits(z) if splits is None else splits}
    out_k = packed_kernel(quant)(*packed_args(z, quant), **packed_kw(z),
                                 **sk)
    out_p = packed_plain(quant)(*packed_args(z, quant), **packed_kw(z), **sk)
    torch.cuda.synchronize()
    bad = packed_bad_rows(z)
    for out, which in ((out_k, "kernel"), (out_p, "plain version")):
        nan = torch.isnan(out.float()).any(-1).any(0)
        check(bool(torch.equal(nan, bad)),
              f"{name}: the {which}'s NaN rows "
              f"{nan.nonzero().flatten().tolist()} are not the rows of bad "
              f"ids")
    check(bool(torch.isfinite(out_k[:, ~bad].float()).all()),
          f"{name}: non-finite")
    nd = z["nd"]
    errs, rels = [], []
    for part, sel in (("decode", slice(0, nd)), ("chunk", slice(nd, None))):
        ok_rows = ~bad[sel]
        if not bool(ok_rows.any()):
            continue
        ok, err, rel = within(out_k[:, sel][:, ok_rows],
                              out_p[:, sel][:, ok_rows])
        check(ok, f"{name}: the packed kernel's {part} rows disagree with "
                  f"its plain version ({rel:.2e} of max |out|)")
        errs.append(err)
        rels.append(f"{part} {err:.3e} ({rel:.1e})")
    print(f"check {name}: {'packed q8' if quant else 'packed'}"
          f" S={sk['splits']} max_abs_err "
          + ", ".join(rels) + " of max |out| (gate 2e-2)"
          + (f"; {int(bad.sum())} rows of bad ids NaN" if bad.any() else ""))
    return max(errs), out_k


def check_packed_gate_sensitivity(z):
    """Four faulty plain versions of #10 miss the gate on a chunk at
    position 0 with no ancestors over the ragged trie: the causal mask
    dropped, fresh_start off by one, the decode arm leaking into the chunk
    rows (their slot 0 instead of none), the fresh arm leaking into the
    decode rows (their extra path level N, every envelope row visible)."""
    plain = packed_plain(False)
    nd, n_segs = z["nd"], z["tables"].shape[0]
    want = plain(*packed_args(z, False), **packed_kw(z))
    far = 1 << 30

    def rel(rows, **fault):
        y = dict(z, **{k: v for k, v in fault.items() if k != "fresh_start"})
        kw = packed_kw(z)
        kw["fresh_start"] = fault.get("fresh_start", kw["fresh_start"])
        got = plain(*packed_args(y, False), **kw)
        return within(got[:, rows], want[:, rows])[2]

    row_pos = z["row_pos"].clone()
    row_pos[nd:] = far
    leak_slot = z["row_slot"].clone()
    leak_slot[nd:] = 0
    leak_paths = z["paths"].clone()
    leak_paths[-1, :nd] = n_segs
    leak_pos = z["row_pos"].clone()
    leak_pos[:nd] = far
    chunk, dec = slice(nd, None), slice(0, nd)
    rels = {"causal mask dropped": rel(chunk, row_pos=row_pos),
            "fresh_start off by one": rel(chunk,
                                          fresh_start=z["fresh_start"] + 1),
            "decode arm leaking into chunk rows": rel(chunk,
                                                      row_slot=leak_slot),
            "fresh arm leaking into decode rows": rel(dec, paths=leak_paths,
                                                      row_pos=leak_pos)}
    print("check packed plain versions: a faulty version's error / max "
          "|out|: " + ", ".join(f"{k} {v:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(v >= 10 * TOL, f"packed: the gate misses '{k}'")


def check_packed_split(z, dec_only, yt, out_z, quant):
    """#10's / #11's split on the main packed case ``z`` (default output
    ``out_z``): the same bits at two other S > 1 (an int and a pair); at
    splits=1 (the single walk) its decode-only call = #8's / #9's at
    splits=1 and the chunk leaving the decode rows' bits; within the gate
    of the single walk."""
    import torch

    tag, name, paged_name = (("int8 ", "#11", "#9") if quant
                             else ("", "#10", "#8"))
    kern, paged = packed_kernel(quant), paged_kernel(quant)
    kw = packed_kw(z)
    sd, sc = packed_splits(z)
    for splits in (4, (sd, 2 * sc)):
        same = same_bits(kern(*packed_args(z, quant), **kw, splits=splits),
                         out_z)
        print(f"check {tag}main packed trie: S={splits} vs the default "
              f"({sd}, {sc}) bit-equal {same}")
        check(same, f"{name}'s output moves with S ({splits})")
    one = kern(*packed_args(z, quant), **kw, splits=1)
    one_d = kern(*packed_args(dec_only, quant), **packed_kw(dec_only),
                 splits=1)
    paged1 = paged(*paged_args(yt, quant), scale=yt["scale"], c_d=yt["c_d"],
                   pn=yt["pn"], splits=1)
    torch.cuda.synchronize()
    nd = z["nd"]
    same = bool(torch.equal(one_d, paged1))
    same_z = bool(torch.equal(one[:, :nd], paged1))
    ok, err, rel = within(out_z, one)
    print(f"check {tag}main packed trie, splits=1: decode only vs "
          f"{paged_name} at splits=1 bit-equal {same}, decode rows with the "
          f"chunk {same_z}; the default split vs splits=1 max_abs_err="
          f"{err:.3e} ({rel:.1e} of max |out|, gate 2e-2)")
    check(same and same_z, f"splits=1: {name} is not {paged_name}'s single "
                           f"walk")
    check(ok, f"{name}'s split walk disagrees with its single walk")


def check_packed_merges(xt_dominant):
    """Two faulty merges of #10's plain split walk miss the gate on the
    main packed case built on a decode-dominant trie ``xt_dominant``, whose
    envelope keys lie along the chunk rows' mean query direction: the
    decode rows' last piece (their decode arm) and the chunk rows' (the
    envelope) carry most of their softmax mass."""
    import torch
    from repro_torch.kernels import bifurcated_decode as bd

    nan = float("nan")
    yt = paged_case(xt_dominant, False, 128, seed=61, spare=24, fill=nan)
    fs = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    z = packed_case(yt, False, PACKED_CHUNK, PACKED_BUF, fs, [0, 1],
                    TREE_CAP, 62)
    nd = z["nd"]
    q_dir = z["q"][:, nd:].float().mean(1)                     # (g, hd)
    z["kf"] = (40.0 * q_dir / q_dir.norm(dim=-1, keepdim=True)
               + 0.5 * z["kf"].float()).to(torch.bfloat16).contiguous()
    args = packed_args(z, False)
    args = args[:3] + (None, None) + args[3:]      # _packed_plain's scales
    kw = dict(packed_kw(z), splits=packed_splits(z))
    want = bd._packed_plain(*args, **kw)
    rels = {}
    for k, f in faulty_merges().items():
        got = bd._packed_plain(*args, **kw, merge=f)
        rels[k] = [within(got[:, sel], want[:, sel])[2]
                   for sel in (slice(0, nd), slice(nd, None))]
    print(f"check #10 split merge, main packed trie decode-dominant, "
          f"envelope-dominant chunk S={kw['splits']}: a faulty merge's error "
          f"/ max |out| (decode rows, chunk rows): "
          + ", ".join(f"{k} {v[0]:.2f}, {v[1]:.2f}" for k, v in rels.items()))
    for k, v in rels.items():
        check(min(v) >= 10 * TOL, f"#10 split merge: the gate misses '{k}'")


def check_packed_kernels():
    """Phase 2's cases of #10 and #11; returns {kernel name: max abs error
    over the main-shape cases}."""
    import torch

    nan = float("nan")
    lens, req_paths = served_trie()
    slot_paths = [req_paths[s * len(req_paths) // BATCH]
                  for s in range(BATCH)]
    ragged = [[5, 1, 2], [3], [5, 4, 4], [0, 3, 6], [2, 2], [6, 1],
              [5, 1, 2], [7], [4, -2, 1]]
    rlens = (0, 1, 63, 64, 65, 200, 130)
    out = {}
    for quant, kname in ((False, "packed_fused_bifurcated_decode"),
                         (True, "packed_fused_bifurcated_decode_q8")):
        tag = "int8 " if quant else ""
        # the main shape: phase 3d's trie on shuffled pages of 128 (24
        # free pages of NaN), its 32 x 64 decode arm, and a 512-position
        # chunk (1024 rows) continuing a 1024-token node under [SYS,
        # TPL_A] at rows 300..811 of its envelope (fresh_start 6144)
        xt = tree_inputs(TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens,
                         slot_paths, TREE_DEC_CAP, seed=50, quant=quant)
        yt = paged_case(xt, quant, 128, seed=51, spare=24, fill=nan)
        dec_only = packed_case(yt, quant, 0, 0, 0, [0, 1], TREE_CAP, 52)
        fs = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
        z = packed_case(yt, quant, PACKED_CHUNK, PACKED_BUF, fs, [0, 1],
                        TREE_CAP, 52)
        out_d = packed_kernel(quant)(*packed_args(dec_only, quant),
                                     **packed_kw(dec_only))
        # #10 = #8 (#11 = #9) at the same (default) S
        paged = paged_kernel(quant)(*paged_args(yt, quant),
                                    scale=yt["scale"], c_d=yt["c_d"],
                                    pn=yt["pn"])
        torch.cuda.synchronize()
        same = bool(torch.equal(out_d, paged))
        print(f"check {tag}main trie, decode only: packed vs paged kernel at "
              f"the default S ({packed_splits(dec_only)[0]}) bit-equal "
              f"{same}")
        check(same, "decode only: the packed kernel is not the paged kernel")
        err, out_z = check_packed(
            f"main {tag}trie on pages of 128 + a {PACKED_CHUNK}-position "
            f"chunk ({2 * PACKED_CHUNK} rows) under [SYS, TPL_A], envelope "
            f"rows {PACKED_BUF}..{PACKED_BUF + PACKED_CHUNK - 1} from "
            f"position {fs}", z, quant)
        same = bool(torch.equal(out_z[:, :z["nd"]], paged))
        print(f"check {tag}main trie with the chunk: decode rows bit-equal "
              f"to the paged kernel's {same}")
        check(same, "the chunk moved the decode rows' bits")
        check_packed_split(z, dec_only, yt, out_z, quant)
        if not quant:
            check_packed_merges(tree_inputs(
                TREE_NODES, 8, BATCH, 2, 1, 128, TREE_CAP, lens, slot_paths,
                TREE_DEC_CAP, seed=60, masked=True, dec_boost=3.0))
        out[kname] = err
        # the ragged trie (ids outside [-1, N) on one slot's path) on
        # pages of 48; 9 slots, so a tile holds 18 decode rows and 46
        # chunk rows; 45 chunk positions; fresh_len 0/1/63/64/65 under
        # [node 5, node 4], a chunk at position 0 with no ancestors, an id
        # outside [-1, N] on the chunk's path (its rows NaN, N alone none)
        xr = tree_inputs(7, 8, 9, 2, 1, 128, 200, rlens, ragged, 5, seed=46,
                         masked=True, quant=quant)
        yr = paged_case(xr, quant, 48, seed=53, spare=5, fill=nan)
        dec_r = packed_kernel(quant)(
            *packed_args(packed_case(yr, quant, 0, 0, 0, [], 96, 54),
                         quant),
            **packed_kw(packed_case(yr, quant, 0, 0, 0, [], 96, 54)))
        for fl in (0, 1, 63, 64, 65):
            cp = min(45, fl) if fl else 45
            zr = packed_case(yr, quant, cp, fl - cp if fl else 0, 265,
                             [5, 4], 96, 55 + fl)
            if not fl:
                zr["fresh_len"] = 0
            _, out_r = check_packed(
                f"{tag}ragged trie on pages of 48, {cp} chunk positions, "
                f"fresh_len {fl}", zr, quant)
            check(same_bits(out_r[:, :zr["nd"]], dec_r),
                  f"fresh_len {fl}: the chunk moved the decode rows' bits")
        check_packed(f"{tag}ragged trie, a 45-position chunk at position 0 "
                     f"with no ancestors",
                     packed_case(yr, quant, 45, 0, 0, [], 96, 56), quant)
        zb = packed_case(yr, quant, 45, 0, 265, [5, 7 + 3], 96, 57)
        _, out_b = check_packed(f"{tag}ragged trie, an id outside [-1, N] "
                                f"on the chunk's path", zb, quant)
        check(same_bits(out_b[:, :zb["nd"]], dec_r),
              "a bad chunk path moved the decode rows' bits")
    # fp32 queries raise; gate sensitivity on the ragged trie without bad
    # ids, pages of 16, a 256-position chunk at position 0
    xs = tree_inputs(7, 8, 9, 2, 1, 128, 200, rlens, ragged[:8] + [[1]], 5,
                     seed=48)
    zs = packed_case(paged_case(xs, False, 16, seed=58), False, 256, 0, 0,
                     [], 256, 59)
    f32 = dict(zs, q=zs["q"].float(), kp=zs["kp"].float(),
               vp=zs["vp"].float(), kf=zs["kf"].float(), vf=zs["vf"].float(),
               kd=zs["kd"].float(), vd=zs["vd"].float())
    before = read_launches()
    try:
        packed_kernel(False)(*packed_args(f32, False), **packed_kw(f32))
    except TypeError:
        pass
    else:
        raise AssertionError("the packed kernel took fp32 queries")
    check(read_launches() == before, "an fp32 call launched a kernel")
    print("check fp32 queries: TypeError from the packed wrapper, no launch")
    check_packed_gate_sensitivity(zs)
    return out


# ---------------------------------------------------------------------------
# phase 2, #12: flash prefill
# ---------------------------------------------------------------------------

FLASH_WINDOW = 4096     # h2o-danube's sliding window


def flash_inputs(b, n, m, h, g, hd, seed, dtype=None):
    """Random q (b, n, h, hd) and k, v (b, m, g, hd), bf16 by default."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=DEVICE).to(
        dtype or torch.bfloat16)
        for s in ((b, n, h, hd), (b, m, g, hd), (b, m, g, hd))]


def window_edge_inputs(n, h, g, hd, window, seed, beta=24.0):
    """Causal windowed inputs whose softmax is decided at the window's
    edge: key j is beta x a unit vector u_j, and query i of every head is
    sqrt(hd) x u_{i - window}, so its logit for key i - window (the first
    key outside its window) is beta against ~N(0, (beta / sqrt(hd))^2) for
    the others. A window one key wider takes that key and its value."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.randn(n, hd, generator=gen, device=DEVICE)
    u = u / u.norm(dim=-1, keepdim=True)
    src = (torch.arange(n, device=DEVICE) - window) % n
    q = (hd**0.5 * u[src])[None, :, None, :].expand(1, n, h, hd)
    k = (beta * u)[None, :, None, :].expand(1, n, g, hd)
    v = torch.randn(1, n, g, hd, generator=gen, device=DEVICE)
    return [t.contiguous().to(torch.bfloat16) for t in (q, k, v)]


def check_flash(name, x, causal=True, window=0, q_offset=0):
    """#12 against its plain version on one case; returns the max abs
    error and the plain output."""
    import torch
    from repro_torch.kernels import flash_prefill as fp

    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fp.flash_prefill_attention(*x, **kw)
    want = fp.flash_prefill_attention_plain(*x, **kw)
    torch.cuda.synchronize()
    ok, err, rel = within_rows(out, want)
    b, n, h, hd = x[0].shape
    print(f"check {name} (b={b} n={n} m={x[1].shape[1]} h={h} "
          f"g={x[1].shape[2]} hd={hd} causal={causal} window={window} "
          f"q_offset={q_offset}): max_abs_err={err:.3e}, worst row "
          f"{rel:.1e} of its max |out| (gate {TOL:g} per row; whole output "
          f"{within(out, want)[2]:.1e} of max |out|)")
    check(ok, f"{name}: flash prefill kernel disagrees with its plain version")
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    return err, want


def dense_attention(q, k, v, visible, q_offset=0, chunk=512):
    """fp32 softmax attention of q (b, n, h, hd) over k, v (b, m, g, hd),
    key k visible to query position t where ``visible(t, k)`` (broadcast
    index tensors): a faulty version for the gate check of #12."""
    import torch

    b, n, h, hd = q.shape
    m, g = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // g, dim=2)
    vf = v.float().repeat_interleave(h // g, dim=2)
    k_pos = torch.arange(m, device=q.device)[None, :]
    out = torch.empty_like(q)
    for qs in range(0, n, chunk):
        qe = min(qs + chunk, n)
        s = torch.einsum("bnhd,bmhd->bhnm", q[:, qs:qe].float(), kf) * hd**-0.5
        t = q_offset + torch.arange(qs, qe, device=q.device)[:, None]
        s = s.masked_fill(~visible(t, k_pos), float("-inf"))
        out[:, qs:qe] = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1),
                                     vf).to(q.dtype)
    return out


def merge_without_rescale(q, k, v, q_offset, parts):
    """Causal attention over key ranges ``parts``, each part's (acc, l)
    taken against its own max and summed without the factor e^(m_i - m):
    the fault a key-split merge can make."""
    import torch

    b, n, h, hd = q.shape
    g = k.shape[2]
    kf = k.float().repeat_interleave(h // g, dim=2)
    vf = v.float().repeat_interleave(h // g, dim=2)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), kf) * hd**-0.5
    t = q_offset + torch.arange(n, device=q.device)[:, None]
    s = s.masked_fill(torch.arange(k.shape[1], device=q.device)[None, :] > t,
                      float("-inf"))
    acc, l = 0.0, 0.0
    for lo, hi in parts:
        e = (s[..., lo:hi] - s[..., lo:hi].amax(-1, keepdim=True)).exp()
        l = l + e.sum(-1, keepdim=True)
        acc = acc + torch.einsum("bhnm,bmhd->bhnd", e, vf[:, lo:hi])
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def check_flash_fp32_raises(x, q_offset):
    """fp32 operands raise TypeError on the card and launch nothing."""
    from repro_torch.kernels import flash_prefill as fp

    n0 = fp.flash_prefill_attention.launches
    try:
        fp.flash_prefill_attention(*(t.float() for t in x), q_offset=q_offset)
    except TypeError:
        pass
    else:
        raise AssertionError("the flash prefill kernel took fp32 queries")
    check(fp.flash_prefill_attention.launches == n0,
          "an fp32 call launched the flash prefill kernel")
    print("check fp32 queries: TypeError from the flash prefill wrapper, "
          "no launch")


def check_flash_kernels():
    """Phase 2's cases of #12; returns {kernel name: max abs error over the
    main prefill and suffix cases}."""
    import torch
    from repro_torch.kernels import flash_prefill as fp

    plain = fp.flash_prefill_attention_plain
    anc = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    suf = TREE_TOKENS["A2"]
    x_main = flash_inputs(1, CONTEXT, CONTEXT, 16, 8, 128, seed=60)
    err_m, want_m = check_flash("main prefill", x_main)
    x_suf = flash_inputs(1, suf, anc + suf, 16, 8, 128, seed=61)
    err_s, want_s = check_flash(f"suffix A2 over [SYS, TPL_A]", x_suf,
                                q_offset=anc)
    check_flash(f"window {FLASH_WINDOW}",
                flash_inputs(1, CONTEXT, CONTEXT, 16, 8, 128, seed=62),
                window=FLASH_WINDOW)
    for name, shape, kw in [
            ("g=1 (MQA)", (1, 2000, 2000, 16, 1, 128), {}),
            ("hd=80", (1, 1500, 1500, 32, 8, 80), {}),
            ("n, m off the tile", (2, 1000, 1777, 16, 8, 128),
             dict(q_offset=777, window=300)),
            ("n=1", (4, 1, CONTEXT, 16, 8, 128), dict(q_offset=CONTEXT - 1)),
            ("non-causal", (1, 777, 1333, 16, 8, 128), dict(causal=False)),
            ("p=2, n odd", (1, 1999, 1999, 16, 8, 128), {}),
            ("p=3, tiles of 126 rows", (1, 1001, 1001, 24, 8, 128), {}),
            ("hd=112, zamba2's shared block", (1, CONTEXT, CONTEXT, 32, 32,
                                               112), {}),
            ("hd=16", (2, 700, 700, 8, 4, 16), {}),
            ("hd=64", (1, 3000, 3000, 16, 4, 64), {})]:
        check_flash(name, flash_inputs(*shape, seed=63 + len(name)), **kw)
    x_edge = window_edge_inputs(2048, 16, 8, 128, 512, seed=70)
    _, want_e = check_flash("window 512 decided at its edge", x_edge,
                            window=512)
    # 8 (batch, kv head, tile) items: the wrapper splits their keys
    split_off = CONTEXT - 64
    x_split = flash_inputs(1, 64, CONTEXT, 16, 8, 128, seed=71)
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if DEVICE == "cuda" else 132)
    splits = fp.split_count(1, 64, CONTEXT, 8, 2, causal=True, window=0,
                            q_offset=split_off, sms=sms)
    check(splits > 1, "the key-split case does not split")
    _, want_sp = check_flash(f"key split in {splits} (n 64 over "
                             f"{CONTEXT} keys)", x_split, q_offset=split_off)

    check_flash_fp32_raises(x_suf, anc)

    # gate sensitivity: plain versions each with one fault; "l x 1.5" and
    # "last key block dropped" touch only the query tiles past n / 2, whose
    # rows are small
    q, k, v = x_main
    n, h, g = q.shape[1], q.shape[2], k.shape[2]
    wrong = torch.arange(h, device=DEVICE) % g      # right: h // (h / g)
    late_l = want_m.clone()     # l x 1.5
    late_l[:, n // 2:] = (want_m[:, n // 2:].float() / 1.5).to(q.dtype)
    late_drop = want_m.clone()  # each tile's own (last live) key block dropped
    for qs in range(n // 2, n, 128):
        late_drop[:, qs:qs + 128] = plain(q[:, qs:qs + 128], k[:, :qs],
                                          v[:, :qs], q_offset=qs)
    nblk = -(-CONTEXT // fp.KEY_BLOCK)     # the split case's key blocks
    parts = [(i * nblk // splits * fp.KEY_BLOCK,
              min(CONTEXT, (i + 1) * nblk // splits * fp.KEY_BLOCK))
             for i in range(splits)]
    faults = {
        "causal mask dropped": (plain(*x_main, causal=False), want_m),
        "q_offset ignored": (plain(*x_suf), want_s),
        "window off by one": (plain(*x_edge, window=513), want_e),
        "query head h on kv head h % g": (
            plain(q, k[:, :, wrong].contiguous(), v[:, :, wrong].contiguous()),
            want_m),
        "l x 1.5 past n/2": (late_l, want_m),
        "last key block dropped past n/2": (late_drop, want_m),
        "split merge without the e^(m_i - m) rescale": (
            merge_without_rescale(*x_split, split_off, parts), want_sp),
        "causal mask per key block": (
            dense_attention(q, k, v, lambda t, kp: kp // fp.KEY_BLOCK
                            <= t // fp.KEY_BLOCK), want_m),
    }
    rels = {name: (within_rows(got, want)[2], within(got, want)[2])
            for name, (got, want) in faults.items()}
    print("check flash prefill gate sensitivity: a faulty plain version's "
          "worst row error / its max |out| (whole-output error / max |out|):"
          " " + ", ".join(f"{k} {r:.2f} ({w:.3f})"
                          for k, (r, w) in rels.items()))
    for name, (rel, _) in rels.items():
        check(rel >= 10 * TOL, f"the flash gate misses '{name}'")
    return {"flash_prefill_attention": max(err_m, err_s)}


# ---------------------------------------------------------------------------
# phase 2, #13: chunked linear attention
# ---------------------------------------------------------------------------

# the slice's shape: zamba2-7b's Mamba2 layer over an 8192-token prefill
# (b 1, n 8192, 112 heads, dk = state 64, dv = head 64, chunk 256)
SSM_HEADS, SSM_DK, SSM_DV, SSM_CHUNK = 112, 64, 64, 256


def chunked_inputs(b, n, H, dk, dv, seed, bcast=False, init=False,
                   dtype=None):
    """Random q, k (b, n, H, dk), v (b, n, H, dv), bf16 by default; q and k
    as stride-0 views over the heads when ``bcast`` (as Mamba2 hands them
    over); the log-decay <= 0, slow to fast over the heads as Mamba2's
    dt_bias spreads them; an fp32 initial state when ``init``."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dtype = dtype or torch.bfloat16

    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    if bcast:
        q, k = (r(b, n, 1, dk).to(dtype).expand(b, n, H, dk) for _ in range(2))
    else:
        q, k = (r(b, n, H, dk).to(dtype) for _ in range(2))
    v = r(b, n, H, dv).to(dtype)
    a = -F.softplus(r(b, n, H) + torch.linspace(-4.0, 1.0, H, device=DEVICE))
    return q, k, v, a, (r(b, H, dk, dv) if init else None)


def check_chunked(name, x, chunk, normalize=False):
    """#13 against its plain version on one case, row by row: each (batch,
    position, head) row of the output within 2e-2 of that row's max
    |plain|, each head's final state within 2e-2 of its max |plain|.
    Returns the output's max abs error."""
    import torch
    from repro_torch.kernels import chunked_linear as cl

    q, k, v, a, s0 = x
    kw = dict(chunk=chunk, normalize=normalize, initial_state=s0)
    out, st = cl.chunked_linear_attention(q, k, v, a, **kw)
    want, st_p = cl.chunked_linear_attention_plain(q, k, v, a, **kw)
    torch.cuda.synchronize()
    ok_o, err_o, rel_o = within_rows(out, want)
    ok_s, err_s, rel_s = within_rows(st.flatten(2), st_p.flatten(2))
    b, n, H, dk = q.shape
    print(f"check {name} (b={b} n={n} H={H} dk={dk} dv={v.shape[-1]} "
          f"chunk={chunk} normalize={normalize} initial state "
          f"{s0 is not None} q/k strides {tuple(q.stride())}): output "
          f"max_abs_err={err_o:.3e}, worst row {rel_o:.1e}; state "
          f"max_abs_err={err_s:.3e}, worst head {rel_s:.1e} (gate {TOL:g} "
          f"per row / head)")
    check(ok_o and ok_s, f"{name}: #13 disagrees with its plain version")
    check(bool(torch.isfinite(out.float()).all()
               and torch.isfinite(st).all()), f"{name}: non-finite")
    return err_o


def faulty_chunked_plain(q, k, v, a, chunk, fault, s0=None,
                         normalize=False):
    """The plain version's order (fp32): each chunk's own products and
    state contribution, the chain of states from ``s0`` (None: zero), then
    the inter term; with one planted fault: the state not carried across
    chunks, the inter-chunk term without e^{A_i}, an exclusive cumsum, the
    in-chunk causal mask dropped, the padded rows given a nonzero decay,
    the state handed to the wrong chunk (chunk c's rows against S_{c-1}),
    the initial state dropped, and for the wide path's 64 x 64 state
    blocks: the first dk block dropped from the inter sum, the first
    block's chain not carried (its S_c zero past chunk 0), or, with
    ``normalize``, the normaliser taken from a column of another block
    (None: no fault)."""
    import torch
    import torch.nn.functional as F

    if normalize:
        v = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    b, n, H, dk = q.shape
    c = min(chunk, n)
    pad = (-n) % c
    q, k, v = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    a = F.pad(a.float(), (0, 0, 0, pad),
              value=-1.0 if fault == "padded rows decay" else 0.0)
    S0 = torch.zeros(b, H, dk, v.shape[-1], device=q.device)
    if s0 is not None and fault != "initial state dropped":
        S0 = s0.float()
    mask = torch.ones(c, c, device=q.device)
    if fault != "causal mask dropped":
        mask = torch.tril(mask)
    starts = range(0, n + pad, c)
    intra, d_state, cum = [], [], []
    for c0 in starts:
        kf, vf = k[:, c0:c0 + c], v[:, c0:c0 + c]
        A = torch.cumsum(a[:, c0:c0 + c], dim=1)
        if fault == "exclusive cumsum":
            A = A - a[:, c0:c0 + c]
        D = (torch.exp(torch.clamp(A[:, :, None] - A[:, None], max=0.0))
             * mask[None, :, :, None])
        intra.append(torch.einsum(
            "bijh,bjhv->bihv",
            torch.einsum("bihk,bjhk->bijh", q[:, c0:c0 + c], kf) * D, vf))
        d_state.append(torch.einsum(
            "bjhk,bjhv->bhkv", kf * torch.exp(A[:, -1:] - A)[..., None], vf))
        cum.append(A)
    states = [S0]
    for A, dS in zip(cum, d_state):
        states.append(states[-1] * torch.exp(A[:, -1])[..., None, None] + dS)
    out = []
    for i, (c0, A) in enumerate(zip(starts, cum)):
        S = states[i]
        if fault == "state not carried":
            S = S0
        elif fault == "state to the wrong chunk":
            S = states[max(i - 1, 0)]
        elif fault == "block chain not carried" and i > 0:
            S = S.clone()
            S[:, :, :64, :64] = 0.0
        qi = q[:, c0:c0 + c]
        if fault == "dk block dropped":
            qi = torch.cat([torch.zeros_like(qi[..., :64]), qi[..., 64:]], -1)
        e_a = 1.0 if fault == "inter without e^A" else torch.exp(A)[..., None]
        out.append(intra[i] + torch.einsum("bihk,bhkv->bihv", qi * e_a, S))
    out = torch.cat(out, dim=1)[:, :n]
    if normalize:
        den = out[..., -65 if fault == "normaliser from another block" else -1]
        out = out[..., :-1] / torch.clamp(den.abs(), min=1.0)[..., None]
    return out, states[-1]


def check_chunked_kernels():
    """Phase 2's cases of #13; returns {kernel name: max abs error over the
    main shape's cases}."""
    import torch
    from repro_torch.kernels import chunked_linear as cl

    H, dk, dv, C = SSM_HEADS, SSM_DK, SSM_DV, SSM_CHUNK
    err = check_chunked("main (the slice's shape)",
                        chunked_inputs(1, CONTEXT, H, dk, dv, 90, bcast=True),
                        C)
    for i, (name, shape, kw, chunk, norm) in enumerate([
            ("n off the chunk", (1, 8000, H, dk, dv), {}, C, False),
            ("n 33", (1, 33, H, dk, dv), {}, C, False),
            ("n 1", (1, 1, H, dk, dv), {}, C, False),
            ("dk != dv", (2, 1000, 8, 32, 16), {}, 64, False),
            ("normalize", (1, 2048, 8, dk, dv), {}, C, True),
            ("initial state", (1, 4096, H, dk, dv),
             dict(init=True, bcast=True), C, False),
            ("b > 1", (4, 2048, 16, dk, dv), {}, C, False),
            ("reduced config's 8-wide heads", (2, 100, 16, 8, 8), {}, 16,
             False)]):
        x = chunked_inputs(*shape, seed=91 + i, **kw)
        if norm:
            x = x[:4] + (None,)
        check_chunked(name, x, chunk, normalize=norm)

    # fp32 raises TypeError, launching nothing
    n0 = cl.chunked_linear_attention.launches
    try:
        cl.chunked_linear_attention(*chunked_inputs(
            1, 64, 2, dk, dv, 0, dtype=torch.float32)[:4])
    except TypeError:
        pass
    else:
        raise AssertionError("#13 took fp32 operands")
    check(cl.chunked_linear_attention.launches == n0,
          "an fp32 call launched #13")
    print("check fp32 operands: TypeError from the #13 wrapper, no launch")

    # gate sensitivity: a faulty plain version misses the per-row gate by
    # far (the padded rows' decay moves only the final state); the chain's
    # faults on a case from an initial state
    rels = {}
    for init, faults in ((False, ("state not carried", "inter without e^A",
                                  "exclusive cumsum", "causal mask dropped",
                                  "padded rows decay")),
                         (True, ("state to the wrong chunk",
                                 "initial state dropped"))):
        q, k, v, a, s0 = chunked_inputs(1, 1000, 16, dk, dv,
                                        seed=98 if init else 99, init=init)
        out, st = cl.chunked_linear_attention(q, k, v, a, chunk=C,
                                              initial_state=s0)
        for fault in faults:
            bad, st_bad = faulty_chunked_plain(q, k, v, a, C, fault, s0)
            rels[fault] = (within_rows(st.flatten(2), st_bad.flatten(2))[2]
                           if fault == "padded rows decay"
                           else within_rows(out, bad)[2])
    print("check #13 gate sensitivity (n 1000, chunk 256, 16 heads; the "
          "last two from an initial state): a faulty plain version's worst "
          "row (padded decay: head state) error / its max: "
          + ", ".join(f"{k} {r:.2f}" for k, r in rels.items()))
    for fault, rel in rels.items():
        check(rel >= 10 * TOL, f"the #13 gate misses '{fault}'")
    return {"chunked_linear_attention": err,
            "chunked_linear_attention_wide": check_chunked_wide()}


MLSTM_HEADS, MLSTM_HD = 4, 1024     # xlstm-1.3b's mLSTM: dk = dv = 1024


def check_chunked_wide():
    """Phase 2's cases of #13's wide path (heads past 128: two launches a
    call); returns the max abs error of the mLSTM shape's case."""
    import torch
    from repro_torch.kernels import chunked_linear as cl

    H, hd, C = MLSTM_HEADS, MLSTM_HD, SSM_CHUNK
    x = chunked_inputs(1, CONTEXT, H, hd, hd, 100)
    n0 = cl.chunked_linear_attention.launches
    err = check_chunked("wide: the mLSTM's shape, normalised", x, C,
                        normalize=True)
    check(cl.chunked_linear_attention.launches == n0 + 2,
          "the wide path is not two launches a call")
    # the same call twice: the same bits, and the sync words zero again
    again = [cl.chunked_linear_attention(*x[:4], chunk=C, normalize=True)
             for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*again)),
          "#13's wide path is not deterministic")
    check(all(int(w.abs().sum()) == 0 for w in cl._SYNC.values()),
          "#13's sync words are not zero after a call")
    print("check wide: the mLSTM's shape twice: bit-identical, sync words "
          "zero")
    for i, (name, shape, kw, chunk, norm) in enumerate([
            ("wide: n off the chunk", (1, 1000, H, hd, hd), {}, C, True),
            ("wide: n 1", (1, 1, H, hd, hd), {}, C, True),
            ("wide: initial state", (1, 2048, H, hd, hd), dict(init=True), C,
             True),
            ("wide: dk != dv", (1, 2048, H, 512, hd), {}, C, False),
            ("wide: b > 1", (3, 1024, H, hd, hd), {}, C, True),
            ("wide: 136-wide heads", (2, 1000, 8, 136, 136), dict(init=True),
             C, False)]):
        q, k, v, a, s0 = chunked_inputs(*shape, seed=101 + i, **kw)
        if norm and s0 is not None:
            s0 = torch.nn.functional.pad(s0, (0, 1))
        check_chunked(name, (q, k, v, a, s0), chunk, normalize=norm)

    # gate sensitivity on the wide path: a faulty plain version misses the
    # per-row gate by far (the block faults on 136-wide heads from an
    # initial state, where the first 64 x 64 block is half a head's state;
    # the normaliser's on the mLSTM's heads)
    rels = {}
    for shape, norm, faults in (
            ((1, 1000, 8, 136, 136), False, ("dk block dropped",
                                             "block chain not carried")),
            ((1, 1000, H, hd, hd), True, ("normaliser from another block",))):
        q, k, v, a, s0 = chunked_inputs(*shape, seed=111, init=not norm)
        out, _ = cl.chunked_linear_attention(q, k, v, a, chunk=C,
                                             normalize=norm, initial_state=s0)
        good, _ = faulty_chunked_plain(q, k, v, a, C, None, s0, norm)
        check(within_rows(out, good)[0], "#13's wide path disagrees with "
                                         "the faulty plain's own order")
        for fault in faults:
            bad, _ = faulty_chunked_plain(q, k, v, a, C, fault, s0, norm)
            rels[fault] = within_rows(out, bad)[2]
    print("check #13 wide gate sensitivity (n 1000, chunk 256): a faulty "
          "plain version's worst row error / its max: "
          + ", ".join(f"{k} {r:.2f}" for k, r in rels.items()))
    for fault, rel in rels.items():
        check(rel >= 10 * TOL, f"the #13 wide gate misses '{fault}'")
    return err


def check_kernels():
    """Phase 2; returns {kernel name: max abs error over its main-shape
    cases}."""
    import torch

    bf16 = torch.bfloat16
    main = "g=8 rows=64 hd=128 m_c=8192 ld=768 bf16"
    errs = check_case(f"main {main}",
                      kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=0))
    dominant = kernel_inputs(8, 32, 2, 1, 128, 8192, 24, bf16, seed=6,
                             masked=True, dec_boost=3.0)
    check_gate_sensitivity(f"main {main} decode-dominant masked", dominant)
    errs = [max(a, b) for a, b in zip(errs, check_case(
        f"main {main} decode-dominant masked", dominant))]
    ragged = [
        ("m_c=8191 masked-arm bf16", (8, 32, 2, 1, 128, 8191, 24, 1)),
        ("n=2 p=2 m_c=1000 bf16", (8, 8, 2, 2, 128, 1000, 5, 2)),
        ("rows=6 g=2 m_c=77 bf16", (2, 3, 2, 1, 128, 77, 3, 3)),
        ("hd=80 rows=96 m_c=700 bf16", (8, 48, 2, 1, 80, 700, 9, 4)),
        # zamba2's shared block: 32 kv heads of hd 112, p 1, 32 rows each
        ("hd=112 g=32 rows=32 m_c=8192 bf16", (32, 32, 1, 1, 112, 8192, 24,
                                              7)),
        ("hd=112 g=32 rows=32 m_c=1000 bf16", (32, 32, 1, 1, 112, 1000, 24,
                                              8)),
    ]
    for name, (g, b, p, n, hd, m_c, c_d, seed) in ragged:
        check_case(name, kernel_inputs(g, b, p, n, hd, m_c, c_d, bf16, seed,
                                       masked=True))
    check_fp32_raises(kernel_inputs(2, 3, 2, 1, 128, 77, 3, torch.float32, 5))
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
            ("hd=80 rows=96 m_c=700 int8", (8, 48, 2, 1, 80, 700, 9, 14)),
            ("hd=112 g=32 rows=32 m_c=8192 int8", (32, 32, 1, 1, 112, 8192,
                                                   24, 15)),
            ("hd=112 g=32 rows=32 m_c=1000 int8", (32, 32, 1, 1, 112, 1000,
                                                   24, 16))]:
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
        xd = forest_inputs(4, 8, 32, 2, 1, 128, 8192, FOREST_LENS,
                           FOREST_DEC_CAP, seed=21, masked=True,
                           dec_boost=3.0, quant=quant)
        err = max(check_grouped(f"main {tag}{fmain}", x, quant),
                  check_grouped(f"main {tag}{fmain} decode-dominant masked",
                                xd, quant))
        check_forest_split(x, xd, quant)
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
        # #5 against #3, #4 against #1, both at the default split
        sk = split_kw(x1)
        if quant:
            one = bd.fused_bifurcated_decode_q8(
                x1["q"], x1["kc"][0], x1["vc"][0], x1["ks"][0], x1["vs"][0],
                x1["kd"], x1["vd"], x1["bias"], **kw, **sk)
        else:
            one = bd.fused_bifurcated_decode(
                x1["q"], x1["kc"][0], x1["vc"][0], x1["kd"], x1["vd"],
                x1["bias"], **kw, **sk)
        grp = (bd.grouped_fused_bifurcated_decode_q8 if quant
               else bd.grouped_fused_bifurcated_decode)(
            *grouped_args(x1, quant), **kw, **sk)
        torch.cuda.synchronize()
        ok, e1, rel = within(grp, one)
        same = bool(torch.equal(grp, one))
        print(f"check {tag}G=1 m_c=2049 grouped vs single-prefix kernel "
              f"(S={sk['splits']}): "
              f"max_abs_err={e1:.3e} ({rel:.1e} of max |out|, gate 2e-2; "
              f"bit-equal {same}"
              + ("" if same else ": the bits differ, the gate holds") + ")")
        check(ok, f"{tag}G=1: grouped kernel disagrees with the single-prefix "
                  f"kernel")
        out[kname] = err
    check_forest_gate_sensitivity(f"main {main} int8 ctx; main {fmain}",
                                  x_q, x_g)
    check_single_split_kernels(dominant)
    check_partials_split()
    out.update(check_tree_kernels())
    out.update(check_paged_kernels())
    check_split_kernels()
    out.update(check_packed_kernels())
    out.update(check_flash_kernels())
    out.update(check_chunked_kernels())
    return out


# ---------------------------------------------------------------------------
# phase 3: the serving path at the published width
# ---------------------------------------------------------------------------

BATCH, CONTEXT, STEPS = 32, 8192, 16
WARM_STEPS = 8      # decode steps before the step compared across paths


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from repro_torch.kernels import KERNELS

    for kern in KERNELS:
        kern.launches = 0


def read_launches():
    from repro_torch.kernels import KERNELS

    return {kern.__name__: kern.launches for kern in KERNELS}


@contextlib.contextmanager
def packed_plain_at_kernel_splits():
    """#10's / #11's plain versions, under ``plain_versions``, at the
    share count their kernels take by default on this card
    (``packed_split_count``), in place of the CPU's splits=1: for gates
    held at the kernel's S."""
    from repro_torch.kernels import bifurcated_decode as bd

    saved = bd._packed_split_arg
    bd._packed_split_arg = lambda splits, q, n_dec, on_cuda: saved(
        splits, q, n_dec, True)
    try:
        yield
    finally:
        bd._packed_split_arg = saved


class plain_versions:
    """Route every kernel wrapper to its plain version on the card, for
    the duration of a ``with`` block, and check on the way out that the
    block launched no kernel (the gates that measure the plain versions'
    distance rely on it)."""

    def __enter__(self):
        from repro_torch.kernels import bifurcated_decode as bd
        from repro_torch.kernels import chunked_linear as cl
        from repro_torch.kernels import flash_prefill as fp

        self.mods = (bd, fp, cl)
        self.saved = [m._on_cuda for m in self.mods]
        self.counts = read_launches()
        for m in self.mods:
            m._on_cuda = lambda *t: False

    def __exit__(self, exc_type, *exc):
        for m, f in zip(self.mods, self.saved):
            m._on_cuda = f
        if exc_type is None:
            check(read_launches() == self.counts,
                  "a run on the plain versions launched a kernel")


def expect_counts(counts, want):
    """The path just run launched each kernel of ``want`` (name: count) as
    often as it says, and no other kernel."""
    for k, v in counts.items():
        check(v == want.get(k, 0),
              f"{k} launched {v} times, want {want.get(k, 0)}")


def expect_launches(counts, name, want):
    """The path just run launched kernel ``name`` ``want`` times and no
    other kernel."""
    expect_counts(counts, {name: want})


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
    decode_ms_in_turns("serve", engine, params, ctx, prefill_s)
    host_us_per_call("serve", bd.fused_bifurcated_decode,
                     (cache.k_ctx[0], cache.v_ctx[0]),
                     cfg.n_heads // cfg.n_kv_heads, cache.decode_capacity,
                     seed=4)
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

    def attn(i, layer, h, impl, plain=False):
        lc = {"k_ctx": c.k_ctx[i], "v_ctx": c.v_ctx[i],
              "k_dec": c.k_dec[i].clone(), "v_dec": c.v_dec[i].clone()}
        with plain_versions() if plain else contextlib.nullcontext():
            return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                           position=position, bifurcated=True,
                                           impl=impl)

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
    with plain_versions():
        lp, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
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
    check(err_kf <= max(TOL * scale, 1.5 * err_pf),
          "kernel path logits disagree with the flash path")
    profile_splits("serve", "fused decode",
                   lambda _: decode_fn(model, params, fresh(cache), tok),
                   cfg.n_layers)

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
    served int8 cache (for phase 4), the q8 kernel's launch count of the
    counted generate and its tokens."""
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
    decode_ms_in_turns("serve int8", engine, params, ctx, prefill_s)
    host_us_per_call("serve int8", bd.fused_bifurcated_decode_q8,
                     (cache.k_ctx[0], cache.v_ctx[0], cache.k_scale[0],
                      cache.v_scale[0]), cfg.n_heads // cfg.n_kv_heads,
                     cache.decode_capacity, seed=4)
    # the bf16 cache of phase 3 saw these WARM_STEPS tokens too
    for t in range(WARM_STEPS):
        _, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                     impl="kernel")
    tok = tokens[:, WARM_STEPS:WARM_STEPS + 1]
    position = cache.context_len + cache.dec_length

    def attn(i, layer, h, plain=False):
        lc = {"k_ctx": cache.k_ctx[i], "v_ctx": cache.v_ctx[i],
              "k_scale": cache.k_scale[i], "v_scale": cache.v_scale[i],
              "k_dec": cache.k_dec[i].clone(), "v_dec": cache.v_dec[i].clone()}
        with plain_versions() if plain else contextlib.nullcontext():
            return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                           position=position, bifurcated=True,
                                           impl="kernel")

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
    with plain_versions():
        lp, _ = model.decode_step(params, fresh(cache), tok, impl="kernel")
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
    return cache, counts["fused_bifurcated_decode_q8"], result.tokens


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
    from repro_torch.models import blocks

    depth = int(fcache.dec_lens[slots[0][0]])
    idx = [torch.tensor(s * (BATCH // len(s)), device=DEVICE) for s in slots]
    rel_layer = [0.0]
    plain_err = [0.0, 0.0]      # max abs error, and its share of max |out|

    def forest_attn(i, layer, h, plain=False):
        lc = {n: getattr(fcache, n)[i] for n in ("k_ctx", "v_ctx")}
        if quant:
            lc.update({n: getattr(fcache, n)[i]
                       for n in ("k_scale", "v_scale")})
        lc.update(k_dec=fcache.k_dec[i].clone(), v_dec=fcache.v_dec[i].clone())
        with plain_versions() if plain else contextlib.nullcontext():
            return blocks.attention_decode_forest(
                cfg, layer["attn"], h, lc, group_ids=fcache.group_ids,
                ctx_lens=fcache.ctx_lens, dec_lens=fcache.dec_lens,
                impl="kernel")

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
    with plain_versions():
        lp, _ = model.decode_step(params, _fork(fcache), tokens, impl="kernel")
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
        check(err_fs <= max(TOL * top, 1.5 * err_ps),
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
    kernel's launch count of the counted chunk, its per-layer max abs
    error against its plain versions, and the two runs' tokens (after the
    first chunk, and at the end of each run) for phase 3e."""
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
    outs = {"first": _copy_outputs(eng_b)}
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
    # where a forest step's time goes, #4 / #5 at the default split and at
    # splits=1, and the wrapper's host work a call
    fc = st_b.cache
    profile_splits(tag, "grouped",
                   lambda _: decode_fn(model, params, _fork(fc),
                                       st_b.tokens),
                   cfg.n_layers, ptag=" forest" + (" int8" if quant else ""))
    from repro_torch.kernels import bifurcated_decode as bd

    p = cfg.n_heads // cfg.n_kv_heads
    host_us_per_call(tag, getattr(bd, kname),
                     (fc.k_ctx[0], fc.v_ctx[0])
                     + ((fc.k_scale[0], fc.v_scale[0]) if quant else ())
                     + (fc.group_ids.repeat_interleave(p), fc.ctx_lens),
                     p, FOREST_DEC_CAP, seed=15)

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
    outs.update(a=_copy_outputs(eng), b=_copy_outputs(eng_b))
    del eng, st
    return st_b.cache, counts[kname], path_err, outs


def _path_prefix_cache(tcache, path, idx, depth, quant):
    """The single-prefix cache that one request of the trie cache
    ``tcache`` describes, for the slots ``idx``: its path's nodes' live
    keys concatenated, and those slots' decode arms (copies)."""
    import torch
    from repro_torch.core.kv_cache import BifurcatedCache
    from repro_torch.core.quantized import QuantBifurcatedCache

    lens = tcache.node_lens.tolist()
    names = ("k_ctx", "v_ctx") + (("k_scale", "v_scale") if quant else ())
    ctx = {n: torch.cat([getattr(tcache, n)[:, nid, :, :lens[nid]]
                         for nid in path], dim=2).contiguous()
           for n in names}
    dec = dict(k_dec=tcache.k_dec[:, idx].clone(),
               v_dec=tcache.v_dec[:, idx].clone(), dec_length=depth,
               ctx_layout="gmk")
    return (QuantBifurcatedCache if quant else BifurcatedCache)(**ctx, **dec)


def tree_vs_single(cfg, model, params, tcache, tokens, slots, req_paths,
                   quant):
    """One decode step of the trie, per layer on the trie stream's own
    input: the tree kernel against its plain version, and against the
    single-prefix kernel path of each request over its path's nodes
    concatenated (the same decode arm); then the whole step against that
    path. Each request's single-prefix batch is its 8 slots tiled to 32.
    Returns the per-layer kernel-vs-plain max abs error."""
    import torch
    from repro_torch.models import blocks

    depth = int(tcache.dec_lens[slots[0][0]])
    idx = [torch.tensor(s * (BATCH // len(s)), device=DEVICE) for s in slots]
    lens = tcache.node_lens.tolist()
    path_lens = [sum(lens[nid] for nid in pth) for pth in req_paths]
    ctx_lens_b = tcache.slot_context_lens()
    names = ("k_ctx", "v_ctx") + (("k_scale", "v_scale") if quant else ())
    rel_layer = [0.0]
    plain_err = [0.0, 0.0]      # max abs error, and its share of max |out|

    def tree_attn(i, layer, h, plain=False):
        lc = {n: getattr(tcache, n)[i] for n in names}
        lc.update(k_dec=tcache.k_dec[i].clone(), v_dec=tcache.v_dec[i].clone())
        with plain_versions() if plain else contextlib.nullcontext():
            return blocks.attention_decode_tree(
                cfg, layer["attn"], h, lc, paths=tcache.paths,
                node_lens=tcache.node_lens, ctx_lens_b=ctx_lens_b,
                dec_lens=tcache.dec_lens, impl="kernel")

    def attn(i, layer, h):
        o = tree_attn(i, layer, h)
        ok, err, rel = within(o, tree_attn(i, layer, h, plain=True))
        check(ok, f"tree layer {i}: tree kernel attention disagrees with "
                  f"its plain versions ({rel:.2e} of max |out|)")
        plain_err[:] = max(plain_err[0], err), max(plain_err[1], rel)
        for r, s in enumerate(slots):
            lcs = {n: torch.cat([getattr(tcache, n)[i, nid][:, :lens[nid]]
                                 for nid in req_paths[r]], dim=1).contiguous()
                   for n in names}
            lcs.update(k_dec=tcache.k_dec[i][idx[r]],
                       v_dec=tcache.v_dec[i][idx[r]])
            o_s = blocks.attention_decode(
                cfg, layer["attn"], h[idx[r]], lcs,
                position=path_lens[r] + depth, bifurcated=True,
                impl="kernel")
            ok, _, rel = within(o[s], o_s[:len(s)])
            check(ok, f"tree layer {i} request {r}: tree kernel attention "
                      f"disagrees with the single-prefix kernel path over "
                      f"its path ({rel:.2e} of max |out|)")
            rel_layer[0] = max(rel_layer[0], rel)
        return o

    _per_layer_residual(cfg, model, params, model._embed(params, tokens), attn)
    lt, _ = model.decode_step(params, _fork(tcache), tokens, impl="kernel")
    with plain_versions():
        lp, _ = model.decode_step(params, _fork(tcache), tokens, impl="kernel")
    worst = None
    for r, s in enumerate(slots):
        single = _path_prefix_cache(tcache, req_paths[r], idx[r], depth,
                                    quant)
        ls, _ = model.decode_step(params, single, tokens[idx[r]],
                                  impl="kernel")
        del single
        live = ls.abs() < 1e29
        want = ls[:len(s)][live[:len(s)]]
        err_ts, top = gap(lt[s][live[:len(s)]], want)
        err_ps, _ = gap(lp[s][live[:len(s)]], want)
        check(bool(torch.isfinite(lt[s].float()[live[:len(s)]]).all()),
              "non-finite trie logits")
        check(err_ts <= max(TOL * top, 1.5 * err_ps),
              f"tree request {r}: logits disagree with the single-prefix "
              f"kernel path ({err_ts:.3e}, max |logit| {top:.3f})")
        if worst is None or err_ts / top > worst[0] / worst[1]:
            worst = (err_ts, top, err_ps, r)
    n_slots, c_d = tcache.k_dec.shape[1:3]
    print(f"serve tree{' int8' if quant else ''}: {depth + 1} live decode "
          f"slots of {c_d} (ld {n_slots * c_d}); per-layer attention, tree "
          f"kernel vs its plain versions max_abs_err={plain_err[0]:.3e} "
          f"({plain_err[1]:.2e} of max |out|), vs the single-prefix kernel "
          f"path over each request's concatenated path "
          f"{rel_layer[0]:.2e} of max |out| (gates 2e-2); decode-step "
          f"logits, worst request {worst[3]}: {worst[0]:.3e} against max "
          f"|logit| {worst[1]:.3f} (plain versions {worst[2]:.3e}; gate "
          f"max(2e-2 x max |logit|, 1.5 x plain))")
    return plain_err[0]


def serve_tree(cfg, model, params, quant):
    """Phase 3d: TreeServeEngine at the published width. Returns the trie
    cache of the run without the cancel (for phase 4), the tree kernel's
    launch count of the counted chunk, its per-layer max abs error against
    its plain versions, and the two runs' tokens (after the first chunk,
    and at the end of each run) for phase 3e."""
    import numpy as np
    import torch
    from repro_torch.configs import TreeConfig
    from repro_torch.runtime.serve import TreeServeEngine

    tag = "serve tree int8" if quant else "serve tree"
    kname = ("tree_fused_bifurcated_decode_q8" if quant
             else "tree_fused_bifurcated_decode")
    tcfg = TreeConfig(n_nodes=TREE_NODES, depth=TREE_DEPTH, slots=BATCH,
                      node_capacity=TREE_CAP, decode_capacity=TREE_DEC_CAP,
                      use_kernel=True,
                      cache_dtype="int8" if quant else "bfloat16")
    rng = np.random.RandomState(2)
    toks = {name: torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                                  device=DEVICE)
            for name, m in TREE_TOKENS.items()}
    per_req = BATCH // len(TREE_REQUESTS)

    def start():
        eng = TreeServeEngine(model, cfg, tcfg)
        st = eng.init_state(device=DEVICE)
        slots = []
        for req in TREE_REQUESTS:
            st, s = eng.admit(params, st, [toks[n] for n in req], per_req)
            slots.append(s)
        return eng, st, slots

    # run B, without the cancel: the reference of the bit-identity check
    # (and the path's warm-up)
    t0 = time.perf_counter()
    eng_b, st_b, slots = start()
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    st_b = eng_b.step_chunk(params, st_b, TREE_STEPS)
    outs = {"first": _copy_outputs(eng_b)}
    # run A, counted: the same admissions, then the same chunk
    eng, st, slots_a = start()
    check(slots_a == slots, "the two runs assigned different slots")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.step_chunk(params, st, TREE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    lens, req_paths = served_trie()
    req_tokens = ", ".join("+".join(str(TREE_TOKENS[n]) for n in r)
                           for r in TREE_REQUESTS)
    print(f"{tag}: 4 admissions ({req_tokens} tokens, 8 samples each) "
          f"{admit_s * 1e3:.1f} ms; {TREE_STEPS} "
          f"steps {wall * 1e3:.1f} ms ({wall / TREE_STEPS * 1e3:.2f} "
          f"ms/step) on {CARD[0]}; launches {counts}")
    expect_launches(counts, kname, cfg.n_layers * TREE_STEPS)
    check(eng.outputs == eng_b.outputs, "two identical runs differ")
    check([eng.requests[r]["path"] for r in range(4)] == req_paths,
          f"paths {[eng.requests[r]['path'] for r in range(4)]}")
    check(st.cache.node_lens.tolist() == lens,
          f"node_lens {st.cache.node_lens.tolist()}")
    check(eng.node_refs == [4, 2, 1, 1, 2, 1, 1, 0],
          f"node_refs {eng.node_refs}")
    io = eng.step_io_bytes(st)
    print(f"{tag}: {eng.node_live.count(True)} live nodes, "
          f"{sum(eng.node_len)} keys (longest path "
          f"{max(sum(lens[n] for n in p) for p in req_paths)}); modelled "
          f"bytes per layer-step {io['total'] / 1e6:.1f} MB, of which "
          f"context {io['ctx_bytes'] / 1e6:.1f} MB (step_io_bytes, which "
          f"models bf16 nodes as the reference does)")
    for s in sum(slots, []):
        out = eng.outputs[s]
        check(len(out) == TREE_STEPS + 1, f"slot {s}: {len(out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in out), "token range")
        check(all(np.isfinite(eng.logps[s])), "logprobs")
    path_err = tree_vs_single(cfg, model, params, st_b.cache, st_b.tokens,
                              slots, req_paths, quant)
    if not quant:
        profile_splits(tag, "tree",
                       lambda _: decode_fn(model, params, _fork(st_b.cache),
                                           st_b.tokens),
                       cfg.n_layers, ptag=" tree")

    # cancel and retire the A2 request: its leaf frees, SYS and TPL_A keep
    # one reference less; readmit [SYS, TPL_A, A3]: two levels reused, one
    # node written; the untouched requests must not move by one bit
    st = eng.cancel_request(st, 1)
    check(eng.retire_requests(st) == [1], "retire")
    check(eng.node_refs == [3, 1, 1, 0, 2, 1, 1, 0] and not eng.node_live[3],
          f"after the retire: node_refs {eng.node_refs}")
    stats = dict(eng.prefix_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, s_new = eng.admit(params, st, [toks[n] for n in TREE_READMIT],
                          per_req)
    torch.cuda.synchronize()
    readmit_s = time.perf_counter() - t0
    reused = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    check(s_new == slots[1], f"readmitted into slots {s_new}")
    check(eng.prefix_stats["partial_hits"] == stats["partial_hits"] + 1
          and eng.prefix_stats["reused_tokens"]
          == stats["reused_tokens"] + reused
          and eng.prefix_stats["new_tokens"]
          == stats["new_tokens"] + TREE_TOKENS["A3"],
          f"prefix_stats {eng.prefix_stats}")
    check(eng.node_live.count(True) == 7 and eng.node_len[3] ==
          TREE_TOKENS["A3"] and eng.node_refs == [4, 2, 1, 1, 2, 1, 1, 0],
          f"after the readmit: node_live {eng.node_live}, node_refs "
          f"{eng.node_refs}")
    st = eng.step_chunk(params, st, TREE_MORE)
    st_b = eng_b.step_chunk(params, st_b, TREE_MORE)
    same = all(eng.outputs[s] == eng_b.outputs[s]
               for r in (0, 2, 3) for s in slots[r])
    print(f"{tag}: request A2 cancelled and retired (its leaf freed, "
          f"SYS/TPL_A refs 4/2 -> 3/1), [SYS, TPL_A, A3] readmitted in "
          f"{readmit_s * 1e3:.1f} ms reusing {reused} tokens and writing "
          f"one node of {TREE_TOKENS['A3']}, into slots "
          f"{s_new[0]}-{s_new[-1]}; {TREE_MORE} more steps: untouched "
          f"requests' {1 + TREE_STEPS + TREE_MORE} tokens per slot "
          f"bit-identical to the run without the cancel: {same}")
    check(same, "the cancel and readmit moved another request's tokens")
    check(all(len(eng.outputs[s]) == TREE_MORE + 1 for s in s_new),
          "readmitted slots' outputs")
    outs.update(a=_copy_outputs(eng), b=_copy_outputs(eng_b))
    del eng, st
    return st_b.cache, counts[kname], path_err, outs


# ---------------------------------------------------------------------------
# phase 3e: the paged pool at the published width
# ---------------------------------------------------------------------------

PAGE = 128                  # phase 3e's page size, tokens
PAGED_FOREST_PAGES = 160    # below the forest's envelope of 4 x 64 pages


def _paged_kname(quant):
    return ("paged_fused_bifurcated_decode_q8" if quant
            else "paged_fused_bifurcated_decode")


def paged_vs_plain(cfg, model, params, cache, tokens, tag, dense=None):
    """One decode step of a paged cache, per layer on the paged stream's
    own input: the paged kernel against its plain versions and, given
    ``dense(i, layer, h)`` (the dense kernel path's attention on the same
    input), against that. Returns the kernel-vs-plain max abs error."""
    from repro_torch.models import blocks

    store = cache.store
    pools = {"k_pages": store.k_pages, "v_pages": store.v_pages}
    if hasattr(store, "k_scale_pages"):
        pools.update(k_scale_pages=store.k_scale_pages,
                     v_scale_pages=store.v_scale_pages)
    paths, dec_lens = cache.slot_paths(), cache.slot_dec_lens()
    ctx_lens_b = cache.slot_context_lens()
    plain_err = [0.0, 0.0]      # max abs error, and its share of max |out|
    dense_err = [0.0, 0.0]

    def paged_attn(i, layer, h, plain=False):
        lc = {n: t[i] for n, t in pools.items()}
        lc.update(k_dec=cache.k_dec[i].clone(), v_dec=cache.v_dec[i].clone())
        with plain_versions() if plain else contextlib.nullcontext():
            return blocks.attention_decode_paged(
                cfg, layer["attn"], h, lc, page_tables=store.page_tables,
                seg_lens=store.seg_lens, paths=paths, ctx_lens_b=ctx_lens_b,
                dec_lens=dec_lens, impl="kernel")

    def attn(i, layer, h):
        o = paged_attn(i, layer, h)
        ok, err, rel = within(o, paged_attn(i, layer, h, plain=True))
        check(ok, f"{tag} layer {i}: paged kernel attention disagrees with "
                  f"its plain versions ({rel:.2e} of max |out|)")
        plain_err[:] = max(plain_err[0], err), max(plain_err[1], rel)
        if dense is not None:
            ok, err, rel = within(o, dense(i, layer, h))
            check(ok, f"{tag} layer {i}: paged kernel attention disagrees "
                      f"with the dense kernel path ({rel:.2e} of max |out|)")
            dense_err[:] = max(dense_err[0], err), max(dense_err[1], rel)
        return o

    _per_layer_residual(cfg, model, params, model._embed(params, tokens), attn)
    print(f"{tag}: per-layer attention on the paged stream's input, paged "
          f"kernel vs its plain versions max_abs_err={plain_err[0]:.3e} "
          f"({plain_err[1]:.2e} of max |out|)"
          + (f", vs the dense kernel path max_abs_err={dense_err[0]:.3e} "
             f"({dense_err[1]:.2e})" if dense is not None else "")
          + f" (gates 2e-2, {cfg.n_layers} layers)")
    return plain_err[0]


def serve_paged_single(cfg, model, params, ctx, dense_tokens, dense_cache,
                       warm_tokens, quant):
    """Phase 3e, single prefix: ServeEngine(ctx_store="paged") on phase
    3's (3b's) workload; the paged kernel must launch 24 x 15 times, its
    tokens must equal the dense kernel path's ``dense_tokens`` (phase 3's,
    3b's: #8 and #1, #9 and #3, cut the same pieces at their default
    split), and one decode step (after phase 3's WARM_STEPS tokens) is held
    per layer against the paged plain versions and the dense kernel path
    on the same input.
    Returns the paged cache (for phase 4), the launch count and the
    per-layer kernel-vs-plain max abs error."""
    import torch
    from repro_torch.configs import ServeConfig
    from repro_torch.core.paged import PagedBifurcatedCache
    from repro_torch.kernels.ops import live_page_list
    from repro_torch.models import blocks
    from repro_torch.runtime.serve import ServeEngine

    tag = "serve paged int8" if quant else "serve paged"
    kname = _paged_kname(quant)
    scfg = ServeConfig(batch=BATCH, context_len=CONTEXT,
                       decode_capacity=max(16, STEPS + 8), bifurcated=True,
                       use_kernel=True,
                       cache_dtype="int8" if quant else "bfloat16",
                       ctx_store="paged", page_size=PAGE)
    engine = ServeEngine(model, cfg, scfg)
    engine.generate(params, ctx, n_steps=2)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"{tag}: generate launches {counts}")
    expect_launches(counts, kname, cfg.n_layers * (STEPS - 1))
    toks, lps = result.tokens, result.logprobs
    check(tuple(toks.shape) == (BATCH, STEPS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()), "logprobs")
    how = f"phase {'3b' if quant else '3'}'s dense kernel path's"
    same = bool(torch.equal(toks, dense_tokens))
    n_diff = int((toks != dense_tokens).sum())
    t0 = time.perf_counter()
    _, cache = engine.prefill_shared(params, ctx, BATCH)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(isinstance(cache, PagedBifurcatedCache), "paged cache family")
    store = cache.store
    n_pages = CONTEXT // PAGE
    n_live = int(live_page_list(store.page_tables, store.seg_lens,
                                PAGE)[2][0])
    check(store.num_pages == n_pages and n_live == n_pages,
          f"pool of {store.num_pages} pages, {n_live} live")
    print(f"{tag}: generate {wall * 1e3:.1f} ms = prefill {prefill_s * 1e3:.1f}"
          f" ms + {STEPS - 1} decode steps at "
          f"{(wall - prefill_s) / (STEPS - 1) * 1e3:.2f} ms/step on "
          f"{CARD[0]}; context on {n_live} pages of {PAGE}; tokens "
          f"bit-identical to {how}: {same} ({n_diff} of {toks.numel()} "
          f"differ)")
    check(same, f"{tag}: the tokens differ from {how}")
    for t in range(WARM_STEPS):
        _, cache = model.decode_step(params, cache, warm_tokens[:, t:t + 1],
                                     impl="kernel")
    check(cache.dec_length == dense_cache.dec_length, "decode depths")
    position = CONTEXT + cache.dec_length
    names = ("k_ctx", "v_ctx") + (("k_scale", "v_scale") if quant else ())

    def dense(i, layer, h):
        lc = {n: getattr(dense_cache, n)[i] for n in names}
        lc.update(k_dec=dense_cache.k_dec[i].clone(),
                  v_dec=dense_cache.v_dec[i].clone())
        return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                       position=position, bifurcated=True,
                                       impl="kernel")

    err = paged_vs_plain(cfg, model, params, cache,
                         warm_tokens[:, WARM_STEPS:WARM_STEPS + 1], tag,
                         dense)
    return cache, counts[kname], err


def serve_paged_forest(cfg, model, params, quant, dense_outs):
    """Phase 3e, forest: ForestServeEngine(ctx_store="paged") at phase 3c's
    shapes over a pool of PAGED_FOREST_PAGES pages, below the envelope: the
    4000-token readmission raises PoolExhausted before the retire (and
    mutates nothing) and fits after it into freed pages, which are filled
    with NaN first. Returns the per-layer kernel-vs-plain max abs
    error."""
    import numpy as np
    import torch
    from repro_torch.configs import ForestConfig
    from repro_torch.core.errors import PoolExhausted
    from repro_torch.kernels.ops import live_page_list
    from repro_torch.runtime.serve import ForestServeEngine

    tag = "serve paged forest" + (" int8" if quant else "")
    kname = _paged_kname(quant)
    fcfg = ForestConfig(n_groups=4, slots=BATCH, ctx_capacity=CONTEXT,
                        decode_capacity=FOREST_DEC_CAP, use_kernel=True,
                        cache_dtype="int8" if quant else "bfloat16",
                        ctx_store="paged", page_size=PAGE,
                        num_pages=PAGED_FOREST_PAGES)
    rng = np.random.RandomState(1)       # phase 3c's prompts
    ctxs = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                            device=DEVICE) for m in FOREST_LENS]
    new_ctx = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                          (1, READMIT_LEN)), device=DEVICE)
    pages = [-(-m // PAGE) for m in FOREST_LENS]

    def start():
        eng = ForestServeEngine(model, cfg, fcfg)
        st = eng.init_state(device=DEVICE)
        slots = []
        for c in ctxs:
            st, s = eng.admit(params, st, c, BATCH // len(ctxs))
            slots.append(s)
        return eng, st, slots

    eng_b, st_b, slots = start()
    st_b = eng_b.step_chunk(params, st_b, FOREST_STEPS)
    first_b = _copy_outputs(eng_b)
    eng, st, slots_a = start()
    check(slots_a == slots, "the two runs assigned different slots")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.step_chunk(params, st, FOREST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"{tag}: 4 admissions onto {sum(pages)} pages of a "
          f"{PAGED_FOREST_PAGES}-page pool (envelope {4 * CONTEXT // PAGE}); "
          f"{FOREST_STEPS} steps {wall * 1e3:.1f} ms "
          f"({wall / FOREST_STEPS * 1e3:.2f} ms/step); launches {counts}")
    expect_launches(counts, kname, cfg.n_layers * FOREST_STEPS)
    check(eng.outputs == eng_b.outputs, "two identical runs differ")
    err = paged_vs_plain(cfg, model, params, st_b.cache, st_b.tokens, tag)

    store = st.cache.store

    def n_live():
        return int(live_page_list(store.page_tables, store.seg_lens,
                                  PAGE)[2][0])

    def snapshot():
        return (eng.page_alloc.state_dict(), list(eng.group_live),
                dict(eng.group_pages), list(eng.slot_group),
                store.page_tables.clone(), store.seg_lens.clone())

    free0, live0 = eng.page_alloc.free_count(), n_live()
    check(free0 == PAGED_FOREST_PAGES - sum(pages) and live0 == sum(pages),
          f"free {free0}, live {live0}")
    before = snapshot()
    try:
        eng.admit(params, st, new_ctx, BATCH // len(ctxs))
    except PoolExhausted:
        exhausted = True
    else:
        exhausted = False
    check(exhausted, f"the {READMIT_LEN}-token readmission did not raise "
                     f"PoolExhausted on {free0} free pages")
    check(all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
              for a, b in zip(before, snapshot())),
          "the rejected admission mutated the engine")
    st = eng.cancel_group(st, 2)
    check(eng.retire_groups(st) == [2], "retire")
    free1, live1 = eng.page_alloc.free_count(), n_live()
    st = eng.release_retired(st)
    live2 = n_live()
    check(free1 == free0 + pages[2] and live1 == live0
          and live2 == live0 - pages[2],
          f"after the retire: free {free1}, live {live1} -> {live2}")
    # every free page (the retired group's among them) filled with NaN
    # (int8 values 127 and NaN scales): the readmission overwrites the pages
    # it takes, and no other may ever be read
    free_ids = torch.tensor(eng.page_alloc.free_pages(), device=DEVICE)
    for pool in (store.k_pages, store.v_pages):
        pool[:, free_ids] = 127 if quant else float("nan")
    if quant:
        store.k_scale_pages[:, free_ids] = float("nan")
        store.v_scale_pages[:, free_ids] = float("nan")
    t0 = time.perf_counter()
    st, s_new = eng.admit(params, st, new_ctx, BATCH // len(ctxs))
    torch.cuda.synchronize()
    readmit_s = time.perf_counter() - t0
    need = -(-READMIT_LEN // PAGE)
    free2, live3 = eng.page_alloc.free_count(), n_live()
    check(s_new == slots[2] and free2 == free1 - need
          and live3 == live2 + need,
          f"readmission: slots {s_new}, free {free2}, live {live3}")
    st = eng.step_chunk(params, st, FOREST_MORE)
    st_b = eng_b.step_chunk(params, st_b, FOREST_MORE)
    same = all(eng.outputs[s] == eng_b.outputs[s]
               for gi in (0, 1, 3) for s in slots[gi])
    check(all(np.isfinite(eng.logps[s]).all() and
              len(eng.outputs[s]) == FOREST_MORE + 1 for s in s_new),
          "readmitted slots' outputs")
    # #4 / #5 and #8 / #9 at the same (default) split: the same pieces
    outs = (first_b == dense_outs["first"], _copy_outputs(eng),
            _copy_outputs(eng_b))
    dense_same = (outs[0] and outs[1] == dense_outs["a"]
                  and outs[2] == dense_outs["b"])
    print(f"{tag}: a {READMIT_LEN}-token readmission on {free0} free pages "
          f"raised PoolExhausted and mutated nothing; group 2 cancelled and "
          f"retired (free pages {free0} -> {free1}), release_retired: live "
          f"pages {live1} -> {live2}; {len(free_ids)} free pages filled with "
          f"NaN; readmitted in {readmit_s * 1e3:.1f} ms onto {need} pages "
          f"(free {free2}, live {live3}); {FOREST_MORE} more steps: "
          f"untouched groups' tokens bit-identical to the run without "
          f"retirement: {same}; every token equal to phase 3c's dense "
          f"forest ("
          + ("#9 and #5" if quant else "#8 and #4") + " at the default "
          f"split): {dense_same}")
    check(same, "the retire and readmit moved another group's tokens")
    check(dense_same, "the paged forest's tokens differ from the dense "
                      "forest's")
    del eng, st, eng_b, st_b
    return counts[kname], err


def serve_paged_tree(cfg, model, params, quant, dense_outs):
    """Phase 3e, trie: TreeServeEngine(ctx_store="paged") over phase 3d's
    trie (pages of 128: the leaves' last pages ragged): reused ancestors
    allocate no pages, the allocator's free count follows the admits, the
    cancel and retire, ``release_retired`` and the readmit, and every token
    equals phase 3d's dense trie. Returns the paged trie cache of the run
    without the cancel (for phase 4), the launch count and the per-layer
    kernel-vs-plain max abs error."""
    import numpy as np
    import torch
    from repro_torch.configs import TreeConfig
    from repro_torch.kernels.ops import live_page_list
    from repro_torch.runtime.serve import TreeServeEngine

    tag = "serve paged tree" + (" int8" if quant else "")
    kname = _paged_kname(quant)
    tcfg = TreeConfig(n_nodes=TREE_NODES, depth=TREE_DEPTH, slots=BATCH,
                      node_capacity=TREE_CAP, decode_capacity=TREE_DEC_CAP,
                      use_kernel=True,
                      cache_dtype="int8" if quant else "bfloat16",
                      ctx_store="paged", page_size=PAGE)
    rng = np.random.RandomState(2)       # phase 3d's prompts
    toks = {name: torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                                  device=DEVICE)
            for name, m in TREE_TOKENS.items()}
    per_req = BATCH // len(TREE_REQUESTS)
    pages = {n: -(-m // PAGE) for n, m in TREE_TOKENS.items()}
    envelope = TREE_NODES * (TREE_CAP // PAGE)
    want_free, seen = [], set()
    for req in TREE_REQUESTS:
        new = [n for n in req if n not in seen]
        seen.update(new)
        want_free.append((want_free[-1] if want_free else envelope)
                         - sum(pages[n] for n in new))

    def start():
        eng = TreeServeEngine(model, cfg, tcfg)
        st = eng.init_state(device=DEVICE)
        slots, free = [], []
        for req in TREE_REQUESTS:
            st, s = eng.admit(params, st, [toks[n] for n in req], per_req)
            slots.append(s)
            free.append(eng.page_alloc.free_count())
        check(free == want_free, f"free pages after the admits {free}, want "
                                 f"{want_free} (reused ancestors cost none)")
        return eng, st, slots

    eng_b, st_b, slots = start()
    st_b = eng_b.step_chunk(params, st_b, TREE_STEPS)
    eng, st, slots_a = start()
    check(slots_a == slots, "the two runs assigned different slots")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.step_chunk(params, st, TREE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    lens, req_paths = served_trie()
    print(f"{tag}: 4 admissions, free pages {envelope} -> "
          f"{' -> '.join(map(str, want_free))}; {TREE_STEPS} steps "
          f"{wall * 1e3:.1f} ms ({wall / TREE_STEPS * 1e3:.2f} ms/step) on "
          f"{CARD[0]}; launches {counts}")
    expect_launches(counts, kname, cfg.n_layers * TREE_STEPS)
    check(eng.outputs == eng_b.outputs, "two identical runs differ")
    check({n: len(ids) for n, ids in eng.node_pages.items()}
          == {n: -(-lens[n] // PAGE) for n in range(TREE_NODES) if lens[n]},
          f"node_pages {eng.node_pages}")
    first_same = _copy_outputs(eng) == dense_outs["first"]
    err = paged_vs_plain(cfg, model, params, st_b.cache, st_b.tokens, tag)

    store = st.cache.store

    def n_live():
        return int(live_page_list(store.page_tables, store.seg_lens,
                                  PAGE)[2][0])

    live0, free0 = n_live(), eng.page_alloc.free_count()
    st = eng.cancel_request(st, 1)
    check(eng.retire_requests(st) == [1], "retire")
    free1 = eng.page_alloc.free_count()
    check(eng.node_refs == [3, 1, 1, 0, 2, 1, 1, 0] and 3 not in
          eng.node_pages and free1 == free0 + pages["A2"],
          f"after the retire: node_refs {eng.node_refs}, free {free1}")
    st = eng.release_retired(st)
    live1 = n_live()
    check(live1 == live0 - pages["A2"], f"live pages {live0} -> {live1}")
    st, s_new = eng.admit(params, st, [toks[n] for n in TREE_READMIT],
                          per_req)
    free2, live2 = eng.page_alloc.free_count(), n_live()
    check(s_new == slots[1] and free2 == free1 - pages["A3"]
          and live2 == live1 + pages["A3"]
          and len(eng.node_pages[3]) == pages["A3"],
          f"readmission: slots {s_new}, free {free2}, live {live2}")
    st = eng.step_chunk(params, st, TREE_MORE)
    st_b = eng_b.step_chunk(params, st_b, TREE_MORE)
    same = all(eng.outputs[s] == eng_b.outputs[s]
               for r in (0, 2, 3) for s in slots[r])
    dense_same = (first_same and _copy_outputs(eng) == dense_outs["a"]
                  and _copy_outputs(eng_b) == dense_outs["b"])
    print(f"{tag}: request A2 cancelled and retired (its leaf's "
          f"{pages['A2']} pages back: free {free0} -> {free1}), "
          f"release_retired: live pages {live0} -> {live1}; [SYS, TPL_A, "
          f"A3] readmitted onto {pages['A3']} pages (free {free2}, live "
          f"{live2}); {TREE_MORE} more steps: untouched requests' tokens "
          f"bit-identical to the run without the cancel: {same}; every "
          f"token equal to phase 3d's dense trie: {dense_same}")
    check(same, "the cancel and readmit moved another request's tokens")
    check(dense_same, "the paged trie's tokens differ from the dense "
                      "trie's")
    del eng, st
    return st_b.cache, counts[kname], err


# ---------------------------------------------------------------------------
# phase 3f: packed heterogeneous steps at the published width
# ---------------------------------------------------------------------------

PACKED_CHUNK = 512              # phase 3f's prefill chunk, tokens
PACKED_BUF = 300                # phases 2 and 4: envelope rows before the
                                # chunk
PACKED_REQUESTS = (("SYS", "TPL_A", "A1"), ("SYS", "TPL_A", "A2"),
                   ("SYS", "TPL_B", "B1"), ("SYS", "TPL_B", "B2"))
PACKED_DECODE = 8               # decode-only steps at the end


def _packed_kname(quant):
    return ("packed_fused_bifurcated_decode_q8" if quant
            else "packed_fused_bifurcated_decode")


def _spy_first_logits(eng, method):
    """Record the logits each request's first tokens are sampled from, by
    wrapping ``eng.<method>`` (``_activate_pending`` or ``_sample_first``);
    returns the list they are appended to."""
    seen = []
    orig = getattr(eng, method)

    def wrap(*args):
        seen.append(args[2 if method == "_activate_pending" else 1]
                    .float().reshape(-1).clone())
        return orig(*args)

    setattr(eng, method, wrap)
    return seen


def _next_chunk(eng):
    """The chunk ``eng``'s next packed step advances: the oldest pending
    request, its chunk's live length, its tokens (1, cp), the chunk's
    first position, its rows' positions and the pending node's ancestor
    path."""
    import torch

    pend = eng._pending[min(eng._pending)]
    _, m_node = pend["new"][pend["node_i"]]
    cp = eng._prefill_chunk()
    cv = min(cp, m_node - pend["buf_len"])
    buf = torch.zeros((1, cp), dtype=torch.long)
    buf[0, :cv] = pend["suffix"][pend["done"]:pend["done"] + cv]
    start = pend["fresh_start"] + pend["buf_len"]
    fresh_pos = torch.arange(start, start + cp, dtype=torch.int32,
                             device=DEVICE)
    fpath = torch.tensor(pend["path"] + [-1] * (TREE_DEPTH
                                                - len(pend["path"])),
                         dtype=torch.int32, device=DEVICE)
    return pend, cv, buf.to(DEVICE), start, fresh_pos, fpath


def packed_step_fn(model, params, eng, st):
    """``eng``'s next packed step (``model.decode_step_packed``) as a
    callable, for ``profile_step``, on copies of the decode arms and of
    the pending node's envelopes: the engine's state is left as it was."""
    pend, cv, buf, _, fresh_pos, fpath = _next_chunk(eng)
    cache = _fork(st.cache)
    kw = dict(k_fresh=pend["k_fresh"].clone(),
              v_fresh=pend["v_fresh"].clone(), buf_len=pend["buf_len"],
              chunk_valid=cv, fresh_start=pend["fresh_start"],
              fresh_pos=fresh_pos, fresh_path=fpath)
    return lambda: model.decode_step_packed(params, cache, st.tokens, buf,
                                            **kw)


def packed_vs_plain(cfg, model, params, eng, st, tag):
    """The next packed step of ``eng``, per layer on the packed stream's
    own input (decode rows and chunk rows): the packed kernel against its
    plain versions, each on copies of the decode arms and envelopes.
    Returns the max abs error over the layers' decode and chunk rows."""
    from repro_torch.models import blocks
    from repro_torch.models.transformer import _layer

    pend, cv, buf, start, fresh_pos, fpath = _next_chunk(eng)
    cache = st.cache
    store = cache.store
    pools = {"k_pages": store.k_pages, "v_pages": store.v_pages}
    if hasattr(store, "k_scale_pages"):
        pools.update(k_scale_pages=store.k_scale_pages,
                     v_scale_pages=store.v_scale_pages)
    paths, dec_lens = cache.slot_paths(), cache.slot_dec_lens()
    ctx_lens_b = cache.slot_context_lens()
    errs = {"decode": [0.0, 0.0], "chunk": [0.0, 0.0]}

    def attn(i, layer, h, h_c, plain):
        lc = {n: t[i] for n, t in pools.items()}
        lc.update(k_dec=cache.k_dec[i].clone(), v_dec=cache.v_dec[i].clone(),
                  k_fresh=pend["k_fresh"][i].clone(),
                  v_fresh=pend["v_fresh"][i].clone())
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_versions())
                stack.enter_context(packed_plain_at_kernel_splits())
            return blocks.attention_decode_packed(
                cfg, layer["attn"], h, h_c, lc,
                page_tables=store.page_tables, seg_lens=store.seg_lens,
                paths=paths, ctx_lens_b=ctx_lens_b, dec_lens=dec_lens,
                buf_len=pend["buf_len"], chunk_valid=cv,
                fresh_start=pend["fresh_start"], fresh_pos=fresh_pos,
                fresh_path=fpath)

    x = model._embed(params, st.tokens)
    x_c = model._embed(params, buf)
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        h = blocks.apply_norm(cfg, layer["ln1"], x)
        h_c = blocks.apply_norm(cfg, layer["ln1"], x_c)
        a, a_c = attn(i, layer, h, h_c, False)
        p, p_c = attn(i, layer, h, h_c, True)
        for part, got, want in (("decode", a, p),
                                ("chunk", a_c[:, :cv], p_c[:, :cv])):
            ok, err, rel = within(got, want)
            check(ok, f"{tag} layer {i}: the packed kernel's {part} rows "
                      f"disagree with its plain versions ({rel:.2e} of max "
                      f"|out|)")
            errs[part] = [max(errs[part][0], err), max(errs[part][1], rel)]
        x, x_c = x + a, x_c + a_c
        x = x + blocks.apply_mlp(cfg, layer["mlp"],
                                 blocks.apply_norm(cfg, layer["ln2"], x))
        x_c = x_c + blocks.apply_mlp(cfg, layer["mlp"],
                                     blocks.apply_norm(cfg, layer["ln2"], x_c))
    n_live = int(st.active.sum())
    print(f"{tag}: one packed step ({n_live} live slots, a chunk of {cv} "
          f"tokens at rows {pend['buf_len']}..{pend['buf_len'] + cv - 1} of "
          f"its node's envelope, position {start}), per layer on the packed "
          f"stream's input: kernel vs its plain versions at the kernel's "
          f"S, decode rows "
          f"max_abs_err={errs['decode'][0]:.3e} ({errs['decode'][1]:.2e} of "
          f"max |out|), chunk rows {errs['chunk'][0]:.3e} "
          f"({errs['chunk'][1]:.2e}) (gates 2e-2, {cfg.n_layers} layers)")
    return max(errs["decode"][0], errs["chunk"][0])


def packed_node_kv(cfg, model, params, runs, toks, tag):
    """Every node the chunks wrote, in the kernel run and in the plain
    versions' run (``runs``: two (engine, state)), against a full prefill
    of its request's path, per layer, K and V (int8 nodes dequantized),
    gated as the whole steps are: the kernel run's distance within
    max(2e-2 x max |full|, 1.5 x the plain run's). Returns the kernel
    run's worst share of max |full|."""
    import torch

    worst, seen = (0.0, 0.0), set()
    for req in PACKED_REQUESTS:
        segs = [toks[n] for n in req]
        path, _ = runs[0][0].match_prefix(segs)
        _, full = model.prefill(params, torch.cat(segs, 1))
        off = 0
        for name, nid in zip(req, path):
            m = TREE_TOKENS[name]
            if nid not in seen:
                seen.add(nid)
                kvs = [eng._node_kv(st.cache, nid, m) for eng, st in runs]
                for i in range(cfg.n_layers):
                    for j, want in enumerate((full.k[i, 0, off:off + m],
                                              full.v[i, 0, off:off + m])):
                        err_k, top = gap(kvs[0][j][i], want)
                        err_p, _ = gap(kvs[1][j][i], want)
                        check(err_k <= max(TOL * top, 1.5 * err_p),
                              f"{tag}: node {nid} ({name}) layer {i}: its "
                              f"chunk-written {'KV'[j]} is {err_k:.3e} from a "
                              f"full prefill of its path (max {top:.3f}, "
                              f"plain versions {err_p:.3e})")
                        if err_k / top > worst[0]:
                            worst = (err_k / top, err_p / top)
                del kvs
            off += m
        del full
    print(f"{tag}: the {len(seen)} chunk-written nodes' K and V against a "
          f"full prefill of each request's path, per layer: worst "
          f"{worst[0]:.2e} of max |KV| (plain versions' run there "
          f"{worst[1]:.2e}; gate max(2e-2 of max |KV|, 1.5 x plain))")
    return worst[0]


def serve_packed(cfg, model, params, quant):
    """Phase 3f: TreeServeEngine(step_mode="packed", suffix_prefill=True,
    prefill_chunk=512) on the paged store (pages of 128) at the published
    width, phase 3d's prompts: R1 = [SYS, TPL_A, A1] (15 chunk steps),
    then R2 = [SYS, TPL_A, A2] (1 chunk) and R3 = [SYS, TPL_B, B1] (6
    chunks) while R1 decodes; R4 = [SYS, TPL_B, B2] raises PrefillInFlight
    while TPL_B is pending and changes nothing, then is admitted after R3
    lands (1 chunk); then 8 decode-only steps. Run with the kernels
    (counted) and again with the plain versions on the card; a
    synchronous step_mode="decode" engine admits the same paths. Returns
    the packed kernel's and the paged kernel's launch counts and the
    per-layer packed kernel-vs-plain max abs error."""
    import numpy as np
    import torch
    from repro_torch.configs import TreeConfig
    from repro_torch.core.errors import PrefillInFlight
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.runtime.serve import TreeServeEngine

    tag = "serve packed" + (" int8" if quant else "")
    kname, pname = _packed_kname(quant), _paged_kname(quant)
    base = dict(n_nodes=TREE_NODES, depth=TREE_DEPTH, slots=BATCH,
                node_capacity=TREE_CAP, decode_capacity=TREE_DEC_CAP,
                use_kernel=True, cache_dtype="int8" if quant else "bfloat16",
                ctx_store="paged", page_size=PAGE, suffix_prefill=True)
    rng = np.random.RandomState(2)       # phase 3d's prompts
    toks = {name: torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                                  device=DEVICE)
            for name, m in TREE_TOKENS.items()}
    per_req = BATCH // len(PACKED_REQUESTS)
    pages = {n: -(-m // PAGE) for n, m in TREE_TOKENS.items()}
    envelope = TREE_NODES * (TREE_CAP // PAGE)

    def init_state(eng, mdl, fp32):
        st = eng.init_state(device=DEVICE)
        if fp32:        # fp32 nodes and decode arms in place of bf16 ones
            st = dataclasses.replace(st, cache=mdl.make_paged_cache(
                BATCH, TREE_NODES, TREE_DEPTH, TREE_CAP, page_m=PAGE,
                dec_capacity=TREE_DEC_CAP,
                ctx_quant="int8" if quant else "none", dtype=torch.float32,
                device=DEVICE))
        return st

    def sync_run(mdl, prm, fp32=False):
        """The synchronous admissions of the same paths: each request's
        first-token logits and wall time."""
        sync = TreeServeEngine(mdl, cfg, TreeConfig(**base))
        first = _spy_first_logits(sync, "_sample_first")
        st_s = init_state(sync, mdl, fp32)
        ms = []
        for req in PACKED_REQUESTS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st_s, _ = sync.admit(prm, st_s, [toks[n] for n in req], per_req)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return first, ms

    sync_first, sync_ms = sync_run(model, params)

    def chunks(*names):
        return sum(-(-TREE_TOKENS[n] // PACKED_CHUNK) for n in names)

    n1, n2 = chunks("SYS", "TPL_A", "A1"), chunks("A2")
    n3, n4 = chunks("TPL_B", "B1"), chunks("B2")
    check(chunks("B1") >= 2 and n2 == n4 == 1, "phase 3f's workload")

    def run(counted, mdl=model, prm=params, fp32=False):
        eng = TreeServeEngine(mdl, cfg, TreeConfig(
            **base, step_mode="packed", prefill_chunk=PACKED_CHUNK))
        first = _spy_first_logits(eng, "_activate_pending")
        st = init_state(eng, mdl, fp32)
        rec = {"packed_ms": [], "decode_ms": [], "ttft_ms": {}, "err": 0.0,
               "free": []}
        admitted = {}

        def admit(st, req):
            torch.cuda.synchronize()
            admitted[eng.next_rid] = time.perf_counter()
            st, slots = eng.admit(prm, st, [toks[n] for n in req], per_req)
            rec["free"].append(eng.page_alloc.free_count())
            return st, slots

        def steps(st, n):
            for _ in range(n):
                packed = bool(eng._pending)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = eng.step_chunk(prm, st, 1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rec["packed_ms" if packed else "decode_ms"].append(
                    (t1 - t0) * 1e3)
                for rid, t_adm in admitted.items():
                    if rid not in eng._pending and rid not in rec["ttft_ms"]:
                        rec["ttft_ms"][rid] = (t1 - t_adm) * 1e3
                for pend in eng._pending.values():
                    check(all(eng.outputs[s] == [] for s in pend["slots"]),
                          f"{tag}: a slot emitted before its request "
                          f"activated")
            return st

        if counted:
            reset_launches()
        st, s1 = admit(st, PACKED_REQUESTS[0])
        st = steps(st, n1)                  # SYS 8 + TPL_A 4 + A1 3 chunks
        check(not eng._pending, f"{tag}: R1 still pending after {n1} steps")
        st, s2 = admit(st, PACKED_REQUESTS[1])
        st, s3 = admit(st, PACKED_REQUESTS[2])
        # R4's first new level, TPL_B, is R3's pending node
        before = (eng.page_alloc.free_count(), eng.free_nodes(),
                  set(eng.node_pending), set(eng._pending),
                  dict(eng.node_index), eng.next_rid)
        try:
            eng.admit(prm, st, [toks[n] for n in PACKED_REQUESTS[3]],
                      per_req)
        except PrefillInFlight:
            pass
        else:
            raise AssertionError(f"{tag}: R4 did not raise PrefillInFlight")
        check(before == (eng.page_alloc.free_count(), eng.free_nodes(),
                         set(eng.node_pending), set(eng._pending),
                         dict(eng.node_index), eng.next_rid),
              f"{tag}: the rejected admission changed the engine")
        # R2's chunk, TPL_B's and B1's first: B1's second is compared
        st = steps(st, n2 + chunks("TPL_B") + 1)
        if counted:
            saved = read_launches()
            t_check = time.perf_counter()
            rec["err"] = packed_vs_plain(cfg, model, params, eng, st, tag)
            if not quant:
                # where a bf16 packed step's time goes, #10 at its default
                # split and at splits=1
                profile_splits(
                    tag, "packed",
                    lambda _: packed_step_fn(model, params, eng, st),
                    cfg.n_layers, ptag=" packed")
            for k in bd.KERNELS:
                k.launches = saved[k.__name__]
            # the pending requests' time to first token leaves the check out
            for rid in eng._pending:
                admitted[rid] += time.perf_counter() - t_check
        st = steps(st, chunks("B1") - 1)    # R3 activates at the last
        check(not eng._pending, f"{tag}: R3 still pending")
        st, s4 = admit(st, PACKED_REQUESTS[3])
        st = steps(st, 1 + PACKED_DECODE)
        rec["counts"] = read_launches()
        want_free, seen = [], set()
        for req in PACKED_REQUESTS:
            new = [n for n in req if n not in seen]
            seen.update(new)
            want_free.append((want_free[-1] if want_free else envelope)
                             - sum(pages[n] for n in new))
        check(rec["free"] == want_free,
              f"{tag}: free pages after the admits {rec['free']}, want "
              f"{want_free} (reused ancestors cost none)")
        # the first token, then one per step after it
        after = n4 + PACKED_DECODE
        lens = [1 + n2 + n3 + after, 1 + n3 + after, 1 + after,
                1 + PACKED_DECODE]
        for slots, n in zip((s1, s2, s3, s4), lens):
            for s in slots:
                out = eng.outputs[s]
                check(len(out) == n, f"{tag}: slot {s}: {len(out)} tokens, "
                                     f"want {n}")
                check(all(0 <= t < cfg.vocab_size for t in out),
                      "token range")
                check(all(np.isfinite(eng.logps[s])), "logprobs")
        rec["first"] = first
        return eng, st, rec

    eng, st, rec = run(True)
    n_packed, n_dec = len(rec["packed_ms"]), len(rec["decode_ms"])
    counts = rec["counts"]
    print(f"{tag}: {n_packed} packed steps, {n_dec} decode-only steps; "
          f"launches {counts}")
    check(n_packed == n1 + n2 + n3 + n4 and n_dec == PACKED_DECODE,
          "step counts")
    check({k: v for k, v in counts.items() if v}
          == {kname: cfg.n_layers * n_packed, pname: cfg.n_layers * n_dec},
          f"{tag}: launches {counts}")
    with plain_versions():
        eng_p, st_p, rec_p = run(False)
    node_worst = packed_node_kv(cfg, model, params,
                                [(eng, st), (eng_p, st_p)], toks, tag)
    del eng, st, eng_p, st_p
    names = ["+".join(str(TREE_TOKENS[n]) for n in r) for r in PACKED_REQUESTS]
    rel = []
    for r, (lk, lp, ls) in enumerate(zip(rec["first"], rec_p["first"],
                                         sync_first)):
        live = ls.abs() < 1e29
        err_k, top = gap(lk[live], ls[live])
        err_p, _ = gap(lp[live], ls[live])
        check(bool(torch.isfinite(lk[live]).all()), "first-token logits")
        check(err_k <= max(TOL * top, 1.5 * err_p),
              f"{tag}: request {r}'s first-token logits are {err_k:.3e} from "
              f"a synchronous admission's (max |logit| {top:.3f}, plain "
              f"versions {err_p:.3e})")
        rel.append(f"R{r + 1} {err_k / top:.2e} (plain {err_p / top:.2e})")
    ttft = [rec["ttft_ms"][r] for r in range(len(PACKED_REQUESTS))]
    print(f"{tag}: first-token logits of each request (its last chunk's "
          f"last row) against a synchronous step_mode=\"decode\" admission of "
          f"the same path, share of max |logit|: {', '.join(rel)} (gate "
          f"max(2e-2 x max |logit|, 1.5 x plain)); free pages "
          f"{envelope} -> {' -> '.join(map(str, rec['free']))} (reused "
          f"ancestors cost none); R4 raised PrefillInFlight while TPL_B was "
          f"pending and changed nothing")
    if not quant:
        packed_fp32_witness(cfg, model, params, sync_run, run, rec["first"],
                            sync_first, tag)
    print(f"{tag}: packed step {np.mean(rec['packed_ms']):.2f} ms (min "
          f"{min(rec['packed_ms']):.2f}, max {max(rec['packed_ms']):.2f}) vs "
          f"decode-only step {np.mean(rec['decode_ms']):.2f} ms on "
          f"{CARD[0]}; admission to first token: "
          + ", ".join(f"R{r + 1} ({names[r]}) {t:.1f} ms"
                      for r, t in enumerate(ttft))
          + "; synchronous admissions of the same paths (suffix prefill): "
          + ", ".join(f"{t:.1f}" for t in sync_ms) + " ms (PR 15's four "
          "whole-path trie admissions: 1.70-1.78 s)")
    return counts[kname], counts[pname], max(rec["err"], 0.0), node_worst


PACKED_FP32_TOL = 1e-3          # fp32 packed vs synchronous first tokens


def packed_fp32_witness(cfg, model, params, sync_run, run, first_bf16,
                        sync_bf16, tag):
    """Phase 3f's bf16 first-token logits sit a few per cent of max
    |logit| from the synchronous admission's. This tells precision from
    a fault of the chunk path (rope positions, fresh_start, the envelope
    rows): the same weights, the same requests and the same steps in
    fp32 (fp32 forward, nodes and decode arms; the packed kernels' plain
    versions, since the kernels take bf16 only, and no TF32), where each
    request's packed first-token logits must agree with its synchronous
    admission's within PACKED_FP32_TOL x max |logit|. Prints, beside it,
    each bf16 run's distance from the fp32 synchronous logits."""
    import torch
    from repro_torch.convert import cast_weights

    model32 = type(model)(cfg)
    model32._embed = lambda p, t: p["embed"][t]     # the forward in fp32
    params32 = cast_weights(params, torch.float32)
    t0 = time.perf_counter()
    with plain_versions():
        sync32, _ = sync_run(model32, params32, fp32=True)
        _, _, rec32 = run(False, model32, params32, fp32=True)
    del params32
    rows = []
    for r, (lp32, ls32, lk, ls) in enumerate(zip(rec32["first"], sync32,
                                                 first_bf16, sync_bf16)):
        live = ls32.abs() < 1e29
        err32, top32 = gap(lp32[live], ls32[live])
        check(err32 <= PACKED_FP32_TOL * top32,
              f"{tag} fp32: request {r}'s packed first-token logits are "
              f"{err32:.3e} from a synchronous admission's (max |logit| "
              f"{top32:.3f}): a fault of the chunk path, not precision")
        err_k, _ = gap(lk[live], ls32[live])
        err_s, _ = gap(ls[live], ls32[live])
        rows.append(f"R{r + 1} {err32 / top32:.2e} (bf16 packed kernel "
                    f"{err_k / top32:.2e}, bf16 synchronous "
                    f"{err_s / top32:.2e})")
    print(f"{tag} fp32 witness ({time.perf_counter() - t0:.1f} s): packed "
          f"vs synchronous first-token logits in fp32, share of max "
          f"|logit|: {', '.join(rows)}: the bf16 runs' distances are from "
          f"the fp32 synchronous logits (gate {PACKED_FP32_TOL:g} on the "
          f"fp32 pair)")


def _copy_outputs(eng):
    """The engine's per-slot token lists, copied."""
    return {s: list(v) for s, v in eng.outputs.items()}


def profile_step(step, top=8, tag=""):
    """Where one step's device time goes: torch.profiler over ``step()``
    (one decode or packed step), device time by kernel name, beside the
    step's wall time, and the decode kernels' own device time and share
    (split_kernel + merge_kernel, or the single walk's decode_kernel: #1 /
    #3 on the single-prefix paths, #4 / #5 on the forests, #6 on the trie,
    #10 on a packed step). Returns that time in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key,
             str(getattr(e, "device_type", "")).endswith("CUDA"))
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    kern = [r for r in rows if r[3]]
    dec = {k: sum(r[0] for r in kern if f"{k}_kernel" in r[2])
           for k in ("split", "merge", "decode")}
    dec_us = sum(dec.values())
    dev_us = sum(r[0] for r in kern)
    print(f"profile{tag}: one step, wall {wall_us:.0f} us under the "
          f"profiler, device busy {busy:.0f} us ({len(rows)} kernel names; "
          f"the device-side rows alone {dev_us:.0f} us in "
          f"{sum(r[1] for r in kern)} launches); the decode kernels "
          f"{dec_us:.0f} us, {dec_us / max(dev_us, 1e-9):.1%} of the "
          f"device-side time (split_kernel {dec['split']:.0f}, merge_kernel "
          f"{dec['merge']:.0f}, the single walk's decode_kernel "
          f"{dec['decode']:.0f})")
    for us, n, key, _ in rows[:top]:
        print(f"profile:   {us:9.1f} us  {n:4d}x  {key[:90]}")
    return dec_us


def profile_kernel(tag, fn, key, what, top=6):
    """torch.profiler over ``fn()`` (one prefill, say): the device-side
    time and launches, those of the kernels whose name holds ``key``
    (``what``) and their share, beside the wall time; the ``top`` kernel
    names. Returns the kernels' time in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  reverse=True)
    dev_us = sum(r[0] for r in rows)
    mine = [r for r in rows if key in r[2]]
    k_us = sum(r[0] for r in mine)
    print(f"{tag}: profile, wall {wall_ms:.1f} ms under the profiler, "
          f"device {dev_us / 1e3:.2f} ms in {sum(r[1] for r in rows)} "
          f"launches; {what} {k_us / 1e3:.2f} ms in {sum(r[1] for r in mine)}"
          f" launches ({k_us / max(dev_us, 1e-9):.1%} of the device time)")
    for us, n, name in rows[:top]:
        print(f"profile:   {us:9.1f} us  {n:4d}x  {name[:90]}")
    return k_us / 1e3


def profile_splits(tag, kernel, make_step, calls, top=8, ptag=""):
    """``profile_step`` over the step ``make_step(i)`` returns, at the
    default split (i 0) and at splits=1 (i 1, under ``single_walk``); one
    line of the decode kernel's device time per step at both."""
    split_us = profile_step(make_step(0), top=top, tag=ptag)
    with single_walk():
        single_us = profile_step(make_step(1), top=0,
                                 tag=f"{ptag} (splits=1)")
    print(f"{tag}: the {kernel} kernel's device time per step, "
          f"{split_us / 1e3:.3f} ms at the default split against "
          f"{single_us / 1e3:.3f} ms at splits=1 ({calls} calls)")


def decode_fn(model, params, cache, tok):
    """One decode step of ``model`` on ``cache`` as a callable, for
    ``profile_step``."""
    return lambda: model.decode_step(params, cache, tok, impl="kernel")


def host_us_per_call(tag, kern, ctx, p, c_d, seed, n=200):
    """``host_us`` of #1 / #3 / #4 / #5 (``kern``) on one served layer's
    context operands ``ctx`` (#4 / #5: segments, scales, row map and
    lengths) with a random decode arm."""
    import torch

    g, hd = ctx[0].shape[-3], ctx[0].shape[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(g, BATCH * p, hd, generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    kd, vd, bias, _ = _decode_arm_operands(1, g, BATCH, c_d, hd, seed)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=p)
    host_us(tag, kern.__name__, lambda splits: kern(
        q, *ctx, kd[0], vd[0], bias, **kw, splits=splits),
        default_splits(q), n)


def host_us(tag, name, call, default, n=200):
    """The host's us per call of a split kernel's wrapper, ``call(S)``
    ``n`` times back to back on the host clock without a synchronise (the
    wrapper's Python, its checks, its scratch and the launch; the device
    is not waited for), at the ``default`` split and at splits=1, in turns;
    prints the best of each."""
    import torch

    counts = read_launches()

    def run(splits):
        call(splits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call(splits)
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    times = {default: [], 1: []}
    for splits in (default, 1, 1, default):
        times[splits].append(run(splits))
    from repro_torch.kernels import KERNELS

    for k in KERNELS:       # these calls are not a path's: counts restored
        k.launches = counts[k.__name__]
    print(f"{tag}: {name} wrapper's host work {min(times[default]):.1f}"
          f" us/call at the default split (S={default}), "
          f"{min(times[1]):.1f} us/call at splits=1 ({n} calls back to back, "
          f"host clock, no synchronise; best of two, in turns)")


def decode_ms_in_turns(tag, engine, params, ctx, prefill_s):
    """The decode ms/step of ``engine``'s generate with #1 / #3 at splits=1
    (the single walk) and at the default split, in turns after the counted
    run (single, default, single, default), each less ``prefill_s``."""
    import torch

    times = {"splits=1": [], "default split": []}
    for name in ("splits=1", "default split") * 2:
        with single_walk() if name == "splits=1" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(params, ctx, n_steps=STEPS)
            torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0 - prefill_s)
                           / (STEPS - 1) * 1e3)
    print(f"{tag}: decode ms/step in turns, "
          + "; ".join(f"{k} " + ", ".join(f"{t:.2f}" for t in v)
                      for k, v in times.items()))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 3g: flash prefill on the serving path
# ---------------------------------------------------------------------------

def gate_logits(tag, what, got, want, plain):
    """The whole-step gate: ``got`` within max(2e-2 x max |want|, 1.5 x the
    distance of ``plain``, the same path on the plain versions) of
    ``want``, over the live (unpadded) vocabulary; returns the relative
    error."""
    import torch

    live = want.abs() < 1e29
    for other in (got, plain):
        check(bool((other.abs() < 1e29).eq(live).all()), "padded vocab logits")
    check(bool(torch.isfinite(got.float()[live]).all()), "non-finite logits")
    err, scale = gap(got[live], want[live])
    err_p, _ = gap(plain[live], want[live])
    print(f"{tag}: {what}: max_abs_err {err:.3e} ({err / scale:.2e} of max "
          f"|logit| {scale:.3f}), plain versions {err_p:.3e} (gate max(2e-2 "
          f"x max |logit|, 1.5 x plain))")
    check(err <= max(TOL * scale, 1.5 * err_p), f"{tag}: {what} disagree")
    return err / scale


def serve_flash(cfg, params, ctx):
    """Phase 3g: ServeEngine.generate with train_attn="flash" at phase 3's
    workload: #12 launches once per layer per prefill and the decode kernel
    as in phase 3; prefill and first-step logits against the chunked path
    within the whole-step gate; prefill ms, flash beside chunked. Returns
    #12's launch count of one prefill."""
    import torch
    from repro_torch.configs import ServeConfig
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    tag = "serve flash"
    cfg_f = dataclasses.replace(cfg, train_attn="flash")
    scfg = ServeConfig(batch=BATCH, context_len=CONTEXT,
                       decode_capacity=max(16, STEPS + 8), bifurcated=True,
                       use_kernel=True)
    eng_f = ServeEngine(get_model(cfg_f), cfg_f, scfg)
    eng_c = ServeEngine(get_model(cfg), cfg, scfg)
    eng_f.generate(params, ctx, n_steps=2)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = eng_f.generate(params, ctx, n_steps=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"{tag}: generate (batch {BATCH}, context {CONTEXT}, {STEPS} "
          f"steps) {wall * 1e3:.1f} ms; launches {counts}")
    expect_counts(counts, {"flash_prefill_attention": cfg.n_layers,
                           "fused_bifurcated_decode":
                               cfg.n_layers * (STEPS - 1)})
    toks = result.tokens
    check(tuple(toks.shape) == (BATCH, STEPS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and bool(torch.isfinite(result.logprobs).all()),
          f"{tag}: tokens or log-probs out of range")

    # prefill ms, in turns: chunked, flash, flash, chunked
    times = {"chunked": [], "flash": []}
    out = {}
    for name in ("chunked", "flash", "flash", "chunked"):
        eng = eng_f if name == "flash" else eng_c
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = eng.prefill_shared(params, ctx, BATCH)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    print(f"{tag}: prefill of {CONTEXT} tokens, flash "
          + " / ".join(f"{t:.1f}" for t in times["flash"]) + " ms, chunked "
          + " / ".join(f"{t:.1f}" for t in times["chunked"])
          + f" ms (in turns, on {CARD[0]})")
    with plain_versions():
        out["plain"] = eng_f.prefill_shared(params, ctx, BATCH)
    gate_logits(tag, "prefill logits, flash vs chunked", out["flash"][0],
                out["chunked"][0], out["plain"][0])
    tok = toks[:, :1]
    model = eng_c.model
    steps = {}
    for name, (_, cache) in out.items():
        if name == "plain":
            with plain_versions():
                steps[name] = model.decode_step(params, cache, tok,
                                                impl="kernel")[0]
        else:
            steps[name] = model.decode_step(params, cache, tok,
                                            impl="kernel")[0]
    torch.cuda.synchronize()
    gate_logits(tag, "first decode-step logits, flash vs chunked prefill",
                steps["flash"], steps["chunked"], steps["plain"])
    return counts["flash_prefill_attention"]


# ---------------------------------------------------------------------------
# phase 3h: the trie's prefix cache, revivals through #12
# ---------------------------------------------------------------------------

# phase 3h's trie: 5 nodes, so that [SYS, TPL_B, B1] meets node pressure;
# on pages of 128, a 75-page pool, so that [SYS, TPL_A, A3] meets page
# pressure too
CACHE_NODES, CACHE_PAGES = 5, 75
CACHE_REQUESTS = (("SYS", "TPL_A", "A1"), ("SYS", "TPL_A", "A2"),
                  ("SYS", "TPL_B", "B1"), ("SYS", "TPL_A", "A3"))


def serve_prefix_cache(cfg, params, store, quant):
    """Phase 3h: TreeServeEngine(prefix_cache=True, suffix_prefill=True)
    with train_attn="flash" on phase 3d's prompts, beside an evict-eagerly
    engine (chunked prefill) on the same admissions. R1 = [SYS, TPL_A, A1]
    (8 samples), 2 steps, retired: its 3 nodes cached, their pages held.
    R2 = [SYS, TPL_A, A2] revives two levels: #12 launches once per layer
    at q_offset 6144 over the cached keys, 6144 tokens reused, the revived
    K/V bit-equal to what they held; first-token logits against the eager
    engine's cold admission within the whole-step gate. Retired, then R3 =
    [SYS, TPL_B, B1] must evict A1's node (the oldest childless entry),
    and R4 = [SYS, TPL_A, A3] A2's node (node pressure) and, paged, B1's
    (page pressure); an admission of three fresh levels, which no eviction
    can serve, must raise and change nothing."""
    import numpy as np
    import torch
    from repro_torch.configs import TreeConfig
    from repro_torch.core.errors import SegmentsExhausted
    from repro_torch.models import blocks, get_model
    from repro_torch.runtime.serve import TreeServeEngine

    paged = store == "paged"
    tag = f"serve prefix cache {store}{' int8' if quant else ''}"
    cfg_f = dataclasses.replace(cfg, train_attn="flash")
    kw = dict(n_nodes=CACHE_NODES, depth=TREE_DEPTH, slots=BATCH,
              node_capacity=TREE_CAP, decode_capacity=TREE_DEC_CAP,
              use_kernel=True, cache_dtype="int8" if quant else "bfloat16",
              ctx_store=store)
    if paged:
        kw.update(page_size=PAGE, num_pages=CACHE_PAGES)
    model_f = get_model(cfg_f)
    eng = TreeServeEngine(model_f, cfg_f, TreeConfig(
        prefix_cache=True, suffix_prefill=True, **kw))
    base = TreeServeEngine(get_model(cfg), cfg, TreeConfig(**kw))
    rng = np.random.RandomState(2)       # phase 3d's prompts
    toks = {name: torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, m)),
                                  device=DEVICE)
            for name, m in TREE_TOKENS.items()}
    per_req = BATCH // len(TREE_REQUESTS)
    firsts = {e: _spy_first_logits(e, "_sample_first") for e in (eng, base)}
    st = eng.init_state(device=DEVICE)
    sb = base.init_state(device=DEVICE)
    calls = []
    flash = blocks.flash_prefill_attention

    def spy(q, k, v, **fkw):
        calls.append((q.shape[1], k.shape[1], fkw.get("q_offset", 0)))
        return flash(q, k, v, **fkw)

    def admit(e, state, req):
        """Admit ``req``; returns the state, its slots, the ms it took and
        the launch counts of the admission."""
        calls.clear()
        reset_launches()
        blocks.flash_prefill_attention = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, slots = e.admit(params, state, [toks[n] for n in req],
                                   per_req)
            torch.cuda.synchronize()
        finally:
            blocks.flash_prefill_attention = flash
        return state, slots, (time.perf_counter() - t0) * 1e3, read_launches()

    def retire(e, state, slots):
        state = e.deactivate_slots(state, slots)
        e.retire_requests(state)
        return state

    def key(name_path):
        """The trie-index key of the last level of ``name_path``."""
        parent = -1
        for name in name_path[:-1]:
            parent = eng.node_index[(parent, tuple(toks[name][0].tolist()))]
        return parent, tuple(toks[name_path[-1]][0].tolist())

    def node(name_path):
        return eng.node_index[key(name_path)]

    n_layers = cfg.n_layers
    # R1, cold on both
    st, s1, ms_r1, counts = admit(eng, st, CACHE_REQUESTS[0])
    expect_launches(counts, "flash_prefill_attention", n_layers)
    r1_len = sum(TREE_TOKENS[n] for n in CACHE_REQUESTS[0])
    check(calls == [(r1_len, r1_len, 0)] * n_layers, f"R1's prefill {calls}")
    sb, b1, ms_b1, _ = admit(base, sb, CACHE_REQUESTS[0])
    st = eng.step_chunk(params, st, 2)
    sb = base.step_chunk(params, sb, 2)
    anc = [node(CACHE_REQUESTS[0][:i + 1]) for i in range(2)]
    snap = [eng._node_kv(st.cache, n, eng.node_len[n]) for n in anc]
    snap = [(k.clone(), v.clone()) for k, v in snap]
    free0 = eng.page_alloc.free_count() if paged else None
    st = retire(eng, st, s1)
    sb = retire(base, sb, b1)
    occ = eng.occupancy(st)
    pages = {n: -(-TREE_TOKENS[n] // PAGE) for n in TREE_TOKENS}
    check(occ["nodes_cached"] == 3 and eng.cached_nodes() == sorted(
        node(CACHE_REQUESTS[0][:i + 1]) for i in range(3)),
          f"{tag}: after R1's retirement {occ}")
    if paged:
        check(eng.page_alloc.free_count() == free0 and occ["pages_cached"]
              == sum(pages[n] for n in CACHE_REQUESTS[0]),
              f"{tag}: the cached nodes' pages {occ}")

    # R2: the revival, a suffix prefill at q_offset 6144
    stats = dict(eng.prefix_stats)
    st, s2, ms_r2, counts = admit(eng, st, CACHE_REQUESTS[1])
    cut = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    a2 = TREE_TOKENS["A2"]
    expect_launches(counts, "flash_prefill_attention", n_layers)
    check(calls == [(a2, cut + a2, cut)] * n_layers,
          f"{tag}: R2's suffix prefill calls {calls[:2]}...")
    ps = eng.prefix_stats
    check(ps["reused_tokens"] - stats["reused_tokens"] == cut
          and ps["partial_hits"] == stats["partial_hits"] + 1
          and ps["computed_tokens"] - stats["computed_tokens"] == a2,
          f"{tag}: prefix_stats {ps}")
    same = all(torch.equal(k, k2) and torch.equal(v, v2)
               for (k, v), (k2, v2) in zip(snap, (eng._node_kv(
                   st.cache, n, eng.node_len[n]) for n in anc)))
    check(same, f"{tag}: the revived nodes' K/V moved")
    del snap
    sb, b2, ms_b2, _ = admit(base, sb, CACHE_REQUESTS[1])
    with plain_versions():
        k_anc, v_anc = eng._gather_path_kv(st, anc, cut)
        plain, _ = model_f.prefill_suffix(params, toks["A2"], k_anc, v_anc,
                                          start=cut)
    del k_anc, v_anc
    rel = gate_logits(tag, "R2's first-token logits, revived (flash suffix "
                      "prefill) vs the eager engine's cold admission",
                      firsts[eng][-1], firsts[base][-1], plain[0].float())
    agree = eng.outputs[s2[0]][0] == base.outputs[b2[0]][0]
    print(f"{tag}: R1 cold {ms_r1:.1f} ms (flash; eager chunked "
          f"{ms_b1:.1f} ms); R2 revived {ms_r2:.1f} ms against the eager "
          f"engine's cold {ms_b2:.1f} ms, on {CARD[0]}; {cut} tokens reused, "
          f"K/V bit-equal {same}, first token equal to the eager engine's "
          f"{agree}")

    # node and page pressure
    st = retire(eng, st, s2)
    leaves = {r[-1]: key(r) for r in CACHE_REQUESTS[:2]}
    ev = eng.prefix_stats["evictions"]
    st, s3, ms_r3, _ = admit(eng, st, CACHE_REQUESTS[2])
    leaves["B1"] = key(CACHE_REQUESTS[2])

    def evicted():
        return [n for n, k in leaves.items() if k not in eng.node_index]

    check(evicted() == ["A1"] and eng.prefix_stats["evictions"] == ev + 1,
          f"{tag}: R3 evicted {evicted()}, want A1's node alone")
    st = retire(eng, st, s3)
    st, s4, ms_r4, _ = admit(eng, st, CACHE_REQUESTS[3])
    want = ["A1", "A2", "B1"] if paged else ["A1", "A2"]
    check(evicted() == want
          and eng.prefix_stats["evictions"] == ev + len(want),
          f"{tag}: after R4 {evicted()} evicted, want {want}")
    print(f"{tag}: R3 [SYS, TPL_B, B1] evicted A1's node ({ms_r3:.1f} ms), "
          f"R4 [SYS, TPL_A, A3] evicted {'A2 (nodes), B1 (pages)' if paged else 'A2'}"
          f" ({ms_r4:.1f} ms); occupancy {eng.occupancy(st)}")

    # a demand no eviction can meet: three fresh levels
    fresh = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, 16)),
                             device=DEVICE) for _ in range(3)]

    def host():
        return (dict(eng.node_cached), dict(eng.prefix_stats),
                list(eng.node_live), eng.free_nodes(),
                eng.page_alloc.free_pages() if paged else None)

    before = host()
    try:
        eng.admit(params, st, fresh, 1)
    except SegmentsExhausted:
        pass
    else:
        raise AssertionError(f"{tag}: an unsatisfiable demand was admitted")
    check(host() == before, f"{tag}: the refused admission changed the "
                            f"engine")
    print(f"{tag}: an admission of 3 fresh levels raised SegmentsExhausted "
          f"and changed nothing")
    for s in s4:
        check(len(eng.outputs[s]) == 1
              and 0 <= eng.outputs[s][0] < cfg.vocab_size, "R4's tokens")
    return rel


# ---------------------------------------------------------------------------
# phase 3j: the serving layer (frontend, faults, journal, snapshots, recovery)
# ---------------------------------------------------------------------------

# the trie drill: 8 requests of 4 samples, each [SYS, one of two templates,
# its own suffix]; 12 nodes, a pool of 64 pages of 128 (56 in use), so that
# a snapshot (pools, decode arms, tables) stays under ~1 GB
SERVE_TOKENS = {"SYS": 4096, "TPL": 512, "SFX": 256}
SERVE_REQUESTS, SERVE_SAMPLES, SERVE_NEW = 8, 4, 16
SERVE_NODES, SERVE_PAGES, SERVE_CHUNK = 12, 64, 512
SERVE_KILLS = (5, 9)                 # rounds of the two KILL_PROCESS events
SERVE_SNAPSHOT_EVERY = 3
# the mixed plan, (round, kind, arg, hold): pages stolen and a request
# cancelled after the round-3 snapshot; the round-6 snapshot corrupted at
# round 7, round 7's journal record torn at round 8 and the process killed
# in that round, so that recovery falls back to round 3's snapshot and its
# replay stops at the tear
SERVE_MIXED = ((4, "pool_exhaust", 4, 2), (5, "cancel_mid_decode", 1, 1),
               (7, "snapshot_corrupt", 3, 1), (8, "journal_truncate", 40, 1),
               (8, "kill_process", 1, 1))
# the forest drill: 4 requests of 8 samples on 4 dense bf16 segments
SERVE_FOREST_LENS, SERVE_FOREST_CAP = (2048, 1536, 1024, 640), 2048
SERVE_FOREST_KILLS = (3, 5)          # with 2 decode steps a round


def _timed(fn, *a, **kw):
    """(fn's result, its ms on the card's clock, synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class DrillClock:
    """The engines of one drill (the factory's, the recovered ones too).
    Each is a subclass of its engine class whose public ``admit`` and
    ``step_chunk`` are timed; the steps of each kind come from the engines'
    own ``steps_run``, and the node checksums are timed again by
    ``time_checksums`` through the public ``segment_checksum``."""

    def __init__(self):
        self.engines = []
        self.admit_ms = 0.0
        self.quiet_ms, self.quiet_steps = 0.0, 0   # decode-only calls
        self.busy_ms, self.busy_decode = 0.0, 0    # calls with packed steps
        self.ck_ms = {}                            # (node, crc) -> ms

    def steps(self, kind):
        return sum(e.steps_run[kind] for e in self.engines)

    def build(self, cls, *args):
        clock = self

        class Timed(cls):
            def admit(self, *a, **kw):
                out, ms = _timed(super().admit, *a, **kw)
                clock.admit_ms += ms
                return out

            def step_chunk(self, params, state, n_steps, *a, **kw):
                before = dict(self.steps_run)
                out, ms = _timed(super().step_chunk, params, state, n_steps,
                                 *a, **kw)
                if self.steps_run["packed"] == before["packed"]:
                    clock.quiet_ms += ms
                    clock.quiet_steps += n_steps
                else:
                    clock.busy_ms += ms
                    clock.busy_decode += (self.steps_run["decode"]
                                          - before["decode"])
                return out

        Timed.__name__ = Timed.__qualname__ = cls.__name__
        eng = Timed(*args)
        self.engines.append(eng)
        return eng

    def time_checksums(self, eng, state):
        """Time each node checksum recorded since the last call, once, on
        the bytes it was recorded over, and check it is still the same."""
        from repro_torch.core.integrity import segment_checksum

        for idx, crc in eng.seg_checksums.items():
            if (idx, crc) in self.ck_ms:
                continue
            got, ms = _timed(segment_checksum, state.cache, idx)
            check(got == crc, f"node {idx}'s checksum moved")
            self.ck_ms[(idx, crc)] = ms

    def decode_ms_per_step(self):
        return self.quiet_ms / max(1, self.quiet_steps)

    def admission_ms(self):
        """admit calls plus the step calls that ran packed steps, less
        those calls' decode-only steps at the quiet calls' ms/step."""
        return (self.admit_ms + self.busy_ms
                - self.busy_decode * self.decode_ms_per_step())


def _drill_results(fe):
    return {t.tid: (t.status, t.reason,
                    None if t.tokens is None
                    else [[int(x) for x in tok] for tok in t.tokens])
            for t in fe.tickets}


def _snapshot_probe(dfe):
    """Wrap the drill's checkpointer: (save ms, load ms, bytes written)."""
    import torch

    probe = {"save": [], "load": [], "bytes": []}
    ck = dfe.ckpt
    save, load = ck.save, ck.load

    def timed_save(round_, device_state, host):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(round_, device_state, host)
        probe["save"].append((time.perf_counter() - t0) * 1e3)
        probe["bytes"].append(sum(os.path.getsize(os.path.join(path, f))
                                  for f in os.listdir(path)))
        return path

    def timed_load(round_, template):
        t0 = time.perf_counter()
        out = load(round_, template)
        torch.cuda.synchronize()
        probe["load"].append((time.perf_counter() - t0) * 1e3)
        return out

    ck.save, ck.load = timed_save, timed_load
    return probe


def _drive_durable(dfe, params, recoveries):
    """Pump ``dfe`` to the end, recovering from each ``ProcessKilled``
    (nothing else is caught: any other exception fails the phase).
    Appends (recover ms, records replayed) per recovery, and checks the
    engine's checksums after each."""
    import torch
    from repro_torch.runtime.faults import ProcessKilled

    pumps = 0
    while dfe.pending():
        pumps += 1
        check(pumps < 200, "the durable drill did not converge")
        try:
            dfe.pump(params)
        except ProcessKilled:
            before = (dfe.stats["replayed_rounds"]
                      + dfe.stats["replayed_submits"])
            _, ms = _timed(dfe.recover, params)
            check(dfe.fe.engine.verify_checksums(dfe.state),
                  "checksums after a recovery")
            recoveries.append((ms, dfe.stats["replayed_rounds"]
                               + dfe.stats["replayed_submits"] - before))
    return dfe


def serve_durable(cfg, params):
    """Phase 3j: the serving layer over the paged trie (packed steps, the
    sharing policy, the prefix cache) and the dense forest at full width.
    Gates: kill-and-restore bit-identical to an uninterrupted control (bf16
    and int8 trie, bf16 forest); under a mixed plan (a stolen-page hold, a
    cancelled request, a corrupted snapshot, a truncated journal, a kill)
    every ticket no fault touched bit-identical to the control, an audit
    every round, the checksums after each recovery; a flipped bit of a live
    node's K raising KVCorruption; #8/#9 (#10/#11, #4) launched 24 times
    per decode-only (packed, forest) step run, replays included; no
    quarantine outside the flip. Prints admission, checksum, snapshot,
    load, recovery and decode times."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import ForestConfig, TreeConfig
    from repro_torch.core.errors import KVCorruption
    from repro_torch.models import get_model
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.runtime.frontend import ServeFrontend
    from repro_torch.runtime.recovery import DurableFrontend
    from repro_torch.runtime.serve import ForestServeEngine, TreeServeEngine

    model = get_model(cfg)
    n_layers = cfg.n_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3j_")
    rng = np.random.RandomState(31)
    V = cfg.vocab_size
    sys_ = rng.randint(0, V, (1, SERVE_TOKENS["SYS"]))
    tpls = [rng.randint(0, V, (1, SERVE_TOKENS["TPL"])) for _ in range(2)]
    trie_reqs = [[sys_, tpls[i % 2], rng.randint(0, V, (
        1, SERVE_TOKENS["SFX"]))] for i in range(SERVE_REQUESTS)]
    forest_reqs = [[rng.randint(0, V, (1, m))] for m in SERVE_FOREST_LENS]
    trie_kw = dict(decode_steps=4, queue_depth=32, max_attempts=64,
                   stall_rounds=16, policy="sharing")

    def submit_all(fe, reqs, n_samples):
        for r in reqs:
            fe.submit([torch.as_tensor(s, device=DEVICE) for s in r],
                      n_samples=n_samples, max_new_tokens=SERVE_NEW)

    def trie_factory(clock, quant):
        tcfg = TreeConfig(
            n_nodes=SERVE_NODES, depth=3, slots=BATCH,
            node_capacity=SERVE_TOKENS["SYS"], decode_capacity=SERVE_NEW,
            use_kernel=True, cache_dtype="int8" if quant else "bfloat16",
            ctx_store="paged", page_size=PAGE, num_pages=SERVE_PAGES,
            prefix_cache=True, suffix_prefill=True, step_mode="packed",
            prefill_chunk=SERVE_CHUNK, temperature=0.0)
        return lambda: clock.build(TreeServeEngine, model, cfg, tcfg)

    def forest_factory(clock):
        fcfg = ForestConfig(
            n_groups=len(SERVE_FOREST_LENS), slots=BATCH,
            ctx_capacity=SERVE_FOREST_CAP, decode_capacity=SERVE_NEW,
            use_kernel=True, cache_dtype="bfloat16", temperature=0.0)
        return lambda: clock.build(ForestServeEngine, model, cfg, fcfg)

    def expect_steps(clock, kernels):
        """Each kernel launched once a layer for every step of its kind
        (``steps_run``) the run's engines took (replays included), and no
        other kernel."""
        expect_counts(read_launches(), {name: n_layers * clock.steps(kind)
                                        for name, kind in kernels})

    def control(tag, factory, clock, reqs, n_samples, kernels, fe_kw):
        """An uninterrupted run, pumped round by round: each node checksum
        is timed again after the round that recorded it."""
        reset_launches()
        fe = ServeFrontend(factory(), device=DEVICE, **fe_kw)
        state = fe.init_state()
        submit_all(fe, reqs, n_samples)
        while any(not t.terminal for t in fe.tickets):
            check(fe.round < 200, f"{tag}: the control did not converge")
            state = fe.pump(params, state)
            clock.time_checksums(fe.engine, state)
        expect_steps(clock, kernels)
        if hasattr(fe.engine, "step_io_bytes"):
            # the trie's steps as the frontend's own ledger counts them
            check(fe.io_ledger["steps"] == clock.steps("decode")
                  + clock.steps("packed"),
                  f"{tag}: the frontend counted {fe.io_ledger['steps']} "
                  f"steps, the engine ran {clock.steps('decode')} + "
                  f"{clock.steps('packed')}")
        check(fe.counters.get("kv_quarantines", 0) == 0,
              f"{tag}: the control quarantined a request")
        res = _drill_results(fe)
        check(all(s == "completed" for s, _, _ in res.values()),
              f"{tag}: the control did not complete every request")
        for _, _, toks in res.values():
            check(all(len(t) == SERVE_NEW and all(0 <= x < V for x in t)
                      for t in toks), f"{tag}: control tokens")
        check(fe.counters["audits_passed"] == fe.round,
              f"{tag}: audits {fe.counters['audits_passed']} of "
              f"{fe.round} rounds")
        return fe, state, res

    def durable(tag, factory, clock, reqs, n_samples, plan, kernels, fe_kw):
        reset_launches()
        d = tempfile.mkdtemp(dir=tmp)
        dfe = DurableFrontend(factory, d, fault_plan=plan,
                              snapshot_every=SERVE_SNAPSHOT_EVERY,
                              keep_last_k=2, frontend_kwargs=fe_kw,
                              device=DEVICE)
        probe = _snapshot_probe(dfe)    # recover() keeps this checkpointer
        dfe.init_state()
        submit_all(dfe, reqs, n_samples)
        recoveries = []
        _drive_durable(dfe, params, recoveries)
        expect_steps(clock, kernels)
        check(dfe.fe.counters.get("kv_quarantines", 0) == 0,
              f"{tag}: a request was quarantined")
        check(dfe.fe.counters["audits_passed"] == dfe.fe.round,
              f"{tag}: audits {dfe.fe.counters['audits_passed']} of "
              f"{dfe.fe.round} rounds")
        shutil.rmtree(d, ignore_errors=True)
        return dfe, probe, recoveries

    def report(tag, clock, ctrl_clock, probe, recoveries, dfe):
        snap_b = max(probe["bytes"]) if probe["bytes"] else 0
        rec = ", ".join(f"{ms:.0f} ms ({n} records)" for ms, n in recoveries)
        print(f"{tag}: {len(recoveries)} recoveries [{rec}]; "
              f"{dfe.stats['snapshots']} snapshots of up to {snap_b} bytes, "
              f"save {np.median(probe['save']):.0f} ms median (fsync'd), "
              f"load {np.median(probe['load']) if probe['load'] else 0:.0f}"
              f" ms median; {dfe.stats['snapshot_fallbacks']} fallbacks, "
              f"{dfe.stats['deferred_snapshots']} deferred; steps run "
              f"{clock.steps('packed')} packed + {clock.steps('decode')} "
              f"decode-only against the control's "
              f"{ctrl_clock.steps('packed')} + {ctrl_clock.steps('decode')}, "
              f"on {CARD[0]}")

    def report_control(tag, c):
        work, ck = c.admission_ms(), sum(c.ck_ms.values())
        print(f"{tag}: control decode {c.decode_ms_per_step():.1f} ms/step "
              f"under the frontend ({c.quiet_steps} decode-only steps), "
              f"admission work {work:.0f} ms (admit calls {c.admit_ms:.0f} "
              f"ms + step calls with packed steps {c.busy_ms:.0f} ms less "
              f"their {c.busy_decode} decode-only steps), of it "
              f"{len(c.ck_ms)} node checksums {ck:.0f} ms "
              f"({100 * ck / max(1e-9, work):.1f}%; the largest node's "
              f"{max(c.ck_ms.values(), default=0):.0f} ms), on {CARD[0]}")

    try:
        for quant in (False, True):
            tag = f"serve durable tree{' int8' if quant else ''}"
            kernels = [(_paged_kname(quant), "decode"),
                       (_packed_kname(quant), "packed")]
            cclock = DrillClock()
            ctrl_fe, ctrl_state, ctrl = control(
                tag, trie_factory(cclock, quant), cclock, trie_reqs,
                SERVE_SAMPLES, kernels, trie_kw)
            if not quant:
                # gate 3: one flipped bit of a live (cached) node's K
                eng = ctrl_fe.engine
                nid = eng.node_index[(-1, tuple(int(x) for x in sys_[0]))]
                pid = eng.node_pages[nid][0]
                cell = ctrl_state.cache.store.k_pages[0, pid, 0, 0, :1]
                check(eng.audit_state(ctrl_state, verify_checksums=True),
                      f"{tag}: audit before the flip")
                cell.view(torch.int16).bitwise_xor_(1 << 3)
                try:
                    eng.audit_state(ctrl_state, verify_checksums=True)
                except KVCorruption as e:
                    print(f"{tag}: a flipped bit of node {nid}'s K (page "
                          f"{pid}) raised KVCorruption: {e}")
                else:
                    raise AssertionError(f"{tag}: a flipped KV bit passed "
                                         f"the checksum audit")
            del ctrl_fe, ctrl_state
            clock = DrillClock()
            plan = FaultPlan([FaultEvent(r, "kill_process")
                              for r in SERVE_KILLS])
            dfe, probe, recs = durable(tag, trie_factory(clock, quant), clock,
                                       trie_reqs, SERVE_SAMPLES, plan,
                                       kernels, trie_kw)
            check(len(recs) == len(SERVE_KILLS),
                  f"{tag}: {len(recs)} recoveries")
            got = _drill_results(dfe.fe)
            check(got == ctrl, f"{tag}: recovered tickets differ from the "
                               f"control: {sorted(k for k in got if got[k] != ctrl.get(k))}")
            print(f"{tag}: killed at rounds {SERVE_KILLS} and recovered; "
                  f"all {len(got)} tickets' statuses and greedy tokens "
                  f"bit-identical to the uninterrupted control")
            report(tag, clock, cclock, probe, recs, dfe)
            report_control(tag, cclock)
            del dfe
            if quant:
                continue
            # gate 2: the mixed plan (bf16)
            clock = DrillClock()
            plan = FaultPlan([FaultEvent(r, k, arg=a, hold=h)
                              for r, k, a, h in SERVE_MIXED], seed=3)
            dfe, probe, recs = durable(f"{tag} mixed", trie_factory(
                clock, quant), clock, trie_reqs, SERVE_SAMPLES, plan, kernels,
                trie_kw)
            got = _drill_results(dfe.fe)
            touched = sorted(t.tid for t in dfe.fe.tickets if t.fault_touched)
            for tid, want in ctrl.items():
                if tid in touched:
                    continue
                check(got.get(tid) == want,
                      f"{tag} mixed: untouched ticket {tid} differs")
            c = dfe.fe.counters
            check(len(recs) == 1 and dfe.stats["snapshot_fallbacks"] >= 1
                  and all(c.get(f"fault_{k}", 0) == 1
                          for _, k, _, _ in SERVE_MIXED
                          if k != "kill_process")
                  and c.get("pages_stolen", 0) > 0
                  and c.get("preemptions_fault", 0) == 1
                  and len(touched) == 1,
                  f"{tag} mixed: the faults did not all land: {c} "
                  f"{dfe.stats}")
            print(f"{tag} mixed: plan {[e[1] for e in SERVE_MIXED]}; "
                  f"touched tickets {touched}, the other "
                  f"{len(ctrl) - len(touched)} bit-identical to the control; "
                  f"{c['audits_passed']} audits in {dfe.fe.round} rounds; "
                  f"{dfe.stats['snapshot_fallbacks']} snapshot fallback(s)")
            report(f"{tag} mixed", clock, cclock, probe, recs, dfe)
            del dfe

        # the forest drill (dense bf16, #4)
        tag = "serve durable forest"
        kernels = [("grouped_fused_bifurcated_decode", "decode")]
        forest_kw = dict(trie_kw, decode_steps=2)
        cclock = DrillClock()
        _, _, ctrl = control(tag, forest_factory(cclock), cclock, forest_reqs,
                             BATCH // len(forest_reqs), kernels, forest_kw)
        clock = DrillClock()
        plan = FaultPlan([FaultEvent(r, "kill_process")
                          for r in SERVE_FOREST_KILLS])
        dfe, probe, recs = durable(tag, forest_factory(clock), clock,
                                   forest_reqs, BATCH // len(forest_reqs),
                                   plan, kernels, forest_kw)
        got = _drill_results(dfe.fe)
        check(len(recs) == len(SERVE_FOREST_KILLS),
              f"{tag}: {len(recs)} recoveries")
        check(got == ctrl, f"{tag}: recovered tickets differ from the "
                           f"control")
        print(f"{tag}: killed at rounds {SERVE_FOREST_KILLS} and recovered; "
              f"all {len(got)} tickets bit-identical to the control")
        report(tag, clock, cclock, probe, recs, dfe)
        report_control(tag, cclock)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3i: the zamba2 hybrid served
# ---------------------------------------------------------------------------

HYBRID_SAMPLE_LAYERS = (0, 40, 80)   # Mamba2 layers whose #13 call is checked


class record_chunked:
    """Keep the inputs and results of #13's calls at the layers ``layers``
    (in call order) of the model module ``module`` (mamba: the Mamba2
    layers; xlstm: the mLSTM layers) for the duration of a ``with`` block,
    and a pair of CUDA events around every call (``device_ms``: their
    sum)."""

    def __init__(self, layers, module="mamba"):
        import importlib

        self.mod = importlib.import_module(f"repro_torch.models.{module}")
        self.layers, self.calls, self.n, self.events = set(layers), [], 0, []

    def __enter__(self):
        import torch

        self.real = self.mod.chunked_linear_attention

        def rec(q, k, v, a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, S = self.real(q, k, v, a, **kw)
            ev[1].record()
            self.events.append(ev)
            if self.n in self.layers:
                self.calls.append((self.n, (q, k, v, a), kw, out, S))
            self.n += 1
            return out, S

        self.mod.chunked_linear_attention = rec
        return self

    def __exit__(self, *exc):
        self.mod.chunked_linear_attention = self.real

    def device_ms(self):
        return sum(a.elapsed_time(b) for a, b in self.events)


def serve_hybrid():
    """Phase 3i: ServeEngine.generate on zamba2-7b at its published width
    (seeded random weights made on the card), bifurcated cache, fused
    kernels, bf16 and int8 context. Returns ({kernel name: launches} of the
    bf16 run, #13's max abs error over the sampled layers, #13's recorded
    inputs of the bf16 prefill, the served bf16 and int8 attention caches)
    for phase 4."""
    import gc

    import torch
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.convert import cast_weights
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.kernels import chunked_linear as cl
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config("zamba2-7b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve hybrid: {cfg.name} {cfg.n_layers} Mamba2 layers (d "
          f"{cfg.d_model}, {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim}"
          f" SSD heads, state {cfg.ssm.state_dim}, chunk {cfg.ssm.chunk}), "
          f"shared block x {model.n_super} (h={cfg.n_heads} g="
          f"{cfg.n_kv_heads} hd={cfg.kq_dim} d_ff={cfg.d_ff}), vocab "
          f"{cfg.padded_vocab}: {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = torch.Generator(device=DEVICE).manual_seed(5)
    ctx = torch.randint(0, cfg.vocab_size, (1, CONTEXT), generator=rng,
                        device=DEVICE)
    want_13 = cfg.n_layers
    params32 = None
    out = {}
    for quant in (False, True):
        tag = "serve hybrid int8" if quant else "serve hybrid"
        kname = ("fused_bifurcated_decode_q8" if quant
                 else "fused_bifurcated_decode")
        scfg = ServeConfig(batch=BATCH, context_len=CONTEXT,
                           decode_capacity=max(16, STEPS + 8),
                           bifurcated=True, use_kernel=True,
                           cache_dtype="int8" if quant else "bfloat16")
        engine = ServeEngine(model, cfg, scfg)
        check(engine.should_bifurcate(BATCH, CONTEXT),
              "policy did not bifurcate")
        engine.generate(params, ctx, n_steps=2)          # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = engine.generate(params, ctx, n_steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        print(f"{tag}: generate launches {counts}")
        expect_counts(counts, {"chunked_linear_attention": want_13,
                               kname: model.n_super * (STEPS - 1)})
        if not quant:
            out["launches"] = {"chunked_linear_attention": want_13,
                               kname: counts[kname]}
        toks, lps = result.tokens, result.logprobs
        check(tuple(toks.shape) == (BATCH, STEPS), f"tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "token range")
        check(bool(torch.isfinite(lps).all() and (lps <= 0).all()),
              "logprobs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill_shared(params, ctx, BATCH)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        print(f"{tag}: generate {wall * 1e3:.1f} ms = prefill "
              f"{prefill_s * 1e3:.1f} ms + {STEPS - 1} decode steps at "
              f"{(wall - prefill_s) / (STEPS - 1) * 1e3:.2f} ms/step (batch "
              f"{BATCH}, context {CONTEXT})")
        decode_ms_in_turns(tag, engine, params, ctx, prefill_s)
        if not quant:   # where a prefill's device time goes: #13's share
            profile_kernel(f"{tag} prefill",
                           lambda: engine.prefill_shared(params, ctx, BATCH),
                           "chunked_linear_kernel", "#13")

        # the kernel path's prefill, #13's calls at the sampled layers kept,
        # and its first decode step on the first sampled tokens
        tok = toks[:, :1]
        with record_chunked(HYBRID_SAMPLE_LAYERS) as rec:
            lk_pre, cache = engine.prefill_shared(params, ctx, BATCH)
        check(rec.n == cfg.n_layers, f"#13 called {rec.n} times")
        attn = cache["attn"]
        lk_dec, _ = model.decode_step(params, cache, tok, impl="kernel")
        out["attn_q8" if quant else "attn"] = attn
        host_us_per_call(tag, getattr(bd, kname),
                         (attn.k_ctx[0], attn.v_ctx[0]) + (
                             (attn.k_scale[0], attn.v_scale[0]) if quant
                             else ()),
                         cfg.n_heads // cfg.n_kv_heads,
                         attn.decode_capacity, seed=14)
        if not quant:   # where a step's time goes (each advances the cache)
            profile_splits(
                tag, "fused decode", lambda i: decode_fn(
                    model, params, cache, toks[:, 1 + i:2 + i]),
                model.n_super, top=10)
        del cache
        errs = []
        for layer, ops, kw, o, S in rec.calls:
            want, S_p = cl.chunked_linear_attention_plain(*ops, **kw)
            ok_o, err_o, rel_o = within_rows(o, want)
            ok_s, _, rel_s = within_rows(S.flatten(2), S_p.flatten(2))
            check(ok_o and ok_s, f"{tag}: layer {layer}: #13 disagrees with "
                                 f"its plain version")
            errs.append((layer, err_o, rel_o, rel_s))
        print(f"{tag}: #13 against its plain version on the served inputs, "
              f"per (layer: max_abs_err, worst row, worst head state): "
              + ", ".join(f"{li}: {e:.2e} {r:.1e} {rs:.1e}"
                          for li, e, r, rs in errs)
              + f" (gate {TOL:g} per row / head)")
        if not quant:
            out["err"] = max(e for _, e, _, _ in errs)
            out["calls"] = [ops for _, ops, _, _, _ in rec.calls]
        del rec

        # the plain versions in bf16, and the fp32 witness on the plain
        # versions: the same path, weights widened from the same bf16
        with plain_versions():
            lp_pre, cache = engine.prefill_shared(params, ctx, BATCH)
            lp_dec, _ = model.decode_step(params, cache, tok, impl="kernel")
        del cache
        if params32 is None:
            params32 = cast_weights(params, torch.float32)
        with plain_versions():
            lw_pre, cache = engine.prefill_shared(params32, ctx, BATCH)
            lw_dec, _ = model.decode_step(params32, cache, tok, impl="kernel")
        del cache
        gc.collect()
        torch.cuda.synchronize()
        for what, lk, lp, lw in (("prefill", lk_pre, lp_pre, lw_pre),
                                 ("first decode step", lk_dec, lp_dec,
                                  lw_dec)):
            live = lw.abs() < 1e29
            check(bool(torch.isfinite(lk.float()[live]).all()),
                  f"{tag}: non-finite {what} logits")
            err_kw, scale = gap(lk[live], lw[live])
            err_pw, _ = gap(lp[live], lw[live])
            err_kp, _ = gap(lk[live], lp[live])
            print(f"{tag}: {what} logits, max_abs_err kernel path vs fp32 "
                  f"witness {err_kw:.3e} ({err_kw / scale:.2e} of max "
                  f"|logit| {scale:.3f}), bf16 plain versions vs witness "
                  f"{err_pw:.3e}, kernel vs plain {err_kp:.3e} (gate "
                  f"max(2e-2 x max |logit|, 1.5 x plain vs witness))")
            check(err_kw <= max(TOL * scale, 1.5 * err_pw),
                  f"{tag}: {what} logits of the kernel path disagree with "
                  f"the fp32 witness")
        del engine, result
    del params, params32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve hybrid: phase 3i took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 3k: xlstm-1.3b served
# ---------------------------------------------------------------------------

XLSTM_SAMPLE_LAYERS = (0, 20, 41)   # mLSTM layers whose #13 call is checked
WITNESS_BATCH = 4   # the plain versions' runs: the first samples' rows


def serve_xlstm():
    """Phase 3k: ServeEngine.generate on xlstm-1.3b at its published width
    and depth (seeded random weights made on the card), bf16. Returns
    ({kernel name: launches} of the run, #13's max abs error over the
    sampled layers, #13's recorded inputs) for phase 4k."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_weights
    from repro_torch.kernels import chunked_linear as cl
    from repro_torch.models import get_model, xlstm

    t_phase = time.perf_counter()
    tag = "serve xlstm"
    cfg = get_config("xlstm-1.3b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _, nh, hd = xlstm._dims(cfg)
    n_mlstm = model.n_groups * model.m_per_group
    print(f"{tag}: {cfg.name} {cfg.n_layers} layers ({model.n_groups} groups "
          f"of {model.m_per_group} mLSTM + 1 sLSTM; d {cfg.d_model}, {nh} "
          f"heads, mLSTM dk = dv = {hd} + the normaliser, chunk "
          f"{cfg.ssm.chunk}), vocab {cfg.padded_vocab}: "
          f"{n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = torch.Generator(device=DEVICE).manual_seed(5)
    ctx = torch.randint(0, cfg.vocab_size, (1, CONTEXT), generator=rng,
                        device=DEVICE)
    engine = xlstm_engine(cfg, model, BATCH)

    # the counted generate: the prefill's logits, ms and sLSTM loops'
    # time, #13's calls (the sampled layers kept, each call's device time)
    # and the first decode step's logits recorded on the way
    seen, slstm_ms = {}, []
    real_pre, real_dec = engine.prefill_shared, model.decode_step
    real_slstm = xlstm.apply_slstm_prefill

    def spy_pre(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_pre(*a)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t0
        seen["prefill"] = out[0].clone()
        return out

    def spy_dec(prm, cache, tok, **kw):
        out = real_dec(prm, cache, tok, **kw)
        if "decode" not in seen:
            seen["decode"], seen["tok"] = out[0].clone(), tok.clone()
        return out

    def spy_slstm(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_slstm(*a)
        torch.cuda.synchronize()
        slstm_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.prefill_shared, model.decode_step = spy_pre, spy_dec
    xlstm.apply_slstm_prefill = spy_slstm
    torch.cuda.synchronize()
    reset_launches()
    try:
        with record_chunked(XLSTM_SAMPLE_LAYERS, "xlstm") as rec:
            t0 = time.perf_counter()
            result = engine.generate(params, ctx, n_steps=STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del engine.prefill_shared, model.decode_step
        xlstm.apply_slstm_prefill = real_slstm
    counts = read_launches()
    print(f"{tag}: generate launches {counts}")
    want_13 = 2 * n_mlstm       # the wide path: two launches a call
    expect_counts(counts, {"chunked_linear_attention": want_13})
    check(rec.n == n_mlstm, f"#13 called {rec.n} times")
    toks, lps = result.tokens, result.logprobs
    check(tuple(toks.shape) == (BATCH, STEPS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()), "logprobs")
    check(len({tuple(t) for t in toks.tolist()}) > 1,
          "every sample drew the same tokens: the states are shared")
    prefill_s = seen["prefill_s"]
    k13_ms = rec.device_ms()
    state_bytes = sum(math.prod(shape) * torch.tensor([], dtype=dt
                                                      ).element_size()
                      for shape, dt in model.cache_spec(BATCH).values())
    print(f"{tag}: generate {wall * 1e3:.1f} ms = prefill "
          f"{prefill_s * 1e3:.1f} ms + {STEPS - 1} decode steps at "
          f"{(wall - prefill_s) / (STEPS - 1) * 1e3:.2f} ms/step (batch "
          f"{BATCH}, context {CONTEXT}; states {state_bytes} bytes)")
    print(f"{tag}: prefill: the {len(slstm_ms)} sLSTM layers' loops "
          f"{sum(slstm_ms):.1f} ms ({sum(slstm_ms) / (prefill_s * 1e3):.1%};"
          f" per layer " + ", ".join(f"{x:.0f}" for x in slstm_ms)
          + f"); #13 {k13_ms:.2f} ms on the device in {rec.n} calls, "
          f"{want_13} launches (CUDA events around each call; "
          f"{k13_ms / (prefill_s * 1e3):.1%})")

    errs = []
    for layer, ops, kw, o, S in rec.calls:
        want, S_p = cl.chunked_linear_attention_plain(*ops, **kw)
        ok_o, err_o, rel_o = within_rows(o, want)
        ok_s, _, rel_s = within_rows(S.flatten(2), S_p.flatten(2))
        check(ok_o and ok_s, f"{tag}: layer {layer}: #13 disagrees with its "
                             f"plain version")
        errs.append((layer, err_o, rel_o, rel_s))
    print(f"{tag}: #13 against its plain version on the served inputs, per "
          f"(mLSTM layer: max_abs_err, worst row, worst head state): "
          + ", ".join(f"{li}: {e:.2e} {r:.1e} {rs:.1e}"
                      for li, e, r, rs in errs)
          + f" (gate {TOL:g} per row / head)")
    calls = [ops for _, ops, _, _, _ in rec.calls]
    del rec, result

    # the plain versions in bf16 and the fp32 witness on the plain versions
    # (weights widened from the same bf16): the same path at batch
    # WITNESS_BATCH, the first samples' tokens
    wb = WITNESS_BATCH
    tok = seen["tok"][:wb]
    witness = xlstm_engine(cfg, model, wb)
    params32 = cast_weights(params, torch.float32)
    runs = {}
    for name, prm in (("plain", params), ("witness", params32)):
        with plain_versions():
            l_pre, cache = witness.prefill_shared(prm, ctx, wb)
            l_dec, _ = model.decode_step(prm, cache, tok)
        runs[name] = (l_pre, l_dec)
        del cache
        gc.collect()
    for i, what in enumerate(("prefill logits", "first decode step logits")):
        got = (seen["prefill"], seen["decode"])[i][:wb]
        gate_logits(f"{tag} (kernel path vs fp32 witness, batch {wb})", what,
                    got, runs["witness"][i], runs["plain"][i])
    xlstm_layer_witness(tag, cfg, model, params, params32, ctx, tok)
    del params, params32, runs, seen
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag}: phase 3k took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": want_13, "err": max(e for _, e, _, _ in errs),
            "calls": calls}


def xlstm_layer_witness(tag, cfg, model, params, params32, ctx, tok):
    """Phase 3k's gate layer by layer: every layer of the prefill and of
    the first decode step fed the fp32 witness's own input (its residual
    stream, and for the decode its states, copied per sample), in bf16
    through the kernel path and through the plain versions, and in fp32
    through the plain versions. Each layer's increment (output less input)
    on the kernel path must lie within max(2e-2 x max |witness's|, 1.5 x
    the bf16 plain versions' distance) of the witness's; the decode step's
    (no kernel runs in it) within max(2e-2, 1.5 x the same layer's prefill
    plain distance) of max |witness's|. A random-weight xLSTM this deep
    carries each layer's bf16 rounding (~1% of its increment) into every
    later layer and ends with logits unrelated to the fp32 path's, so the
    whole-path gate above cannot tell a fault from rounding; this one
    holds each layer to rounding alone."""
    import torch
    from repro_torch.models import xlstm

    fns = {"m": (xlstm.apply_mlstm_prefill, xlstm.apply_mlstm_decode),
           "s": (xlstm.apply_slstm_prefill, xlstm.apply_slstm_decode)}
    layers32 = {(kind, at): lp for kind, at, lp in model._layers(params32)}
    x, xd = params32["embed"][ctx], params32["embed"][tok]
    wb = tok.shape[0]

    def fan(st):   # the batch-1 states, one copy per sample
        if isinstance(st, tuple):
            return tuple(fan(t) for t in st)
        return st.expand(wb, *st.shape[1:]).contiguous()

    rels = {"m": [], "s": []}
    for kind, at, lp in model._layers(params):
        pre, dec = fns[kind]
        lw = layers32[(kind, at)]
        xb, xdb = x.bfloat16(), xd.bfloat16()
        y_k, _ = pre(cfg, lp, xb)
        with plain_versions():
            y_p, _ = pre(cfg, lp, xb)
            y_w, st_w = pre(cfg, lw, x)
        inc_w = y_w - x
        e_k, scale = gap(y_k.float() - xb.float(), inc_w)
        e_p, _ = gap(y_p.float() - xb.float(), inc_w)
        check(e_k <= max(TOL * scale, 1.5 * e_p),
              f"{tag}: layer {kind} {at}: the prefill's increment is off the "
              f"fp32 witness's")
        yd_k, _ = dec(cfg, lp, xdb, fan(st_w))
        yd_w, _ = dec(cfg, lw, xd, fan(st_w))
        e_d, scale_d = gap(yd_k.float() - xdb.float(), yd_w - xd)
        check(e_d <= max(TOL, 1.5 * e_p / scale) * scale_d,
              f"{tag}: layer {kind} {at}: the decode step's increment is off "
              f"the fp32 witness's")
        rels[kind].append((at, e_k / scale, e_p / scale, e_d / scale_d))
        x, xd = y_w, yd_w
        del y_k, y_p, st_w
    for kind, name in (("m", "mLSTM"), ("s", "sLSTM")):
        r = rels[kind]
        print(f"{tag}: layer by layer on the fp32 witness's inputs, "
              f"{len(r)} {name} layers: increment error / max |witness "
              f"increment|, prefill kernel path worst "
              f"{max(x[1] for x in r):.2e} (bf16 plain versions "
              f"{max(x[2] for x in r):.2e}), first decode step worst "
              f"{max(x[3] for x in r):.2e}; per layer (kernel, plain, "
              f"decode): " + ", ".join(
                  f"{at}: {k:.1e} {p:.1e} {d:.1e}" for at, k, p, d in r))


def xlstm_engine(cfg, model, batch):
    """The serve engine phase 3k drives: ``batch`` samples, sampled at
    temperature 0.8 (so each sample's states take their own tokens)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.runtime.serve import ServeEngine

    return ServeEngine(model, cfg, ServeConfig(
        batch=batch, context_len=CONTEXT, decode_capacity=max(16, STEPS + 8),
        temperature=0.8))


# ---------------------------------------------------------------------------
# phase 3l: the MoE, VLM and encoder-decoder families served
# ---------------------------------------------------------------------------

# layers kept where one 80 GB card cannot hold the model (PERF.md §4):
# dbrx-132b 8 of 40 (16 experts of 3 x 6144 x 10752 bf16, 6.3 GB a layer),
# mixtral-8x7b 16 of 32 (2.8 GB a layer); internvl2-26b and whisper-medium
# are whole
FAMILY_LAYERS = {"dbrx-132b": 8, "mixtral-8x7b": 16}
FAMILY_FOREST = (8192, 2500)    # dbrx's forest: two prompts, 8 samples each
FAMILY_FOREST_STEPS = 8         # one chunk
MIXTRAL_STEPS = 8               # decode steps (no kernel: the window)


class record_routes:
    """Keep every MoE routing decision made inside the block (each call of
    ``models/moe.route``: its expert ids, in ``calls``), or, given
    ``replay`` (another run's record), impose that run's ids call for call,
    the gate values taken from this run's own router probabilities. A
    near-tie that bf16 rounding flips (``route_gate`` holds each layer to
    near-ties) moves a token's output by a whole expert's share and, in a
    prefill, every later token's through attention and the experts'
    capacity; with the choices imposed, a whole-path gate measures what
    the kernels do to the numbers. ``flips`` counts the (token, layer)
    choices this run would have made otherwise."""

    def __init__(self, replay=None):
        self.replay = replay
        self.calls, self.flips = [], 0

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.saved = moe, moe.route

        def route(router, x, top_k):
            probs, vals, idx = self.saved(router, x, top_k)
            if self.replay is not None:
                own, idx = idx, self.replay.calls[len(self.calls)]
                self.flips += int((own.sort(-1).values
                                   != idx.sort(-1).values).any(-1).sum())
                vals = probs.gather(-1, idx)
                vals = vals / vals.sum(-1, keepdim=True)
            self.calls.append(idx)
            return probs, vals, idx

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.saved


def family_config(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    return dataclasses.replace(cfg, **kw)


def family_model(tag, cfg):
    """The model and its seeded random weights made on the card, with the
    init's peak device memory beside the weights' bytes."""
    import torch
    from repro_torch.models import get_model

    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(0, device=DEVICE)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{tag}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} h="
          f"{cfg.n_heads} g={cfg.n_kv_heads} hd={cfg.kq_dim} d_ff={cfg.d_ff}"
          + (f" experts={cfg.moe.n_experts} top_k={cfg.moe.top_k}"
             if cfg.moe else "")
          + f" vocab={cfg.padded_vocab}: "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params, "
          f"{nbytes / 1e9:.2f} GB; init {time.perf_counter() - t0:.1f} s, "
          f"its peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f}"
          f" GB")
    return model, params


def family_inputs(cfg):
    """The CLI's inputs (``launch/serve.py``, ``--context CONTEXT``): the
    context's tokens, and a VLM's patch embeddings or an encoder-decoder's
    frames (and ``sample_batch``), from ``np.random.RandomState(0)``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    ctx = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, CONTEXT)),
                          device=DEVICE)
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.as_tensor(
            rng.randn(1, cfg.n_image_tokens, cfg.d_model) * 0.02,
            dtype=torch.float32, device=DEVICE)
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(
            rng.randn(1, CONTEXT, cfg.d_model) * 0.02, dtype=torch.float32,
            device=DEVICE)
        kw["sample_batch"] = BATCH
    return ctx, kw


def family_generate(tag, model, cfg, params, ctx, kw, want, cache_dtype,
                    steps=STEPS, warm=False):
    """ServeEngine.generate at batch 32 with the fused kernels (after a
    warm-up generate where ``warm``: the phase's first): its launch counts
    (``want``: kernel name -> launches; no other kernel), tokens and
    log-probs, prefill ms and decode ms/step. Returns (engine, result, the
    cache of a prefill of its own, counts)."""
    import torch
    from repro_torch.configs import ServeConfig
    from repro_torch.runtime.serve import ServeEngine

    engine = ServeEngine(model, cfg, ServeConfig(
        batch=BATCH, context_len=CONTEXT, decode_capacity=max(16, steps + 8),
        bifurcated=True, use_kernel=True, cache_dtype=cache_dtype))
    check(engine.should_bifurcate(BATCH, CONTEXT), "policy did not bifurcate")
    if warm:
        engine.generate(params, ctx, n_steps=2, **kw)
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = engine.generate(params, ctx, n_steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f"{tag}: generate launches {counts}")
    expect_counts(counts, want)
    toks, lps = result.tokens, result.logprobs
    check(tuple(toks.shape) == (BATCH, steps)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and bool(torch.isfinite(lps).all() and (lps <= 0).all()),
          f"{tag}: tokens or log-probs out of range")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = engine.prefill_shared(params, ctx, BATCH, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    print(f"{tag}: generate {wall * 1e3:.1f} ms = prefill "
          f"{prefill_s * 1e3:.1f} ms + {steps - 1} decode steps at "
          f"{(wall - prefill_s) / (steps - 1) * 1e3:.2f} ms/step (batch "
          f"{BATCH}, context {CONTEXT}; on {CARD[0]})")
    return engine, result, cache, counts


def _fresh(cache):
    """The cache with copies of its decode arms (a step writes them)."""
    import dataclasses

    if isinstance(cache, dict):
        return {**cache, "self": _fresh(cache["self"])}
    return dataclasses.replace(cache, k_dec=cache.k_dec.clone(),
                               v_dec=cache.v_dec.clone())


def route_gate(tag, what, router, h_k, h_p, top_k):
    """The MoE trap: the expert choices the router makes for the kernel
    stream's input ``h_k`` against the plain stream's ``h_p`` (rows, d).
    A row may choose differently only where the plain row's k-th and
    (k+1)-th router logits lie within 2e-2 of its largest |logit| (a
    near-tie that bf16 rounding may flip); returns the rows that kept
    their choices."""
    from repro_torch.models import moe

    l_p = h_p.float() @ router.float()
    _, _, i_k = moe.route(router, h_k, top_k)
    _, _, i_p = moe.route(router, h_p, top_k)
    same = (i_k.sort(-1).values == i_p.sort(-1).values).all(-1)
    top = l_p.sort(-1, descending=True).values
    margin = top[:, top_k - 1] - top[:, top_k]
    near = margin <= TOL * l_p.abs().amax(-1)
    check(bool((same | near).all()),
          f"{tag}: {what}: expert choices differ on a row whose router "
          f"margin exceeds 2e-2 of its largest logit")
    return same


def family_layer_gate(tag, cfg, model, params, cache, tok):
    """One decode step of a TransformerLM (dbrx, internvl2) walked layer
    by layer on the plain versions' own residual stream: each layer's
    attention on the kernel path against its plain versions on the same
    input (2e-2 of max |out|); for the MoE, the router's choices for the
    kernel stream's input against the plain's (``route_gate``) and
    ``moe_decode`` on the rows that kept them within 2e-2 of max |out|.
    Prints the flipped rows and the worst errors."""
    import torch
    from repro_torch.models import blocks, moe
    from repro_torch.models.transformer import _layer

    names = ["k_ctx", "v_ctx", "k_dec", "v_dec"]
    if hasattr(cache, "k_scale"):
        names += ["k_scale", "v_scale"]
    position = cache.context_len + cache.dec_length
    x = model._embed(params, tok)
    rel_a = rel_m = 0.0
    flipped = []
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        h = blocks.apply_norm(cfg, layer["ln1"], x)

        def attn():
            lc = {n: getattr(cache, n)[i] for n in names}
            lc["k_dec"], lc["v_dec"] = lc["k_dec"].clone(), lc["v_dec"].clone()
            return blocks.attention_decode(cfg, layer["attn"], h, lc,
                                           position=position, bifurcated=True,
                                           impl="kernel")

        o_k = attn()
        with plain_versions():
            o_p = attn()
        ok, _, rel = within(o_k, o_p)
        check(ok, f"{tag}: layer {i}: kernel attention disagrees with its "
                  f"plain versions ({rel:.2e} of max |out|)")
        rel_a = max(rel_a, rel)
        x_k, x = x + o_k, x + o_p
        h_p = blocks.apply_norm(cfg, layer["ln2"], x)
        if cfg.moe is None:
            x = x + blocks.apply_mlp(cfg, layer["mlp"], h_p)
            continue
        h_k = blocks.apply_norm(cfg, layer["ln2"], x_k)
        d = cfg.d_model
        same = route_gate(tag, f"layer {i}", layer["moe"]["router"],
                          h_k.reshape(-1, d), h_p.reshape(-1, d),
                          cfg.moe.top_k)
        flipped.append(int((~same).sum()))
        m_k = moe.moe_decode(cfg, layer["moe"], h_k)
        m_p = moe.moe_decode(cfg, layer["moe"], h_p)
        ok, _, rel = within(m_k.reshape(-1, d)[same], m_p.reshape(-1, d)[same])
        check(ok, f"{tag}: layer {i}: moe_decode on the kernel stream's "
                  f"input disagrees ({rel:.2e} of max |out|)")
        rel_m = max(rel_m, rel)
        x = x + m_p
    torch.cuda.synchronize()
    print(f"{tag}: one decode step layer by layer on the plain versions' "
          f"stream ({cache.dec_length + 1} live decode slots): attention, "
          f"kernel vs plain, worst {rel_a:.2e} of max |out| (gate 2e-2)"
          + (f"; MoE rows whose expert choices flipped, per layer "
             f"{flipped} of {tok.numel()} (each a near-tie), moe_decode on "
             f"the rest worst {rel_m:.2e}" if cfg.moe else ""))


def family_step_gate(tag, model, params, cache, tok, moe_model):
    """The whole step: kernel path vs the plain impl="flash" path, within
    max(2e-2 x max |logit|, 1.5 x the kernels' plain versions' distance);
    a MoE model's kernel and plain-version runs take the flash run's
    expert choices (``record_routes``), the flips they would have made
    printed."""
    import contextlib

    def run(impl, plain=False, replay=None):
        with (record_routes(replay) if moe_model
              else contextlib.nullcontext()) as rec, \
                (plain_versions() if plain else contextlib.nullcontext()):
            logits, _ = model.decode_step(params, _fresh(cache), tok,
                                          impl=impl)
        return logits[:, -1], rec

    lf, ref = run("flash")
    lk, rec_k = run("kernel", replay=ref)
    lp, rec_p = run("kernel", plain=True, replay=ref)
    if moe_model:
        print(f"{tag}: whole step on the flash run's expert choices; the "
              f"kernel path would have flipped {rec_k.flips}, the plain "
              f"versions {rec_p.flips} (row, layer) choices of "
              f"{tok.numel() * len(ref.calls)}")
    gate_logits(tag, "decode-step logits, kernel path vs flash path", lk, lf,
                lp)


def family_prefill_gate(tag, cfg, model, params, ctx, kw):
    """A prefill under train_attn="flash" (#12) against the chunked one:
    the last position's logits within the whole-step gate, the flash
    prefill on the plain versions the witness (a MoE model's flash runs
    take the chunked run's expert choices, ``record_routes``). Prints
    prefill ms, flash beside chunked, in turns. Returns #12's launches of
    one prefill."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.models import get_model

    models = {name: get_model(dataclasses.replace(cfg, train_attn=name))
              for name in ("chunked", "flash")}
    times = {"chunked": [], "flash": []}
    out = {}
    for name in ("chunked", "flash", "flash", "chunked"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = models[name].prefill(params, ctx, **kw)[0]
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        if name == "flash":
            launches = read_launches()["flash_prefill_attention"]
    print(f"{tag}: prefill of {CONTEXT} tokens, flash "
          + " / ".join(f"{t:.1f}" for t in times["flash"]) + " ms, chunked "
          + " / ".join(f"{t:.1f}" for t in times["chunked"])
          + f" ms (in turns); #12 {launches} launches a prefill")
    ref = None
    if cfg.moe:
        with record_routes() as ref:
            out["chunked"] = models["chunked"].prefill(params, ctx, **kw)[0]

    def flash(plain):
        with (record_routes(ref) if ref is not None
              else contextlib.nullcontext()
              ) as rec, (plain_versions() if plain
                         else contextlib.nullcontext()):
            return models["flash"].prefill(params, ctx, **kw)[0], rec

    (out["flash"], rec_f), (out["plain"], rec_p) = flash(False), flash(True)
    if ref is not None:
        print(f"{tag}: flash prefills on the chunked run's expert choices; "
              f"the kernel path would have flipped {rec_f.flips}, the plain "
              f"versions {rec_p.flips} (token, layer) choices of "
              f"{ctx.shape[1] * cfg.n_layers}")
    gate_logits(tag, "prefill logits, flash vs chunked", out["flash"],
                out["chunked"], out["plain"])
    return launches


def family_prefill_layers(tag, cfg, model, params, ctx):
    """mixtral's prefill under flash walked layer by layer on the plain
    versions' stream: #12 against its plain version on each layer's input
    (row by row), and apply_moe's router choices for the kernel stream's
    input against the plain's (``route_gate`` over every token). Returns
    #12's worst row error."""
    import torch
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import blocks, moe
    from repro_torch.models.transformer import _layer

    x = model._embed(params, ctx)
    pos = torch.arange(x.shape[1], device=x.device)
    worst = err_abs = 0.0
    flipped = []
    for i in range(cfg.n_layers):
        layer = _layer(params["layers"], i)
        h = blocks.apply_norm(cfg, layer["ln1"], x)
        q, k, v = blocks._project_qkv(cfg, layer["attn"], h)
        q = blocks.apply_rope(q, pos, cfg.rope_theta)
        k = blocks.apply_rope(k, pos, cfg.rope_theta)
        kw = dict(window=cfg.sliding_window or 0)
        o_k = fp.flash_prefill_attention(q, k, v, **kw)
        o_p = fp.flash_prefill_attention_plain(q, k, v, **kw)
        ok, err, rel = within_rows(o_k, o_p)
        check(ok, f"{tag}: layer {i}: #12 disagrees with its plain version "
                  f"({rel:.2e} of a row's max)")
        worst, err_abs = max(worst, rel), max(err_abs, err)
        wo = layer["attn"]["wo"].to(x.dtype)
        hd_all = cfg.n_heads_padded * cfg.kq_dim
        x_k = x + o_k.reshape(*x.shape[:2], hd_all) @ wo
        x = x + o_p.reshape(*x.shape[:2], hd_all) @ wo
        h_p = blocks.apply_norm(cfg, layer["ln2"], x)
        h_k = blocks.apply_norm(cfg, layer["ln2"], x_k)
        d = cfg.d_model
        same = route_gate(tag, f"prefill layer {i}", layer["moe"]["router"],
                          h_k.reshape(-1, d), h_p.reshape(-1, d),
                          cfg.moe.top_k)
        flipped.append(int((~same).sum()))
        x = x + moe.apply_moe(cfg, layer["moe"], h_p)[0]
        del q, k, v, o_k, o_p, x_k, h_k
    print(f"{tag}: prefill layer by layer on the plain versions' stream: "
          f"#12 (window {cfg.sliding_window}) worst row {worst:.2e} (gate "
          f"2e-2), max_abs_err {err_abs:.3e}; tokens whose expert choices "
          f"flipped, per layer {flipped} of {ctx.shape[1]} (each a "
          f"near-tie)")
    return err_abs


def check_decode_kernels(tag, cfg, cache, quant, seed):
    """#1 (int8: #3) at the served shape against its plain version on
    every layer's served context, random queries and decode arms; returns
    the max abs error."""
    import torch
    from repro_torch.kernels.ops import (
        bifurcated_decode_attention,
        bifurcated_decode_attention_q8,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    c_d = cache.decode_capacity
    q = torch.randn(BATCH, g, p, 1, hd, generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    kd, vd = (torch.randn(BATCH, c_d, g, hd, generator=gen,
                          device=DEVICE).to(torch.bfloat16) for _ in range(2))
    mask = (torch.arange(c_d, device=DEVICE)[None, :]
            < torch.randint(1, c_d + 1, (BATCH, 1), generator=gen,
                            device=DEVICE))
    err = rel_w = 0.0
    for i in range(cache.k_ctx.shape[0]):
        if quant:
            args = (q, cache.k_ctx[i], cache.v_ctx[i], cache.k_scale[i],
                    cache.v_scale[i], kd, vd, mask)
            fn = bifurcated_decode_attention_q8
        else:
            args = (q, cache.k_ctx[i], cache.v_ctx[i], kd, vd, mask)
            fn = bifurcated_decode_attention
        got = fn(*args, ctx_layout=cfg.ctx_layout)
        with plain_versions():
            want = fn(*args, ctx_layout=cfg.ctx_layout)
        ok, e, rel = within(got, want)
        check(ok, f"{tag}: layer {i}: the decode kernel disagrees with its "
                  f"plain version ({rel:.2e})")
        err, rel_w = max(err, e), max(rel_w, rel)
    print(f"{tag}: {'#3' if quant else '#1'} at g={g} p={p} ({BATCH * p} "
          f"rows) hd={hd} m_c={cache.context_len} on every layer's served "
          f"context vs its plain version: worst {rel_w:.2e} of max |out| "
          f"(gate 2e-2), max_abs_err {err:.3e}")
    return err


def serve_moe_dbrx(out):
    """dbrx-132b at 8 of its 40 layers: bf16 and int8 context (#1, #3),
    then a forest of two prompts (#4)."""
    import gc

    import torch
    from repro_torch.configs import ForestConfig
    from repro_torch.runtime.serve import ForestServeEngine

    tag = "serve dbrx"
    cfg = family_config("dbrx-132b")
    model, params = family_model(tag, cfg)
    ctx, kw = family_inputs(cfg)
    L = cfg.n_layers
    caches = {}
    for quant in (False, True):
        t = f"{tag} int8" if quant else tag
        kname = ("fused_bifurcated_decode_q8" if quant
                 else "fused_bifurcated_decode")
        eng, result, cache, counts = family_generate(
            t, model, cfg, params, ctx, kw, {kname: L * (STEPS - 1)},
            "int8" if quant else "bfloat16", warm=not quant)
        out["launches"][("p6", quant)] = counts[kname]
        tok = result.tokens[:, :1]
        family_layer_gate(t, cfg, model, params, cache, tok)
        family_step_gate(t, model, params, cache, tok, True)
        out["errs"][("p6", quant)] = check_decode_kernels(
            t, cfg, cache, quant, seed=41 + quant)
        caches[quant] = cache
        del eng, result
    out["caches"]["p6"] = (cfg, caches[False], caches[True])

    # the forest: two prompts, 8 samples each, one chunk
    tf = f"{tag} forest"
    feng = ForestServeEngine(model, cfg, ForestConfig(
        n_groups=2, slots=16, ctx_capacity=max(FAMILY_FOREST),
        decode_capacity=16, use_kernel=True))
    st = feng.init_state(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(43)
    t0 = time.perf_counter()
    for n in FAMILY_FOREST:
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                               device=DEVICE)
        st, _ = feng.admit(params, st, prompt, 8)
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    st = feng.step_chunk(params, st, FAMILY_FOREST_STEPS)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    counts = read_launches()
    expect_counts(counts, {"grouped_fused_bifurcated_decode":
                           L * FAMILY_FOREST_STEPS})
    emitted = sum(len(v) for v in feng.outputs.values())
    check(emitted == 16 * (1 + FAMILY_FOREST_STEPS),
          f"{tf}: {emitted} tokens emitted")
    print(f"{tf}: prompts of {FAMILY_FOREST} tokens, 8 samples each: "
          f"admissions {admit_s * 1e3:.1f} ms, a chunk of "
          f"{FAMILY_FOREST_STEPS} steps {chunk_s * 1e3:.1f} ms "
          f"({chunk_s / FAMILY_FOREST_STEPS * 1e3:.2f} ms/step); launches "
          f"{counts}")
    check_forest_kernel(tf, cfg, st.cache)
    del feng, st, params, model
    gc.collect()
    torch.cuda.empty_cache()


def check_forest_kernel(tag, cfg, fcache):
    """#4 on the served forest segments (every layer) against its plain
    version: random queries and decode arms over the 16 slots."""
    import torch
    from repro_torch.kernels.ops import grouped_bifurcated_decode_attention

    gen = torch.Generator(device=DEVICE).manual_seed(44)
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    b, c_d = fcache.k_dec.shape[1:3]
    q = torch.randn(b, g, p, 1, hd, generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    mask = torch.arange(c_d, device=DEVICE)[None, :] <= fcache.dec_lens[:, None]
    err = rel_w = 0.0
    for i in range(fcache.k_ctx.shape[0]):
        args = (q, fcache.k_ctx[i], fcache.v_ctx[i], fcache.group_ids,
                fcache.ctx_lens, fcache.k_dec[i], fcache.v_dec[i], mask)
        got = grouped_bifurcated_decode_attention(*args,
                                                  ctx_layout=cfg.ctx_layout)
        with plain_versions():
            want = grouped_bifurcated_decode_attention(
                *args, ctx_layout=cfg.ctx_layout)
        ok, e, rel = within(got, want)
        check(ok, f"{tag}: layer {i}: #4 disagrees with its plain version")
        err, rel_w = max(err, e), max(rel_w, rel)
    print(f"{tag}: #4 at g={g} p={p} on every layer's served segments vs "
          f"its plain version: worst {rel_w:.2e} of max |out| (gate 2e-2)")
    return err


def serve_moe_mixtral(out):
    """mixtral-8x7b at 16 of its 32 layers under train_attn="flash": #12
    with its 4096 window in every prefill; 8 decode steps (the window
    takes them off the kernel, as in the reference)."""
    import gc

    import torch

    tag = "serve mixtral"
    cfg = family_config("mixtral-8x7b", train_attn="flash")
    model, params = family_model(tag, cfg)
    ctx, kw = family_inputs(cfg)
    eng, result, cache, counts = family_generate(
        tag, model, cfg, params, ctx, kw,
        {"flash_prefill_attention": cfg.n_layers}, "bfloat16",
        steps=MIXTRAL_STEPS + 1)
    out["launches"]["window"] = counts["flash_prefill_attention"]
    del eng, result, cache
    family_prefill_gate(tag, cfg, model, params, ctx, kw)
    out["errs"]["window"] = family_prefill_layers(tag, cfg, model, params,
                                                  ctx)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def serve_vlm():
    """internvl2-26b, all 48 layers: 1024 patch embeddings before 8192
    text tokens, bf16 and int8 context (#1, #3 over 9216 keys; their JSON
    entries at p 6 are dbrx's shape)."""
    import gc

    import torch

    tag = "serve internvl2"
    cfg = family_config("internvl2-26b")
    model, params = family_model(tag, cfg)
    ctx, kw = family_inputs(cfg)
    L = cfg.n_layers
    for quant in (False, True):
        t = f"{tag} int8" if quant else tag
        kname = ("fused_bifurcated_decode_q8" if quant
                 else "fused_bifurcated_decode")
        eng, result, cache, _ = family_generate(
            t, model, cfg, params, ctx, kw, {kname: L * (STEPS - 1)},
            "int8" if quant else "bfloat16")
        check(cache.context_len == CONTEXT + cfg.n_image_tokens,
              f"{t}: context {cache.context_len}")
        tok = result.tokens[:, :1]
        family_layer_gate(t, cfg, model, params, cache, tok)
        family_step_gate(t, model, params, cache, tok, False)
        check_decode_kernels(t, cfg, cache, quant, seed=45 + quant)
        del eng, result, cache
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def serve_encdec(out):
    """whisper-medium, whole: 8192 frames and 8192 decoder tokens (the CLI
    at --context 8192), bf16 and int8 self-attention context (#1, #3 at hd
    64, g 16, p 1); the prefill chunked and under flash (#12: non-causal
    encoder and cross-attention, causal decoder), gated against each
    other."""
    import dataclasses
    import gc

    import torch

    tag = "serve whisper"
    cfg = family_config("whisper-medium")
    model, params = family_model(tag, cfg)
    ctx, kw = family_inputs(cfg)
    L = cfg.n_layers
    for quant in (False, True):
        t = f"{tag} int8" if quant else tag
        kname = ("fused_bifurcated_decode_q8" if quant
                 else "fused_bifurcated_decode")
        eng, result, cache, counts = family_generate(
            t, model, cfg, params, ctx, kw, {kname: L * (STEPS - 1)},
            "int8" if quant else "bfloat16")
        out["launches"][("hd64", quant)] = counts[kname]
        tok = result.tokens[:, :1]
        family_step_gate(t, model, params, cache, tok, False)
        out["errs"][("hd64", quant)] = check_decode_kernels(
            t, cfg, cache["self"], quant, seed=47 + quant)
        if quant:
            out["caches"]["hd64"] = (cfg, prev, cache["self"])
        prev = cache["self"]
        del eng, result, cache
    cfg_f = dataclasses.replace(cfg, train_attn="flash")
    out["launches"]["noncausal"] = family_prefill_gate(
        tag, cfg_f, model, params, ctx, kw)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def serve_families():
    """Phase 3l. Returns the JSON entries of #1, #3 and #12 at this
    slice's shapes (phase 4's timing, on the served caches)."""
    import gc

    import torch

    # each model's phase fills in the launches and errors of its shapes
    # (keys "p6", "hd64" with the int8 flag; "window", "noncausal") and
    # hands its served caches to the timing that follows it
    out = {"launches": {}, "errs": {}, "caches": {}}
    t_phase = time.perf_counter()
    serve_moe_dbrx(out)
    entries = time_decode_shape("p6", *out["caches"].pop("p6"), out)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"elapsed: phase 3l dbrx-132b {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    serve_moe_mixtral(out)
    print(f"elapsed: phase 3l mixtral-8x7b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_vlm()
    print(f"elapsed: phase 3l internvl2-26b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_encdec(out)
    entries += time_decode_shape("hd64", *out["caches"].pop("hd64"), out)
    gc.collect()
    torch.cuda.empty_cache()
    entries += time_flash_families(out)
    print(f"elapsed: phase 3l whisper-medium and #12's times "
          f"{time.perf_counter() - t0:.1f} s")
    return entries


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


def time_ms_graph(fn, n_inputs, reps=3, replays=4):
    """Mean ms per call of ``fn(i)`` over the ``n_inputs`` input sets,
    captured once in a CUDA graph (after a warm-up pass on a side stream)
    and replayed: no host work between the launches, so a kernel faster
    than its wrapper's Python is timed and not the host. Best of ``reps``
    timed runs of ``replays`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_inputs):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inputs):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / (replays * n_inputs))
    del graph
    return best


def split_sweep(name, at_splits, n_inputs, default, shares=(1, 4, 8, 16, 32)):
    """One line: a split kernel (``at_splits(S)`` gives its call on input
    set i) at each S of ``shares`` and the default, graph-timed."""
    times = {S: time_ms_graph(at_splits(S), n_inputs)
             for S in sorted(set(shares) | {default},
                            key=lambda S: (isinstance(S, tuple), S))}
    print(f"time (split sweep): {name}: "
          + ", ".join(f"S={S}{' (default)' if S == default else ''} "
                      f"{t * 1e3:.1f} us" for S, t in times.items()))


def merge_share(name, call, n_inputs):
    """One line: the device time per launch of a split call's two kernels,
    split_kernel and merge_kernel, by torch.profiler over ``n_inputs``
    calls (after a warm-up pass; each kernel's total over the launches the
    profiler recorded), and the merge's share ("not measured" when the
    profiler recorded neither kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(n_inputs):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_inputs):
            call(i)
        torch.cuda.synchronize()
    us = {"split": [0.0, 0], "merge": [0.0, 0]}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        for k in us:
            if f"{k}_kernel" in e.key:
                us[k][0] += getattr(e, "self_device_time_total", 0.0)
                us[k][1] += e.count
    if not (us["split"][1] and us["merge"][1]):
        print(f"time (merge share): {name}: not measured (the profiler "
              f"recorded neither kernel)")
        return
    split, merge = (t / n for t, n in us.values())
    print(f"time (merge share): {name}: split_kernel {split:.1f} us, "
          f"merge_kernel {merge:.1f} us per launch ({us['split'][1]} and "
          f"{us['merge'][1]} launches recorded of {n_inputs}; torch.profiler,"
          f" device time): the merge {merge / (split + merge):.1%}")


PLAIN_INPUTS = 4    # input sets a plain version is timed over (a plain
                    # split walk takes up to a second a call)


def _timed_entry(name, source, line, kern, plain, lib, nbytes, flop,
                 launches, err, n_inputs, module="bifurcated_decode.py",
                 graph=False):
    """Time one kernel and its library yardstick over ``n_inputs`` input
    sets, its plain version over the first PLAIN_INPUTS; returns its JSON
    entry (``module``: the Pallas kernel's file under src/repro/kernels).
    ``graph``: the kernel and the yardstick timed by CUDA graph replay
    (``time_ms_graph``); the kernel's back-to-back eager time is printed
    beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flop = flop / BF16_FLOP_PER_S * 1e3
    timer = time_ms_graph if graph else time_ms
    ms = timer(kern, n_inputs)
    n_plain = min(PLAIN_INPUTS, n_inputs)
    plain_ms = time_ms(plain, n_plain, reps=1, iters=n_plain)
    lib_ms = None if lib is None else timer(lib, n_inputs)
    if graph:
        print(f"time (information): {name} eager back to back "
              f"{time_ms(kern, n_inputs) * 1e3:.1f} us/call (CUDA events; "
              f"the wrapper's host work between launches included)")
    entry = {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": f"src/repro/kernels/{module}:{line}",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_flop),
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
        "library_ms": lib_ms,
    }
    print(f"time: {name}: {ms * 1e3:.1f} us/launch"
          + (" (CUDA graph replay)" if graph else "") + ", bound "
          f"{entry['bound_ms'] * 1e3:.1f} us ({entry['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flop / 1e9:.2f} GFLOP), plain "
          f"{plain_ms * 1e3:.1f} us, library "
          + ("- (none computes it)" if lib is None
             else f"{lib_ms * 1e3:.1f} us"))
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


def time_kernels(cfg, cache, q8cache, fcaches, tcaches, pcaches, launches,
                 errs):
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
    skw = {"splits": default_splits(q)}     # #1 / #3 / #5's plain versions

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
                                                bias, **fkw, **skw)

    def fused_lib(i):
        return F.scaled_dot_product_attention(q4, k_all[i], v_all[i],
                                              attn_mask=attn_mask, scale=scale)

    def part(i):
        return bd.context_flash_partials(q, kc[i], vc[i], scale=scale)

    def part_plain(i):
        return bd.context_flash_partials_plain(q, kc[i], vc[i], scale=scale,
                                               **skw)

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
                     errs["fused_bifurcated_decode"], L, graph=True),
        _timed_entry("context_flash_partials", "bifurcated_decode.cu", 1938,
                     part, part_plain, part_lib, part_bytes, part_flop,
                     launches["context_flash_partials"],
                     errs["context_flash_partials"], L, graph=True)]
    split_sweep("context_flash_partials main", lambda S: (
        lambda i: bd.context_flash_partials(q, kc[i], vc[i], scale=scale,
                                            splits=S)), L, skw["splits"],
        shares=(1, 2, 4, 8, 16, 32))
    merge_share(f"context_flash_partials main S={skw['splits']}", part, L)

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
            q, kq[i], vq[i], ks[i], vs[i], kd[i], vd[i], bias, **fkw, **skw)

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
        errs["fused_bifurcated_decode_q8"], L, graph=True))
    for name, call in (("fused_bifurcated_decode", bd.fused_bifurcated_decode),
                       ("fused_bifurcated_decode_q8",
                        bd.fused_bifurcated_decode_q8)):
        ctx = ((lambda i: (kq[i], vq[i], ks[i], vs[i])) if name.endswith("q8")
               else (lambda i: (kc[i], vc[i])))
        split_sweep(f"{name} main", lambda S, call=call, ctx=ctx: (
            lambda i: call(q, *ctx(i), kd[i], vd[i], bias, **fkw, splits=S)),
            L, skw["splits"])
        merge_share(f"{name} main S={skw['splits']}",
                    lambda i, call=call, ctx=ctx: call(
                        q, *ctx(i), kd[i], vd[i], bias, **fkw), L)

    # #8, #9 at the single-prefix shape: phase 3e's paged caches (the same
    # context on 64 pages of 128), the same q, decode arms and yardsticks
    # as #1 and #3; the bytes add the page table, its length and the paths
    paths0 = torch.zeros(1, rows, dtype=torch.int32, device=DEVICE)
    single_entries = []
    for quant, kname, line, lib, nbytes in (
            (False, "paged_fused_bifurcated_decode", 1139, fused_lib,
             fused_bytes),
            (True, "paged_fused_bifurcated_decode_q8", 1312, q8_lib,
             q8_bytes)):
        st = pcaches[quant][0].store
        pools = ((st.k_pages, st.v_pages, st.k_scale_pages, st.v_scale_pages)
                 if quant else (st.k_pages, st.v_pages))
        kern = getattr(bd, kname)
        plain = getattr(bd, kname + "_plain")

        def paged(i, kern=kern, pools=pools, st=st):
            return kern(q, *(t[i] for t in pools), st.page_tables,
                        st.seg_lens, paths0, kd[i], vd[i], bias, **fkw)

        def paged_plain(i, plain=plain, pools=pools, st=st):
            return plain(q, *(t[i] for t in pools), st.page_tables,
                         st.seg_lens, paths0, kd[i], vd[i], bias, **fkw,
                         **skw)

        ok, _, rel = within(lib(0)[0], paged(0))
        print(f"time: library yardstick vs {kname} at the single-prefix "
              f"shape {rel:.2e} of max |out| (gate 2e-2)")
        check(ok, f"{kname}: library yardstick computes another function")
        table_bytes = (st.page_tables.numel() + st.seg_lens.numel()
                       + paths0.numel()) * 4
        single_entries.append(_timed_entry(
            kname, "paged_decode.cu", line, paged, paged_plain, lib,
            nbytes + table_bytes, fused_flop, launches[kname], errs[kname],
            L, graph=True))
        split_sweep(
            f"{kname} single prefix",
            lambda S, kern=kern, pools=pools, st=st: (
                lambda i: kern(q, *(t[i] for t in pools), st.page_tables,
                               st.seg_lens, paths0, kd[i], vd[i], bias,
                               **fkw, splits=S)),
            L, skw["splits"])
        if not quant:
            merge_share(f"{kname} single prefix S={skw['splits']}", paged, L)

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
        # both split: their plain versions at the kernel's default S
        pkw = dict(gkw, **skw)

        def at_splits(S, kern=kern, ctx_ops=ctx_ops, kd=kd, vd=vd):
            return lambda i: kern(q, *ctx_ops(i), row_group, ctx_lens, kd[i],
                                  vd[i], f_bias, **gkw,
                                  **({} if S is None else {"splits": S}))

        grouped = at_splits(None)

        def grouped_plain(i, plain=plain, ctx_ops=ctx_ops, kd=kd, vd=vd,
                          pkw=pkw):
            return plain(q, *ctx_ops(i), row_group, ctx_lens, kd[i], vd[i],
                         f_bias, **pkw)

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
            grouped_lib, nbytes, flop, launches[kname], errs[kname], L,
            graph=True))
        split_sweep(f"{kname} main forest", at_splits, L, skw["splits"])
        merge_share(f"{kname} main forest S={skw['splits']}", grouped, L)
    del g_k, g_v, kd, vd
    tree_entries = time_tree_kernels(cfg, tcaches, pcaches, q, launches,
                                     errs)
    # one JSON entry per kernel: #8/#9 at the single-prefix shape (their
    # main path); their times on the paged trie are printed above
    return (entries + [t for t in tree_entries if t["name"].startswith("tree")]
            + single_entries)


def time_tree_kernels(cfg, tcaches, pcaches, q, launches, errs):
    """#6 and #7 on the trie caches of phase 3d (7 live nodes, 10,968
    keys; 8 slots per request), and #8 and #9 on phase 3e's paged trie
    caches (the same nodes on pages of 128), each with its own decode arms
    (32 slots of capacity TREE_DEC_CAP, live up to each slot's depth), the
    same q. The yardstick: SDPA over [the referenced nodes' live keys ⊕
    decode slots], a row seeing the nodes on its path and its own live
    slots."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.paged import gather_pages
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.kernels.ops import _decode_operands

    L, g, rows, hd = cfg.n_layers, *q.shape
    p = cfg.n_heads // cfg.n_kv_heads
    scale, e = hd**-0.5, 2
    q4 = q[None]
    entries = []
    for quant, kname, source, line in (
            (False, "tree_fused_bifurcated_decode", "tree_decode.cu", 814),
            (True, "tree_fused_bifurcated_decode_q8", "tree_decode.cu", 963),
            (False, "paged_fused_bifurcated_decode", "paged_decode.cu", 1139),
            (True, "paged_fused_bifurcated_decode_q8", "paged_decode.cu",
             1312)):
        paged = kname.startswith("paged")
        tc = pcaches[quant][1] if paged else tcaches[quant]
        b, t_cd = tc.k_dec.shape[1:3]
        t_live = (torch.arange(t_cd, device=DEVICE)[None, :]
                  <= tc.dec_lens[:, None])                  # (slots, t_cd)
        arms = [_decode_operands(tc.k_dec[i], tc.v_dec[i], t_live)
                for i in range(L)]
        kd, vd = [a[0] for a in arms], [a[1] for a in arms]
        t_bias = arms[0][2]
        del arms
        row_s = torch.arange(rows, device=DEVICE)[:, None] // p
        col_s = torch.arange(b * t_cd, device=DEVICE)[None, :] // t_cd
        dec_ok = (row_s == col_s) & t_live.reshape(1, b * t_cd)
        n_live = int(t_live.sum())
        path_rows = tc.paths.repeat_interleave(p, dim=1).contiguous()
        node_lens = tc.node_lens
        lens = node_lens.tolist()
        used = sorted(set(tc.paths[tc.paths >= 0].tolist()))
        key_node = torch.cat([torch.full((lens[n],), n, device=DEVICE)
                              for n in used])
        mask = torch.cat([(path_rows[:, :, None] == key_node).any(0),
                          dec_ok], dim=1)
        slot_keys = sum(lens[n] for n in tc.paths[tc.paths >= 0].tolist())
        if paged:
            st = tc.store
            pools = ((st.k_pages, st.v_pages, st.k_scale_pages,
                      st.v_scale_pages) if quant else (st.k_pages, st.v_pages))
            ctx_ops = (lambda i, pools=pools, st=st:
                       tuple(t[i] for t in pools) + (st.page_tables,))

            def node_keys(name, i, n, pools=pools, st=st):
                j = ("k_ctx", "v_ctx", "k_scale", "v_scale").index(name)
                return gather_pages(pools[j][i], st.page_tables[n:n + 1])[
                    0, :, :lens[n]]
        else:
            ctx_ops = ((lambda i, tc=tc: (tc.k_ctx[i], tc.v_ctx[i],
                                          tc.k_scale[i], tc.v_scale[i]))
                       if quant else (lambda i, tc=tc: (tc.k_ctx[i],
                                                        tc.v_ctx[i])))

            def node_keys(name, i, n, tc=tc):
                return getattr(tc, name)[i, n, :, :lens[n]]
        if quant:
            ctx_k = [torch.cat([_dequantized(node_keys("k_ctx", i, n),
                                             node_keys("k_scale", i, n))
                                for n in used], dim=1) for i in range(L)]
            ctx_v = [torch.cat([_dequantized(node_keys("v_ctx", i, n),
                                             node_keys("v_scale", i, n))
                                for n in used], dim=1) for i in range(L)]
            kds = [(kd[i].float() * scale).to(torch.bfloat16)
                   for i in range(L)]
            lib_scale = 1.0
        else:
            ctx_k = [torch.cat([node_keys("k_ctx", i, n) for n in used],
                               dim=1) for i in range(L)]
            ctx_v = [torch.cat([node_keys("v_ctx", i, n) for n in used],
                               dim=1) for i in range(L)]
            kds, lib_scale = kd, scale
        t_k = [torch.cat([ctx_k[i], kds[i]], dim=1)[None] for i in range(L)]
        t_v = [torch.cat([ctx_v[i], vd[i]], dim=1)[None] for i in range(L)]
        del ctx_k, ctx_v, kds
        kern = getattr(bd, kname)
        plain = getattr(bd, kname + "_plain")
        tkw = dict(scale=scale, c_d=t_cd, pn=p)
        pkw = dict(tkw, splits=default_splits(q))
        lens_arg = (tc.store.seg_lens,) if paged else ()

        def tree(i, kern=kern, ctx_ops=ctx_ops, kd=kd, vd=vd,
                 lens_arg=lens_arg):
            if lens_arg:     # paged: pools, tables, seg_lens, paths
                return kern(q, *ctx_ops(i), *lens_arg, path_rows, kd[i],
                            vd[i], t_bias, **tkw)
            return kern(q, *ctx_ops(i), path_rows, node_lens, kd[i], vd[i],
                        t_bias, **tkw)

        def tree_plain_(i, plain=plain, ctx_ops=ctx_ops, kd=kd, vd=vd,
                        lens_arg=lens_arg, pkw=pkw):
            if lens_arg:
                return plain(q, *ctx_ops(i), *lens_arg, path_rows, kd[i],
                             vd[i], t_bias, **pkw)
            return plain(q, *ctx_ops(i), path_rows, node_lens, kd[i], vd[i],
                         t_bias, **pkw)

        def tree_lib(i, t_k=t_k, t_v=t_v, mask=mask, lib_scale=lib_scale):
            return F.scaled_dot_product_attention(q4, t_k[i], t_v[i],
                                                  attn_mask=mask,
                                                  scale=lib_scale)

        ok, _, rel = within(tree_lib(0)[0], tree(0))
        print(f"time: library yardstick vs {kname} on the "
              f"{'paged ' if paged else ''}trie {rel:.2e} of max |out| "
              f"(gate 2e-2; {len(used)} referenced nodes, "
              f"{key_node.numel()} keys; decode arm ld {b * t_cd}, {n_live} "
              f"live slots)")
        check(ok, f"{kname}: library yardstick computes another function")
        # what the function needs: every referenced node's live keys read
        # once (K and V; int8 plus 8 bytes of scales per key and head),
        # the live decode slots and the bias, q and the output, the path
        # table and the lengths (and, paged, the page tables); the products
        # count each row's own path
        per_key = 2 * hd * (1 if quant else e) + (2 * 4 if quant else 0)
        nbytes = (2 * g * rows * hd * e + 2 * g * n_live * hd * e
                  + b * t_cd * 4 + g * key_node.numel() * per_key
                  + path_rows.numel() * 4 + node_lens.numel() * 4)
        if paged:
            nbytes += tc.store.page_tables.numel() * 4
        flop = 4 * g * p * (slot_keys + n_live) * hd
        entries.append(_timed_entry(
            kname, source, line, tree, tree_plain_, tree_lib, nbytes, flop,
            launches[kname], errs[kname], L, graph=True))

        def at_splits(S, kern=kern, ctx_ops=ctx_ops, kd=kd, vd=vd,
                      lens_arg=lens_arg):
            if lens_arg:
                return lambda i: kern(q, *ctx_ops(i), *lens_arg, path_rows,
                                      kd[i], vd[i], t_bias, **tkw, splits=S)
            return lambda i: kern(q, *ctx_ops(i), path_rows, node_lens,
                                  kd[i], vd[i], t_bias, **tkw, splits=S)

        where = f"{'paged ' if paged else ''}trie"
        split_sweep(f"{kname} {where}", at_splits, L, pkw["splits"])
        if not quant:
            merge_share(f"{kname} {where} S={pkw['splits']}", tree, L)
        del t_k, t_v
    return entries


def time_packed_kernels(cfg, pcaches, launches, errs):
    """#10 and #11 at phase 2's main packed shape over phase 3e's paged
    trie caches (7 live nodes on 88 pages of 128, their decode arms, 24
    layers cycled): the 64 decode rows and a 512-position chunk (1024 rows)
    under [SYS, TPL_A] at rows 300..811 of a random envelope from position
    6144. The yardstick: SDPA over [the referenced nodes' live keys ⊕ the
    envelope's live rows ⊕ the decode slots] under a boolean mask: a decode
    row sees the nodes on its path and its own live slots, a chunk row the
    chunk's ancestors and the envelope rows at or before its position."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.paged import gather_pages
    from repro_torch.kernels import bifurcated_decode as bd
    from repro_torch.kernels.ops import _decode_operands

    L, g, hd = cfg.n_layers, cfg.n_kv_heads, cfg.kq_dim
    p = cfg.n_heads // cfg.n_kv_heads
    scale, e = hd**-0.5, 2
    cp, buf, fpath = PACKED_CHUNK, PACKED_BUF, [0, 1]
    fs = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    fl = buf + cp
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    entries = []
    for quant in (False, True):
        kname = _packed_kname(quant)
        line = 1815 if quant else 1637
        tc = pcaches[quant][1]
        st = tc.store
        b, t_cd = tc.k_dec.shape[1:3]
        nd = b * p
        rows = nd + cp * p
        t_live = (torch.arange(t_cd, device=DEVICE)[None, :]
                  <= tc.dec_lens[:, None])
        arms = [_decode_operands(tc.k_dec[i], tc.v_dec[i], t_live)
                for i in range(L)]
        kd, vd = [a[0] for a in arms], [a[1] for a in arms]
        t_bias = arms[0][2]
        del arms
        q = torch.randn(g, rows, hd, generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        env_k = torch.randn(L, TREE_CAP, g, hd, generator=gen,
                            device=DEVICE).to(torch.bfloat16)
        env_v = torch.randn(L, TREE_CAP, g, hd, generator=gen,
                            device=DEVICE).to(torch.bfloat16)
        i32 = dict(dtype=torch.int32, device=DEVICE)
        depth = tc.paths.shape[0]
        n_segs = st.page_tables.shape[0]
        fp = torch.tensor(fpath + [-1] * (depth - len(fpath)) + [n_segs],
                          **i32)
        path_rows = torch.cat([
            torch.cat([tc.paths.repeat_interleave(p, dim=1),
                       torch.full((1, nd), -1, **i32)]),
            fp[:, None].expand(depth + 1, cp * p)], dim=1).contiguous()
        pos = fs + buf + torch.arange(cp, device=DEVICE)
        row_pos = torch.cat([torch.zeros(nd, **i32),
                             pos.to(torch.int32).repeat_interleave(p)])
        row_slot = torch.cat([torch.arange(nd, **i32) // p,
                              torch.full((cp * p,), -1, **i32)])
        pools = ((st.k_pages, st.v_pages, st.k_scale_pages,
                  st.v_scale_pages) if quant else (st.k_pages, st.v_pages))
        kern = getattr(bd, kname)
        plain = getattr(bd, kname + "_plain")
        kw = dict(fresh_len=fl, fresh_start=fs, scale=scale, c_d=t_cd, pn=p)

        def args(i, pools=pools, st=st, kd=kd, vd=vd, path_rows=path_rows,
                 row_pos=row_pos, row_slot=row_slot, env_k=env_k,
                 env_v=env_v):
            return ((q,) + tuple(t[i] for t in pools)
                    + (env_k[i], env_v[i], st.page_tables, st.seg_lens,
                       path_rows, row_pos, row_slot, kd[i], vd[i], t_bias))

        # the yardstick's keys, values and mask
        lens = st.seg_lens.tolist()
        used = sorted(set(tc.paths[tc.paths >= 0].tolist()) | set(fpath))
        key_node = torch.cat([torch.full((lens[n],), n, device=DEVICE)
                              for n in used])

        def node_keys(j, i, n, pools=pools, st=st):
            return gather_pages(pools[j][i], st.page_tables[n:n + 1])[
                0, :, :lens[n]]

        def ctx(j, i):
            if quant:
                return torch.cat([_dequantized(node_keys(j, i, n),
                                               node_keys(j + 2, i, n))
                                  for n in used], dim=1)
            return torch.cat([node_keys(j, i, n) for n in used], dim=1)

        # with int8 nodes the keys carry the logit scale: the envelope and
        # the decode keys get it too and SDPA scales by 1
        k_scale, lib_scale = (scale, 1.0) if quant else (1.0, scale)

        def scaled(x, k_scale=k_scale):
            return (x.float() * k_scale).to(torch.bfloat16)

        t_k = [torch.cat([ctx(0, i), scaled(env_k[i, :fl].transpose(0, 1)),
                          scaled(kd[i])], dim=1)[None] for i in range(L)]
        t_v = [torch.cat([ctx(1, i), env_v[i, :fl].transpose(0, 1), vd[i]],
                         dim=1)[None] for i in range(L)]
        dec_ok = ((torch.arange(nd, device=DEVICE)[:, None] // p
                   == torch.arange(b * t_cd, device=DEVICE)[None, :] // t_cd)
                  & t_live.reshape(1, b * t_cd))
        on_node = (path_rows[:depth, :, None] == key_node).any(0)
        causal = (fs + torch.arange(fl, device=DEVICE))[None, :] <= \
            row_pos[nd:, None]
        mask = torch.cat([
            torch.cat([on_node[:nd],
                       torch.zeros(nd, fl, dtype=torch.bool, device=DEVICE),
                       dec_ok], dim=1),
            torch.cat([on_node[nd:], causal,
                       torch.zeros(cp * p, b * t_cd, dtype=torch.bool,
                                   device=DEVICE)], dim=1)])
        q4 = q[None]

        # the plain versions at the kernels' default shares
        skw = {"splits": bd.packed_split_count(
            nd, cp * p, g, sms=bd._sm_count(q.device.index))}

        def packed(i, kern=kern, args=args, kw=kw):
            return kern(*args(i), **kw)

        def packed_plain_(i, plain=plain, args=args, kw=kw, skw=skw):
            return plain(*args(i), **kw, **skw)

        def packed_lib(i, t_k=t_k, t_v=t_v, mask=mask, lib_scale=lib_scale):
            return F.scaled_dot_product_attention(q4, t_k[i], t_v[i],
                                                  attn_mask=mask,
                                                  scale=lib_scale)

        ok, _, rel = within(packed_lib(0)[0], packed(0))
        print(f"time: library yardstick vs {kname} {rel:.2e} of max |out| "
              f"(gate 2e-2; {len(used)} referenced nodes, "
              f"{key_node.numel()} keys, {fl} envelope rows, decode arm ld "
              f"{b * t_cd}, {int(t_live.sum())} live slots)")
        check(ok, f"{kname}: library yardstick computes another function")
        # what the function needs: each referenced node's live keys once
        # (int8 plus 8 bytes of scales per key and head), the envelope's
        # live rows, the live decode slots and the bias, q and the output,
        # the row tables, page tables and lengths. Products: each decode
        # row over its path and its live slots; each chunk row over its
        # ancestors and the envelope rows at or before it
        per_key = 2 * hd * (1 if quant else e) + (2 * 4 if quant else 0)
        n_live = int(t_live.sum())
        slot_keys = sum(sum(lens[n] for n in tc.paths[:, s].tolist()
                            if n >= 0) for s in range(b))
        anc = sum(lens[n] for n in fpath)
        vis = sum(min(buf + j + 1, fl) for j in range(cp))
        nbytes = (2 * g * rows * hd * e + 2 * g * n_live * hd * e
                  + b * t_cd * 4 + g * key_node.numel() * per_key
                  + 2 * g * fl * hd * e
                  + (path_rows.numel() + 2 * rows) * 4
                  + st.page_tables.numel() * 4 + len(lens) * 4)
        flop = 4 * g * p * hd * (slot_keys + n_live + cp * anc + vis)
        entries.append(_timed_entry(
            kname, "packed_decode.cu", line, packed, packed_plain_,
            packed_lib, nbytes, flop, launches[kname], errs[kname], L,
            graph=True))
        sd, sc = skw["splits"]
        at = (lambda S, kern=kern, args=args, kw=kw: (
            lambda i: kern(*args(i), **kw, splits=S)))
        split_sweep(f"{kname} main", at, L, (sd, sc),
                    shares=(1, 2, 4, 8, 16, 32))
        split_sweep(f"{kname} main, the chunk tiles' S at the decode "
                    f"tiles' {sd}", at, L, (sd, sc),
                    shares=tuple((sd, c) for c in (2, 4, 8, 16, 32)))
        merge_share(f"{kname} main S=({sd}, {sc})", packed, L)
        host_us("time", kname, lambda S, at=at: at(S)(0), (sd, sc))
        del t_k, t_v, env_k, env_v
    return entries


def time_flash_kernel(launches, errs):
    """#12 at the main prefill shape (b 1, n 8192, h 16, g 8, hd 128,
    causal) and at phase 3h's revival (A2's 500 tokens at q_offset 6144
    over 6644 keys), beside its bound, its plain version and one
    scaled_dot_product_attention call computing the same function (the
    main shape causal; the suffix with an explicit boolean mask, since
    SDPA's is_causal aligns top-left when n != m)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp

    anc = TREE_TOKENS["SYS"] + TREE_TOKENS["TPL_A"]
    suf = TREE_TOKENS["A2"]
    entries = []
    for name, (n, m, off) in (("main prefill", (CONTEXT, CONTEXT, 0)),
                              ("suffix", (suf, anc + suf, anc))):
        b, h, g, hd = 1, 16, 8, 128
        # 3 input sets: 100 MB each at the main shape, so L2 holds none
        xs = [flash_inputs(b, n, m, h, g, hd, seed=80 + i) for i in range(3)]
        mask = (torch.arange(m, device=DEVICE)[None, :]
                <= off + torch.arange(n, device=DEVICE)[:, None])

        def kern(i, xs=xs, off=off):
            return fp.flash_prefill_attention(*xs[i], q_offset=off)

        def plain(i, xs=xs, off=off):
            return fp.flash_prefill_attention_plain(*xs[i], q_offset=off)

        def lib(i, xs=xs, mask=mask, n=n, m=m):
            q, k, v = (t.transpose(1, 2) for t in xs[i])
            if n == m:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        ok, _, rel = within(lib(0).transpose(1, 2), kern(0))
        print(f"time: library yardstick vs flash_prefill_attention ({name}) "
              f"{rel:.2e} of max |out| (gate 2e-2)")
        check(ok, "flash_prefill_attention: library yardstick computes "
                  "another function")
        # q and the output, k and v once; 4 hd operations per (query head,
        # visible key): each row i sees keys 0..off + i
        pairs = n * off + n * (n + 1) // 2
        nbytes = 2 * b * n * h * hd * 2 + 2 * b * m * g * hd * 2
        flop = 4 * hd * b * h * pairs
        print(f"time: flash_prefill_attention at the {name} shape (b={b} "
              f"n={n} m={m} h={h} g={g} hd={hd} q_offset={off})")
        entries.append(_timed_entry(
            "flash_prefill_attention", "flash_prefill.cu", 108, kern, plain,
            lib, nbytes, flop, launches, errs["flash_prefill_attention"], 3,
            module="flash_prefill.py"))
        del xs
    # one JSON entry per kernel: its main path's prefill shape; the
    # suffix's times are printed above
    return entries[:1]


def time_chunked_kernel(calls, launches, err, chunk=SSM_CHUNK,
                        normalize=False, name="chunked_linear_attention"):
    """#13 on a serve phase's recorded inputs (three layers of its prefill:
    3i's Mamba2 layers, q and k the model's head-broadcast views; 3k's
    mLSTM layers, normalised, the wide path) beside its bound and its plain
    version; no one PyTorch call computes chunked linear attention, so the
    library column is null. At the narrow kernel's shape, a sweep over the
    CTAs an SM holds."""
    import torch
    from repro_torch.kernels import chunked_linear as cl

    kw = dict(chunk=chunk, normalize=normalize)

    def kern(i):
        return cl.chunked_linear_attention(*calls[i], **kw)

    def plain(i):
        return cl.chunked_linear_attention_plain(*calls[i], **kw)

    q, k, v, a = calls[0]
    b, n, H, dk = q.shape
    dv = v.shape[-1]
    dv_s = dv + normalize            # the state's columns
    qk_heads = 1 if q.stride(2) == 0 else H
    # the bytes as the model hands them: q and k (head-broadcast views read
    # once), v and the output, the log-decay, the final state
    nbytes = (2 * b * n * qk_heads * dk * 2 + 2 * b * n * H * dv * 2
              + b * n * H * 4 + b * H * dk * dv_s * 4)
    # per chunk of C: q.k^T and P.v over the causal half (C^2 (dk + dv)),
    # q.S and the state update (2 C dk dv each); 2 operations a product
    n_chunks = -(-n // chunk)
    c = min(chunk, n)
    flop = b * H * n_chunks * (c * c * (dk + dv_s) + 4 * c * dk * dv_s)
    print(f"time: {name} (b={b} n={n} H={H} dk={dk} dv={dv} normalize="
          f"{normalize} chunk={chunk}, q/k strides {tuple(q.stride())}; no "
          f"library call computes it)")
    entry = _timed_entry(name, "chunked_linear.cu", 83, kern, plain, None,
                         nbytes, flop, launches, err, len(calls),
                         module="chunked_linear.py")
    print(f"time: {name}: {flop / entry['ms'] / 1e9:.1f} TFLOP/s of its "
          f"{flop / 1e9:.2f} GFLOP")
    if max(dk, dv_s) > cl.KERNEL_MAX_DIM:
        return entry
    # the narrow design's one free parameter: the CTAs an SM holds (the
    # bits do not move with it)
    out, st = kern(0)
    times = {}
    for cap in (1, 2, 3, None):
        o, s = cl.chunked_linear_attention(*calls[0], ctas_per_sm=cap, **kw)
        check(bool(torch.equal(o, out) and torch.equal(s, st)),
              f"#13's bits move with ctas_per_sm={cap}")
        times[cap] = (cl.occupancy(dk, dv, chunk, cap), time_ms(
            lambda i, cap=cap: cl.chunked_linear_attention(
                *calls[i], ctas_per_sm=cap, **kw), len(calls)))
    print("time (occupancy sweep): chunked_linear_attention, CTAs an SM "
          "(ctas_per_sm cap): " + ", ".join(
              f"{occ}{' (default)' if cap is None else f' (cap {cap})'} "
              f"{t * 1e3:.1f} us" for cap, (occ, t) in times.items()))
    return entry


def time_hybrid_decode(cfg_h, attn, attn_q8):
    """#1 and #3 at the hybrid's shape (32 kv heads of hd 112, p 1, 32
    rows, m_c 8192, 32 x 24 decode slots) over phase 3i's 13 served context
    caches (printed; the JSON entries of #1/#3 are phase 3's shape)."""
    time_decode_at("the hybrid's shape", cfg_h.n_heads // cfg_h.n_kv_heads,
                   attn, attn_q8)


def time_decode_shape(key, cfg, attn, attn_q8, out):
    """#1 and #3 at one of phase 3l's shapes (``key`` "p6": dbrx's and
    internvl2's 6 query heads per kv head, 192 rows, hd 128; "hd64":
    whisper's decoder, g 16, p 1, hd 64) over the model's served caches:
    their JSON entries, named by shape, with the launches and errors of
    phase 3l's runs."""
    g, hd = cfg.n_kv_heads_padded, cfg.kq_dim
    p = cfg.n_heads_padded // g
    label = f"g {g}, p {p}: {BATCH * p} rows, hd {hd}, m_c {attn.context_len}"
    return time_decode_at(
        label, p, attn, attn_q8,
        launches=(out["launches"][(key, False)], out["launches"][(key, True)]),
        errs=(out["errs"][(key, False)], out["errs"][(key, True)]),
        sweep=False)


def time_decode_at(label, p, attn, attn_q8, launches=None, errs=None,
                   sweep=True):
    """#1 and #3 over a served model's context caches (``attn``,
    ``attn_q8``; one input set a layer), 32 x 24 decode slots, graph-timed
    at their default split beside their bounds, plain versions at the same
    S and SDPA yardsticks; with ``sweep``, a sweep over S and the merge's
    share. Returns their entries (``launches`` and ``errs``: (#1, #3);
    None: the entries are printed only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bifurcated_decode as bd

    L, g, m_c, hd = attn.k_ctx.shape
    b, c_d = BATCH, attn.decode_capacity
    rows, ld = b * p, b * c_d
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    q = torch.randn(g, rows, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    kd, vd, bias, live = _decode_arm_operands(L, g, b, c_d, hd, seed=13)
    scale = hd**-0.5
    fkw = dict(scale=scale, c_d=c_d, pn=p)
    skw = {"splits": default_splits(q)}
    row_s = torch.arange(rows, device=DEVICE)[:, None] // p
    col_s = torch.arange(ld, device=DEVICE)[None, :] // c_d
    mask = torch.cat([torch.ones(rows, m_c, dtype=torch.bool, device=DEVICE),
                      (row_s == col_s) & live.reshape(1, ld)], dim=1)
    n_live = int(live.sum())
    io_bytes = 2 * g * rows * hd * 2 + 2 * g * n_live * hd * 2 + ld * 4
    flop = 4 * g * rows * m_c * hd + 4 * g * p * n_live * hd
    kc, vc = attn.k_ctx, attn.v_ctx
    kq, vq, ks, vs = (attn_q8.k_ctx, attn_q8.v_ctx, attn_q8.k_scale,
                      attn_q8.v_scale)
    k_all = [torch.cat([kc[i], kd[i]], dim=1)[None] for i in range(L)]
    v_all = [torch.cat([vc[i], vd[i]], dim=1)[None] for i in range(L)]
    kq_all = [torch.cat([_dequantized(kq[i], ks[i]),
                         (kd[i].float() * scale).to(torch.bfloat16)],
                        dim=1)[None] for i in range(L)]
    vq_all = [torch.cat([_dequantized(vq[i], vs[i]), vd[i]], dim=1)[None]
              for i in range(L)]
    cases = (
        ("fused_bifurcated_decode", "bifurcated_decode.cu", 206,
         lambda i, S=None: bd.fused_bifurcated_decode(
             q, kc[i], vc[i], kd[i], vd[i], bias, **fkw, splits=S),
         lambda i: bd.fused_bifurcated_decode_plain(q, kc[i], vc[i], kd[i],
                                                    vd[i], bias, **fkw, **skw),
         lambda i: F.scaled_dot_product_attention(
             q[None], k_all[i], v_all[i], attn_mask=mask, scale=scale),
         io_bytes + 2 * g * m_c * hd * 2),
        ("fused_bifurcated_decode_q8", "forest_q8_decode.cu", 350,
         lambda i, S=None: bd.fused_bifurcated_decode_q8(
             q, kq[i], vq[i], ks[i], vs[i], kd[i], vd[i], bias, **fkw,
             splits=S),
         lambda i: bd.fused_bifurcated_decode_q8_plain(
             q, kq[i], vq[i], ks[i], vs[i], kd[i], vd[i], bias, **fkw, **skw),
         lambda i: F.scaled_dot_product_attention(
             q[None], kq_all[i], vq_all[i], attn_mask=mask, scale=1.0),
         io_bytes + 2 * g * m_c * hd + 2 * g * m_c * 4))
    entries = []
    for j, (name, source, line, kern, plain, lib, nbytes) in enumerate(cases):
        ok, _, rel = within(lib(0)[0], kern(0))
        ok_p, err, rel_p = within(kern(0), plain(0))
        print(f"time: {name} at {label} (g={g} rows={rows} hd={hd} m_c={m_c}"
              f" ld={ld}, {n_live} live slots): library yardstick vs kernel "
              f"{rel:.2e}, kernel vs plain {rel_p:.2e} of max |out| (gate "
              f"2e-2)")
        check(ok and ok_p, f"{name} at {label}: yardstick or kernel wrong")
        entry = _timed_entry(
            f"{name} ({label})" if launches else name, source, line, kern,
            plain, lib, nbytes, flop, launches[j] if launches else 0,
            max(errs[j], err) if errs else 0.0, L, graph=True)
        if launches:
            entries.append(entry)
        if sweep:
            split_sweep(f"{name} hd {hd}", lambda S, kern=kern: (
                lambda i: kern(i, S)), L, skw["splits"])
            merge_share(f"{name} hd {hd} S={skw['splits']}", kern, L)
    return entries


def time_flash_families(out):
    """#12 at phase 3l's shapes: mixtral's windowed prefill (b 1, n 8192,
    h 32, g 8, hd 128, causal, window 4096) and whisper's non-causal
    encoder (b 1, n = m = 8192, h = g = 16, hd 64), beside their bounds,
    plain versions and one scaled_dot_product_attention call (a boolean
    mask for the window). Returns their JSON entries, named by shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp

    entries = []
    cases = (("window", "mixtral: causal, window 4096, h 32, g 8, hd 128",
              (1, CONTEXT, CONTEXT, 32, 8, 128), True, 4096),
             ("noncausal", "whisper: non-causal, h = g = 16, hd 64",
              (1, CONTEXT, CONTEXT, 16, 16, 64), False, 0))
    for key, label, (b, n, m, h, g, hd), causal, window in cases:
        xs = [flash_inputs(b, n, m, h, g, hd, seed=90 + i) for i in range(3)]
        kw = dict(causal=causal, window=window)
        qp = torch.arange(n, device=DEVICE)[:, None]
        kp = torch.arange(m, device=DEVICE)[None, :]
        mask = (kp <= qp) & (kp > qp - window) if window else None

        def kern(i, xs=xs, kw=kw):
            return fp.flash_prefill_attention(*xs[i], **kw)

        def plain(i, xs=xs, kw=kw):
            return fp.flash_prefill_attention_plain(*xs[i], **kw)

        def lib(i, xs=xs, mask=mask):
            q, k, v = (t.transpose(1, 2) for t in xs[i])
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        ok_l, _, rel_l = within_rows(lib(0).transpose(1, 2), kern(0))
        ok, err, rel = within_rows(kern(0), plain(0))
        print(f"time: flash_prefill_attention at {label} (b={b} n={n} m={m})"
              f": library yardstick vs kernel worst row {rel_l:.2e}, kernel "
              f"vs plain worst row {rel:.2e} (gate 2e-2)")
        check(ok and ok_l, f"#12 at {label}: yardstick or kernel wrong")
        if window:     # row i sees keys max(0, i - window + 1)..i
            i = torch.arange(n, dtype=torch.float64)
            pairs = int(torch.minimum(i + 1, torch.full_like(i, window)).sum())
        else:
            pairs = n * m
        nbytes = 2 * b * n * h * hd * 2 + 2 * b * m * g * hd * 2
        flop = 4 * hd * b * h * pairs
        entries.append(_timed_entry(
            f"flash_prefill_attention ({label})", "flash_prefill.cu", 108,
            kern, plain, lib, nbytes, flop, out["launches"][key],
            max(out["errs"].get(key, 0.0), err), 3,
            module="flash_prefill.py"))
        del xs
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
    laps = [t_start]

    def lap(what):      # one line per phase: where the time limit goes
        laps.append(time.perf_counter())
        print(f"elapsed: {what} {laps[-1] - laps[-2]:.1f} s")

    card = CARD[0] = card_line()
    print(card)
    build()
    lap("phase 1 (build)")
    errs = check_kernels()
    lap("phase 2")
    cfg, model, params, ctx, tokens, cache, launches = serve()
    q8cache, launches["fused_bifurcated_decode_q8"], q8tokens = serve_int8(
        cfg, model, params, ctx, tokens, cache)
    fcaches, tcaches, fouts, touts = {}, {}, {}, {}
    for quant, kname in ((False, "grouped_fused_bifurcated_decode"),
                         (True, "grouped_fused_bifurcated_decode_q8")):
        fcaches[quant], launches[kname], path_err, fouts[quant] = \
            serve_forest(cfg, model, params, quant)
        errs[kname] = max(errs[kname], path_err)
    for quant, kname in ((False, "tree_fused_bifurcated_decode"),
                         (True, "tree_fused_bifurcated_decode_q8")):
        tcaches[quant], launches[kname], path_err, touts[quant] = \
            serve_tree(cfg, model, params, quant)
        errs[kname] = max(errs[kname], path_err)
    pcaches = {}
    for quant in (False, True):
        kname = _paged_kname(quant)
        single, launches[kname], e1 = serve_paged_single(
            cfg, model, params, ctx, q8tokens if quant else tokens,
            q8cache if quant else cache, tokens, quant)
        _, e2 = serve_paged_forest(cfg, model, params, quant, fouts[quant])
        trie, _, e3 = serve_paged_tree(cfg, model, params, quant,
                                       touts[quant])
        pcaches[quant] = (single, trie)
        errs[kname] = max(errs[kname], e1, e2, e3)
    lap("phases 3-3e")
    for quant in (False, True):
        kname = _packed_kname(quant)
        launches[kname], _, e4, _ = serve_packed(cfg, model, params, quant)
        errs[kname] = max(errs[kname], e4)
    lap("phase 3f")
    launches["flash_prefill_attention"] = serve_flash(cfg, params, ctx)
    for store in ("dense", "paged"):
        for quant in (False, True):
            serve_prefix_cache(cfg, params, store, quant)
    lap("phases 3g-3h")
    serve_durable(cfg, params)
    lap("phase 3j")
    # phase 4 for #1-#12 on phase 3's caches, which are then freed with
    # phase 3's model to make room for the hybrid's
    del model, params
    entries = time_kernels(cfg, cache, q8cache, fcaches, tcaches, pcaches,
                           launches, errs)
    entries += time_packed_kernels(cfg, pcaches, launches, errs)
    entries += time_flash_kernel(launches["flash_prefill_attention"], errs)
    lap("phase 4")
    del cache, q8cache, fcaches, tcaches, pcaches
    gc.collect()
    torch.cuda.empty_cache()
    hyb = serve_hybrid()
    errs["chunked_linear_attention"] = max(errs["chunked_linear_attention"],
                                           hyb["err"])
    entries.append(time_chunked_kernel(
        hyb["calls"], hyb["launches"]["chunked_linear_attention"],
        errs["chunked_linear_attention"]))
    from repro_torch.configs import get_config
    time_hybrid_decode(get_config("zamba2-7b"), hyb["attn"], hyb["attn_q8"])
    lap("phases 3i-4i")
    del hyb
    gc.collect()
    torch.cuda.empty_cache()
    xl = serve_xlstm()
    entries.append(time_chunked_kernel(
        xl["calls"], xl["launches"],
        max(errs["chunked_linear_attention_wide"], xl["err"]),
        chunk=get_config("xlstm-1.3b").ssm.chunk, normalize=True,
        name="chunked_linear_attention (wide: mLSTM, dk 1024, dv 1024 + 1)"))
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 3k-4k")
    entries += serve_families()
    lap("phase 3l")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
