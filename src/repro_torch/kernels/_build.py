"""Build and load the CUDA kernels of the port.

``library()`` compiles each source of ``SOURCES`` (``csrc/*.cu``, sharing
the helpers of ``csrc/decode_common.cuh``) with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/kernels/`` at
the root of the checkout, and loads them with ``ctypes``. The sources
compile in parallel, one ``nvcc`` each, all started together. A library's
file name carries a hash of its source, the shared header and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
The compiler's report (registers, shared memory, spills per kernel) is
kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import types

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
HEADERS = (CSRC / "decode_common.cuh",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# library name -> {C function: argtypes}; each C function returns the CUDA
# error of its launch (0 when it was accepted)
SIGNATURES = {
    "bifurcated_decode": {
        # q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out, part (split scratch
        # or NULL), g, rows, m_c, ld, hd, c_d, pn, splits, max_pieces,
        # scale, stream
        "fused_bifurcated_decode": [_P] * 8 + [_I] * 9 + [_F, _P],
        # q, k_ctx, v_ctx, acc, m, l, part (split scratch or NULL), g,
        # rows, m_c, hd, splits, max_pieces, scale, stream
        "context_flash_partials": [_P] * 7 + [_I] * 6 + [_F, _P],
    },
    "forest_q8_decode": {
        # q, k_ctx, v_ctx, k_scale, v_scale, k_dec, v_dec, dec_bias, out,
        # part (split scratch or NULL), g, rows, m_c, ld, hd, c_d, pn,
        # splits, max_pieces, scale, stream
        "fused_bifurcated_decode_q8": [_P] * 10 + [_I] * 9 + [_F, _P],
        # q, k_ctx, v_ctx, row_group, ctx_lens, k_dec, v_dec, dec_bias, out,
        # part (split scratch or NULL), n_groups, g, rows, m_c, ld, hd, c_d,
        # pn, splits, max_pieces, scale, stream
        "grouped_fused_bifurcated_decode": [_P] * 10 + [_I] * 10 + [_F, _P],
        # q, k_ctx, v_ctx, k_scale, v_scale, row_group, ctx_lens, k_dec,
        # v_dec, dec_bias, out, part (split scratch or NULL), n_groups, g,
        # rows, m_c, ld, hd, c_d, pn, splits, max_pieces, scale, stream
        "grouped_fused_bifurcated_decode_q8": [_P] * 12 + [_I] * 10 + [_F, _P],
    },
    "tree_decode": {
        # q, k_ctx, v_ctx, paths, node_lens, k_dec, v_dec, dec_bias, out,
        # part (split scratch or NULL), n_nodes, depth, g, rows, m_c, ld,
        # hd, c_d, pn, splits, max_pieces, scale, stream
        "tree_fused_bifurcated_decode": [_P] * 10 + [_I] * 11 + [_F, _P],
        # q, k_ctx, v_ctx, k_scale, v_scale, paths, node_lens, k_dec, v_dec,
        # dec_bias, out, part (split scratch or NULL), n_nodes, depth, g,
        # rows, m_c, ld, hd, c_d, pn, splits, max_pieces, scale, stream
        "tree_fused_bifurcated_decode_q8": [_P] * 12 + [_I] * 11 + [_F, _P],
    },
    "paged_decode": {
        # q, k_pages, v_pages, page_tables, seg_lens, paths, k_dec, v_dec,
        # dec_bias, out, part (split scratch or NULL), n_pages, n_segs, ppn,
        # page_m, depth, g, rows, ld, hd, c_d, pn, splits, max_pieces,
        # scale, stream
        "paged_fused_bifurcated_decode": [_P] * 11 + [_I] * 13 + [_F, _P],
        # q, k_pages, v_pages, k_scale_pages, v_scale_pages, page_tables,
        # seg_lens, paths, k_dec, v_dec, dec_bias, out, part (split scratch
        # or NULL), n_pages, n_segs, ppn, page_m, depth, g, rows, ld, hd,
        # c_d, pn, splits, max_pieces, scale, stream
        "paged_fused_bifurcated_decode_q8": [_P] * 13 + [_I] * 13 + [_F, _P],
    },
    "packed_decode": {
        # q, k_pages, v_pages, k_fresh, v_fresh, page_tables, seg_lens,
        # paths, row_pos, row_slot, k_dec, v_dec, dec_bias, out, part (split
        # scratch or NULL), n_pages, n_segs, ppn, page_m, depth, g, rows,
        # n_dec, ld, hd, c_d, pn, fresh_len, fresh_start, splits,
        # splits_chunk, max_pieces, max_pieces_chunk, scale, stream
        "packed_fused_bifurcated_decode": [_P] * 15 + [_I] * 18 + [_F, _P],
        # q, k_pages, v_pages, k_scale_pages, v_scale_pages, then as above
        # from k_fresh
        "packed_fused_bifurcated_decode_q8": [_P] * 17 + [_I] * 18 + [_F, _P],
    },
    "flash_prefill": {
        # q, k, v, out, part, b, n, m, h, g, hd, q_offset, window, causal,
        # splits, scale, stream
        "flash_prefill_attention": [_P] * 5 + [_I] * 10 + [_F, _P],
    },
    "chunked_linear": {
        # q, k, v, log_decay, s0, out, s_out, sync, the strides (batch,
        # position, head) of q, k and v, b, n, H, dk, dv, d, chunk,
        # ctas_per_sm, stream
        "chunked_linear_attention": [_P] * 8 + [_L] * 9 + [_I] * 8 + [_P],
        # d, chunk, ctas_per_sm, out (one int32)
        "chunked_linear_occupancy": [_I] * 3 + [_P],
        # the wide path's two launches, the same arguments: q, k, v,
        # log_decay, s0, scores, out, s_out, sync, the strides (batch,
        # position, head) of q, k and v, b, n, H, dk, dv, chunk, stream
        "chunked_linear_scores": [_P] * 9 + [_L] * 9 + [_I] * 6 + [_P],
        "chunked_linear_wide": [_P] * 9 + [_L] * 9 + [_I] * 6 + [_P],
    },
}
SOURCES = {name: CSRC / f"{name}.cu" for name in SIGNATURES}

_LIB = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library is not built yet, all in
    parallel; return {library name: path}. Raises if any build fails."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (cmd, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        out = todo[name]
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout
                                           + stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{stderr[-4000:]}")
        else:
            os.replace(tmp, out)  # atomic: no reader sees a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library() -> types.SimpleNamespace:
    """Every C function of the kernel libraries, as attributes of one
    namespace, built first if needed. Raises when no CUDA device is present
    or a library cannot be built."""
    global _LIB
    if _LIB is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        fns = {}
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fn_name] = fn
        _LIB = types.SimpleNamespace(**fns)
    return _LIB
