"""Build and load the CUDA kernels of the port.

``library()`` compiles ``csrc/bifurcated_decode.cu`` with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/kernels/`` at the root of the checkout, and loads it with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. The compiler's report (registers, shared memory, spills per kernel)
is kept beside the library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bifurcated_decode.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # q, k_ctx, v_ctx, k_dec, v_dec, dec_bias, out,
    # g, rows, m_c, ld, hd, c_d, pn, scale, dtype, stream
    "fused_bifurcated_decode": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    # q, k_ctx, v_ctx, acc, m, l, g, rows, m_c, hd, scale, dtype, stream
    "context_flash_partials": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
}

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


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"bifurcated_decode-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source if its library is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed. Raises when no
    CUDA device is present or the library cannot be built."""
    global _LIB
    if _LIB is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
