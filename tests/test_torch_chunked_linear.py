"""Port parity for kernel #13's function, chunked scalar-decay linear
attention: its plain version (what the wrapper runs on CPU tensors) against
the reference's Pallas kernel in interpret mode over the reference's own
CHUNK_SWEEP (tests/test_kernels.py) at the reference's tolerances (fp32
1e-4, bf16 5e-2), against the sequential recurrence, and the port's
``models/linear_scan`` functions against JAX's on the same numpy-seeded
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np, to_torch
from repro.kernels.chunked_linear import chunked_linear_attention_kernel
from repro.models import linear_scan as jls
from repro_torch.kernels import chunked_linear as tcl
from repro_torch.models import linear_scan as tls

# (b, n, H, dk, dv, chunk, normalize): the reference's CHUNK_SWEEP
CHUNK_SWEEP = [
    (2, 50, 3, 8, 8, 16, False),
    (1, 64, 2, 16, 16, 16, True),    # mLSTM-style with normalizer
    (2, 100, 4, 32, 16, 32, False),  # Mamba2-style, dk != dv
    (3, 33, 1, 8, 8, 8, True),       # ragged n
]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(case, dtype="float32"):
    """numpy q, k, v (rounded to ``dtype``) and a <= 0, as the reference's
    test makes them."""
    b, n, H, dk, dv, _, _ = case
    rng = np.random.RandomState(sum(case))
    cast = lambda x: np.asarray(jnp.asarray(x, jnp.dtype(dtype)))  # noqa: E731
    return (cast(rng.randn(b, n, H, dk)), cast(rng.randn(b, n, H, dk)),
            cast(rng.randn(b, n, H, dv)),
            (-np.abs(rng.randn(b, n, H)) * 0.3).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CHUNK_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(case, dtype):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    kernel in interpret mode: output (in v's dtype) and final state."""
    chunk, normalize = case[5], case[6]
    x = _inputs(case, dtype)
    out_j, st_j = chunked_linear_attention_kernel(
        *map(jnp.asarray, x), chunk=chunk, normalize=normalize, interpret=True)
    n0 = tcl.chunked_linear_attention.launches
    out_t, st_t = tcl.chunked_linear_attention(*map(to_torch, x), chunk=chunk,
                                               normalize=normalize)
    assert tcl.chunked_linear_attention.launches == n0   # CPU: no launch
    assert out_t.dtype == to_torch(x[2]).dtype and st_t.dtype == torch.float32
    assert tuple(out_t.shape) == out_j.shape and tuple(st_t.shape) == st_j.shape
    _close(out_t, out_j, TOL[dtype])
    _close(st_t, st_j, 2 * TOL[dtype])


@pytest.mark.parametrize("case", CHUNK_SWEEP)
def test_plain_version_matches_sequential_recurrence(case):
    """fp32, against the reference's own oracle (one token at a time)."""
    chunk, normalize = case[5], case[6]
    x = _inputs(case)
    out_r, st_r = jls.reference_linear_attention(*map(jnp.asarray, x),
                                                 normalize=normalize)
    out_t, st_t = tcl.chunked_linear_attention_plain(
        *map(to_torch, x), chunk=chunk, normalize=normalize)
    _close(out_t, out_r, 1e-4)
    _close(st_t, st_r, 2e-4)
    # and the port's own copy of the oracle against the reference's
    out_p, st_p = tls.reference_linear_attention(*map(to_torch, x),
                                                 normalize=normalize)
    _close(out_p, out_r, 1e-5)
    _close(st_p, st_r, 1e-5)


@pytest.mark.parametrize("case", CHUNK_SWEEP)
def test_linear_scan_with_initial_state_matches_jax(case):
    """models/linear_scan.chunked_linear_attention from a given state,
    fp32, against the reference's (its Pallas kernel has no initial
    state; the port's kernel takes one)."""
    b, _, H, dk, dv, chunk, normalize = case
    x = _inputs(case)
    s0 = np.random.RandomState(7).randn(
        b, H, dk, dv + (1 if normalize else 0)).astype(np.float32)
    out_j, st_j = jls.chunked_linear_attention(
        *map(jnp.asarray, x), chunk=chunk, normalize=normalize,
        initial_state=jnp.asarray(s0))
    out_t, st_t = tls.chunked_linear_attention(
        *map(to_torch, x), chunk=chunk, normalize=normalize,
        initial_state=to_torch(s0))
    _close(out_t, out_j, 1e-4)
    _close(st_t, st_j, 1e-4)


@pytest.mark.parametrize("normalize", [False, True])
def test_linear_attention_decode_matches_jax(normalize):
    """Five one-token steps from a random state, fp32: outputs and states
    at 1e-5; the port's state is updated in place."""
    rng = np.random.RandomState(3)
    b, H, dk, dv = 2, 3, 8, 6
    s_j = jnp.asarray(rng.randn(b, H, dk, dv + normalize).astype(np.float32))
    s_t = to_torch(np.asarray(s_j))
    for _ in range(5):
        q, k = (rng.randn(b, H, dk).astype(np.float32) for _ in range(2))
        v = rng.randn(b, H, dv).astype(np.float32)
        a = (-np.abs(rng.randn(b, H)) * 0.5).astype(np.float32)
        o_j, s_j = jls.linear_attention_decode(*map(jnp.asarray, (q, k, v, a)),
                                               s_j, normalize=normalize)
        o_t, s_new = tls.linear_attention_decode(*map(to_torch, (q, k, v, a)),
                                                 s_t, normalize=normalize)
        assert s_new is s_t
        _close(o_t, o_j, 1e-5)
        _close(s_t, s_j, 1e-5)


def test_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 2, 4)
    v = torch.zeros(1, 8, 2, 3)
    a = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError):          # log_decay of the wrong shape
        tcl.chunked_linear_attention(q, q, v, a[:, :4])
    with pytest.raises(ValueError):          # initial state of the wrong shape
        tcl.chunked_linear_attention(q, q, v, a, initial_state=torch.zeros(1, 2, 4, 4))
    with pytest.raises(TypeError):           # mixed dtypes
        tcl.chunked_linear_attention(q, q.bfloat16(), v, a)
