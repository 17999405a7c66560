"""Helpers for the port's parity tests (tests/test_torch_*.py): the same
numpy arrays go to the JAX reference and to its PyTorch counterpart.

Tolerances are the reference tests' own: fp32 results agree to 1e-5, bf16
results to 2e-2 (bf16 keeps 8 mantissa bits, and the two frameworks round
intermediates at different places)."""
import numpy as np
import torch

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the port's CPU tests run beside the JAX tests in the same workers: one
# intra-op thread keeps torch from competing with them for the cores
torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor of the same dtype (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_np(x) -> np.ndarray:
    """tensor or JAX array -> float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_close(got, want, dtype_name):
    tol = TOL[dtype_name]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def assert_close_logits(got, want, dtype_name):
    """Logits of a whole model: fp32 elementwise to 1e-5; bf16 to 2e-2 of
    the largest logit. In bf16 the two frameworks' float32 transcendentals
    (rope's sin/cos, rsqrt, exp) differ in the last bit and now and then
    round a bf16 activation the other way; over the layers that moves a
    logit near zero by more than 2e-2 while the largest are ~4."""
    if dtype_name == "float32":
        return assert_close(got, want, dtype_name)
    g, w = to_np(got), to_np(want)
    live = np.abs(w) < 1e29          # padded-vocab entries are -1e30 in both
    assert np.array_equal(live, np.abs(g) < 1e29)
    err = np.max(np.abs(g[live] - w[live]))
    assert err <= TOL[dtype_name] * np.max(np.abs(w[live])), err
