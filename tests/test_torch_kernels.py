"""Port parity: the decode kernels' plain PyTorch versions and the
``ops.bifurcated_decode_attention`` dispatcher against the JAX reference's
Pallas kernels in interpret mode, on the same numpy inputs; plus the
wrappers' dispatch rules (CPU tensors -> plain version, CUDA tensors ->
kernel or raise, never a fallback)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_torch
from repro.kernels import bifurcated_decode as jbd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

G, HD = 2, 16
DTYPES = ["float32", "bfloat16"]
# (b, p, n, m_c, c_d, block_m): ragged m_c over several blocks, decode arm
# lengths b*c_d that the reference pads to a lane multiple, p > 1, n > 1
CASES = [
    (3, 2, 1, 300, 5, 128),
    (2, 1, 2, 64, 4, 512),
    (4, 2, 2, 200, 3, 128),
]


def _kernel_inputs(b, p, n, m_c, c_d, dtype, seed=0):
    rng = np.random.RandomState(seed)
    rows, ld = b * p * n, b * c_d
    arrs = {
        "q": rng.randn(G, rows, HD), "kc": rng.randn(G, m_c, HD),
        "vc": rng.randn(G, m_c, HD), "kd": rng.randn(G, ld, HD),
        "vd": rng.randn(G, ld, HD),
    }
    arrs = {k: np.asarray(jnp.asarray(v, dtype)) for k, v in arrs.items()}
    lens = rng.randint(1, c_d + 1, size=b)  # every sample has >= 1 live slot
    live = (np.arange(c_d)[None, :] < lens[:, None]).reshape(1, ld)
    arrs["bias"] = np.where(live, 0.0, -1e30).astype(np.float32)
    return arrs


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_matches_pallas(case, dtype):
    b, p, n, m_c, c_d, block_m = case
    a = _kernel_inputs(b, p, n, m_c, c_d, dtype)
    scale = HD**-0.5
    want = jbd.fused_bifurcated_decode(
        *(jnp.asarray(a[k]) for k in ("q", "kc", "vc", "kd", "vd", "bias")),
        scale=scale, c_d=c_d, pn=p * n, block_m=block_m, interpret=True)
    got = tbd.fused_bifurcated_decode_plain(
        *(to_torch(a[k]) for k in ("q", "kc", "vc", "kd", "vd", "bias")),
        scale=scale, c_d=c_d, pn=p * n, block_m=block_m)
    assert got.dtype == to_torch(a["q"]).dtype
    assert_close(got, want, dtype)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_context_partials_plain_matches_pallas(case, dtype):
    b, p, n, m_c, c_d, block_m = case
    a = _kernel_inputs(b, p, n, m_c, c_d, dtype)
    scale = HD**-0.5
    want = jbd.context_flash_partials(
        *(jnp.asarray(a[k]) for k in ("q", "kc", "vc")), scale=scale,
        block_m=block_m, interpret=True)
    got = tbd.context_flash_partials_plain(
        *(to_torch(a[k]) for k in ("q", "kc", "vc")), scale=scale,
        block_m=block_m)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        assert_close(g_, w_, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_einsum_oracles_match_and_hold_the_plain_kernel(dtype):
    """kernels/ref.py against its reference twin, and the plain fused
    kernel against the port's monolithic-softmax oracle."""
    b, p, m_c, c_d = 3, 2, 300, 5
    rng = np.random.RandomState(9)
    shapes = [(b, G, p, HD), (G, m_c, HD), (G, m_c, HD), (b, G, c_d, HD),
              (b, G, c_d, HD)]
    arrs = [np.asarray(jnp.asarray(rng.randn(*s), dtype)) for s in shapes]
    mask = np.arange(c_d)[None, :] < rng.randint(1, c_d + 1, size=b)[:, None]
    scale = HD**-0.5
    t_in = [to_torch(a) for a in arrs]
    got = tref.bifurcated_decode_ref(*t_in, torch.as_tensor(mask), scale)
    assert_close(got, jref.bifurcated_decode_ref(
        *map(jnp.asarray, arrs), jnp.asarray(mask), scale), dtype)
    for g_, w_ in zip(tref.context_partial_ref(*t_in[:3], scale),
                      jref.context_partial_ref(*map(jnp.asarray, arrs[:3]),
                                               scale)):
        assert_close(g_, w_, dtype)
    # the same problem in the kernel's layout: rows r = b_idx*p + p_idx
    q, kc, vc, kd, vd = t_in
    bias = torch.where(torch.as_tensor(mask).reshape(1, b * c_d), 0.0, -1e30)
    plain = tbd.fused_bifurcated_decode_plain(
        q.transpose(0, 1).reshape(G, b * p, HD).contiguous(), kc, vc,
        kd.transpose(0, 1).reshape(G, b * c_d, HD), vd.transpose(0, 1)
        .reshape(G, b * c_d, HD), bias.float(), scale=scale, c_d=c_d, pn=p)
    assert_close(plain, got.transpose(0, 1).reshape(G, b * p, HD), dtype)


def _decode_case(b, p, n, m_c, c_d, dtype, layout, seed=3):
    rng = np.random.RandomState(seed)
    ctx_shape = (G, m_c, HD) if layout == "gmk" else (m_c, G, HD)
    arrs = [rng.randn(b, G, p, n, HD), rng.randn(*ctx_shape),
            rng.randn(*ctx_shape), rng.randn(b, c_d, G, HD),
            rng.randn(b, c_d, G, HD)]
    arrs = [np.asarray(jnp.asarray(x, dtype)) for x in arrs]
    lens = rng.randint(1, c_d + 1, size=b)
    mask = np.arange(c_d)[None, :] < lens[:, None]
    return arrs + [mask]


@pytest.mark.parametrize("layout", ["mgk", "gmk"])
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_dispatch_matches_reference(layout, two_pass, dtype):
    arrs = _decode_case(3, 2, 2, 700, 6, dtype, layout)
    want = jops.bifurcated_decode_attention(
        *(jnp.asarray(x) for x in arrs), interpret=True, ctx_layout=layout,
        two_pass=two_pass)
    got = tops.bifurcated_decode_attention(
        *(to_torch(x) for x in arrs), ctx_layout=layout, two_pass=two_pass)
    assert got.shape == want.shape
    assert_close(got, want, dtype)


# ---- dispatch rules ----

def _small_operands():
    a = _kernel_inputs(2, 1, 1, 40, 3, "float32")
    return [to_torch(a[k]) for k in ("q", "kc", "vc", "kd", "vd", "bias")]


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kc, vc, kd, vd, bias = _small_operands()
    before = (tbd.fused_bifurcated_decode.launches,
              tbd.context_flash_partials.launches)
    out = tbd.fused_bifurcated_decode(q, kc, vc, kd, vd, bias,
                                      scale=0.25, c_d=3, pn=1)
    want = tbd.fused_bifurcated_decode_plain(q, kc, vc, kd, vd, bias,
                                             scale=0.25, c_d=3, pn=1)
    assert torch.equal(out, want)
    tbd.context_flash_partials(q, kc, vc, scale=0.25)
    assert (tbd.fused_bifurcated_decode.launches,
            tbd.context_flash_partials.launches) == before


def test_cuda_request_without_library_raises(monkeypatch):
    """A request routed to the kernel on a machine where the library cannot
    be built or loaded raises; it never returns the plain version."""
    q, kc, vc, kd, vd, bias = _small_operands()
    # bf16, the kernels' dtype on the card (fp32 raises TypeError there)
    q, kc, vc, kd, vd = (t.to(torch.bfloat16) for t in (q, kc, vc, kd, vd))
    with pytest.raises(RuntimeError):
        _build.library()
    monkeypatch.setattr(tbd, "_on_cuda", lambda *t: True)
    with pytest.raises(RuntimeError):
        tbd.fused_bifurcated_decode(q, kc, vc, kd, vd, bias,
                                    scale=0.25, c_d=3, pn=1)
    with pytest.raises(RuntimeError):
        tbd.context_flash_partials(q, kc, vc, scale=0.25)


def test_wrappers_reject_what_they_do_not_take():
    q, kc, vc, kd, vd, bias = _small_operands()
    meta = [t.to("meta") for t in (q, kc, vc, kd, vd, bias)]
    with pytest.raises(ValueError, match="device"):
        tbd.fused_bifurcated_decode(*meta, scale=0.25, c_d=3, pn=1)
    with pytest.raises(ValueError):   # decode arm does not fit c_d
        tbd.fused_bifurcated_decode(q, kc, vc, kd, vd, bias,
                                    scale=0.25, c_d=4, pn=1)
    with pytest.raises(TypeError):    # mixed dtypes
        tbd.context_flash_partials(q, kc.double(), vc, scale=0.25)
    with pytest.raises(TypeError):    # the bias is float32 only
        tbd.fused_bifurcated_decode(q, kc, vc, kd, vd, bias.double(),
                                    scale=0.25, c_d=3, pn=1)
    with pytest.raises(ValueError, match="head_dim"):
        tbd._check_kernel_operands(torch.zeros(2, 4, 24, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):  # the card's kernels
        tbd._check_kernel_operands(torch.zeros(2, 4, 64))
    with pytest.raises(ValueError, match="contiguous"):   # on the CPU too
        tbd.context_flash_partials(q, kc.transpose(1, 2).contiguous()
                                   .transpose(1, 2), vc, scale=0.25)
