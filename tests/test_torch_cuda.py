"""The port's CUDA kernels on the card: each against its plain version,
the serve path's launch count, and no fallback for what the kernels do not
take. Marked ``cuda``; every test skips where no CUDA device is present.
This file imports no jax, so the card's machine runs it without the
reference installed:

  PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import bifurcated_decode as bd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions
    return torch.device("cuda")


def _inputs(dev, g, b, pn, hd, m_c, c_d, dtype, seed, dec_boost=0.0):
    """Random operands; ``dec_boost`` > 0 makes each sample's decode keys
    that multiple of its query rows' mean, so the decode arm (live and dead
    slots alike) carries most of the softmax mass."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    lens = torch.randint(1, c_d + 1, (b,), generator=gen, device=dev)
    live = torch.arange(c_d, device=dev)[None, :] < lens[:, None]
    bias = torch.where(live.reshape(1, b * c_d), 0.0, -1e30).to(torch.float32)
    q, kd = r(g, b * pn, hd), r(g, b * c_d, hd)
    if dec_boost:
        q_mean = q.reshape(g, b, pn, 1, hd).mean(2)
        kd = (dec_boost * q_mean + 0.5 * kd.reshape(g, b, c_d, hd)
              ).reshape(g, b * c_d, hd)
    return (q.to(dtype), r(g, m_c, hd).to(dtype), r(g, m_c, hd).to(dtype),
            kd.to(dtype), r(g, b * c_d, hd).to(dtype), bias)


def _assert_within(got, want, tol):
    """max |got - want| <= tol x max |want|: scaled to the outputs."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# (g, b, pn, hd, m_c, c_d, dec_boost): main-path-like, the same with a
# dominant decode arm, ragged m_c, rows off the tile
SHAPES = [(8, 32, 2, 128, 4096, 24, 0.0), (8, 32, 2, 128, 4096, 24, 3.0),
          (2, 3, 4, 64, 333, 5, 0.0), (4, 9, 2, 80, 130, 3, 0.0)]
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_plain_versions(cuda, shape, dtype):
    g, b, pn, hd, m_c, c_d, boost = shape
    x = _inputs(cuda, g, b, pn, hd, m_c, c_d, dtype, seed=hd + m_c,
                dec_boost=boost)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    n0 = bd.fused_bifurcated_decode.launches
    out = bd.fused_bifurcated_decode(*x, **kw)
    assert bd.fused_bifurcated_decode.launches == n0 + 1
    want = bd.fused_bifurcated_decode_plain(*x, **kw)
    tol = TOL[dtype]
    _assert_within(out, want, tol)
    acc, m, l = bd.context_flash_partials(*x[:3], scale=hd**-0.5)
    acc_p, m_p, l_p = bd.context_flash_partials_plain(*x[:3], scale=hd**-0.5)
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)
    _assert_within(acc / l[..., None], acc_p / l_p[..., None], tol)


def test_unsupported_cuda_request_raises(cuda):
    x = _inputs(cuda, 2, 2, 1, 24, 40, 3, torch.bfloat16, seed=0)  # hd=24
    with pytest.raises(ValueError, match="head_dim"):
        bd.fused_bifurcated_decode(*x, scale=0.2, c_d=3, pn=1)
    x = _inputs(cuda, 2, 2, 1, 64, 40, 3, torch.float16, seed=0)
    with pytest.raises(TypeError):
        bd.context_flash_partials(*x[:3], scale=0.125)


def test_serve_path_launches_the_fused_kernel(cuda):
    from repro_torch.configs import ServeConfig, get_config, reduced_config
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    cfg = reduced_config(get_config("internlm2-1.8b"))
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              use_kernel=True),
                      policy=BifurcationPolicy(min_io_saving_bytes=0))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    bd.fused_bifurcated_decode.launches = 0
    res = eng.generate(params, ctx, n_steps=5)
    assert bd.fused_bifurcated_decode.launches == cfg.n_layers * 4
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()
