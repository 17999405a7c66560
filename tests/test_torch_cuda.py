"""The port's CUDA kernels on the card: each against its plain version,
the serve paths' launch counts, and no fallback for what the kernels do not
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


# ---- int8 context arm and multi-prefix forest kernels ----

def _q8(k, v):
    """Quantize (…, m, hd) K/V as the caches do: the logit scale folded
    into k_scale."""
    from repro_torch.core.quantized import quantize_ctx
    kq, ks = quantize_ctx(k, fold_scale=k.shape[-1] ** -0.5)
    vq, vs = quantize_ctx(v)
    return kq, vq, ks, vs


# (g, b, pn, hd, m_c, c_d, dec_boost)
Q8_SHAPES = [(8, 32, 2, 128, 4096, 24, 0.0), (8, 32, 2, 128, 4096, 24, 3.0),
             (2, 3, 4, 64, 333, 5, 0.0), (4, 9, 2, 80, 130, 3, 0.0)]


@pytest.mark.parametrize("shape", Q8_SHAPES)
def test_q8_kernel_matches_plain_version(cuda, shape):
    g, b, pn, hd, m_c, c_d, boost = shape
    q, kc, vc, kd, vd, bias = _inputs(cuda, g, b, pn, hd, m_c, c_d,
                                      torch.bfloat16, seed=hd + m_c,
                                      dec_boost=boost)
    kq, vq, ks, vs = _q8(kc.float(), vc.float())
    x = (q, kq, vq, ks, vs, kd, vd, bias)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    n0 = bd.fused_bifurcated_decode_q8.launches
    out = bd.fused_bifurcated_decode_q8(*x, **kw)
    assert bd.fused_bifurcated_decode_q8.launches == n0 + 1
    _assert_within(out, bd.fused_bifurcated_decode_q8_plain(*x, **kw), 2e-2)


# (G, g, b, pn, hd, m_c, c_d, ctx_lens; None = random)
GROUPED_SHAPES = [(4, 8, 32, 2, 128, 2048, 24, (2048, 1500, 625, 0)),
                  (3, 2, 7, 2, 64, 300, 5, (300, 0, 77)),
                  (1, 4, 9, 2, 80, 130, 3, (130,))]


def _grouped_inputs(dev, shape, seed, quant):
    n_groups, g, b, pn, hd, m_c, c_d, lens = shape
    q, _, _, kd, vd, bias = _inputs(dev, g, b, pn, hd, 8, c_d,
                                    torch.bfloat16, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    kc = torch.randn(n_groups, g, m_c, hd, generator=gen, device=dev)
    vc = torch.randn(n_groups, g, m_c, hd, generator=gen, device=dev)
    # rows shuffled across segments, every segment but the last in use
    gid = torch.randint(0, max(1, n_groups - 1), (b,), generator=gen,
                        device=dev).to(torch.int32)
    row_group = gid.repeat_interleave(pn)
    ctx_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    ctx = ((kc.to(torch.bfloat16), vc.to(torch.bfloat16)) if not quant
           else _q8(kc, vc))
    return (q,) + ctx + (row_group, ctx_lens, kd, vd, bias)


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
def test_grouped_kernels_match_plain_versions(cuda, shape, quant):
    pn, hd, c_d = shape[3], shape[4], shape[6]
    x = _grouped_inputs(cuda, shape, seed=hd + shape[5], quant=quant)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    kern = (bd.grouped_fused_bifurcated_decode_q8 if quant
            else bd.grouped_fused_bifurcated_decode)
    plain = (bd.grouped_fused_bifurcated_decode_q8_plain if quant
             else bd.grouped_fused_bifurcated_decode_plain)
    n0 = kern.launches
    out = kern(*x, **kw)
    assert kern.launches == n0 + 1
    _assert_within(out, plain(*x, **kw), 2e-2)
    # a row of a segment id outside [0, G) comes out NaN, the others not
    row_group = x[-5].clone()
    row_group[:pn] = shape[0]
    y = x[:-5] + (row_group,) + x[-4:]
    out = kern(*y, **kw)
    assert torch.isnan(out[:, :pn].float()).all()
    assert torch.isfinite(out[:, pn:].float()).all()
    if shape[0] == 1:   # G = 1: the single-prefix kernel's function
        if quant:
            one = bd.fused_bifurcated_decode_q8(
                x[0], x[1][0], x[2][0], x[3][0], x[4][0], *x[-3:], **kw)
        else:
            one = bd.fused_bifurcated_decode(x[0], x[1][0], x[2][0],
                                             *x[-3:], **kw)
        _assert_within(kern(*x, **kw), one, 2e-2)


def test_q8_and_grouped_kernels_take_bf16_only(cuda):
    x = _grouped_inputs(cuda, GROUPED_SHAPES[1], seed=0, quant=True)
    f32 = (x[0].float(),) + x[1:-3] + (x[-3].float(), x[-2].float(), x[-1])
    with pytest.raises(TypeError, match="bfloat16"):
        bd.grouped_fused_bifurcated_decode_q8(*f32, scale=0.125, c_d=5, pn=2)
    with pytest.raises(TypeError, match="bfloat16"):
        bd.fused_bifurcated_decode_q8(
            f32[0], f32[1][0], f32[2][0], f32[3][0], f32[4][0], *f32[-3:],
            scale=0.125, c_d=5, pn=2)


def _reduced_model(dev):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import get_model
    cfg = reduced_config(get_config("internlm2-1.8b"))
    model = get_model(cfg)
    return cfg, model, model.init(0, device=dev)


def test_int8_serve_path_launches_the_q8_kernel(cuda):
    from repro_torch.configs import ServeConfig
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.runtime.serve import ServeEngine

    cfg, model, params = _reduced_model(cuda)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              use_kernel=True,
                                              cache_dtype="int8"),
                      policy=BifurcationPolicy(min_io_saving_bytes=0))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    bd.fused_bifurcated_decode_q8.launches = 0
    res = eng.generate(params, ctx, n_steps=5)
    assert bd.fused_bifurcated_decode_q8.launches == cfg.n_layers * 4
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_forest_serve_path_launches_the_grouped_kernel(cuda, cache_dtype):
    from repro_torch.configs import ForestConfig
    from repro_torch.runtime.serve import ForestServeEngine

    cfg, model, params = _reduced_model(cuda)
    eng = ForestServeEngine(model, cfg, ForestConfig(
        n_groups=2, slots=5, ctx_capacity=48, decode_capacity=8,
        use_kernel=True, cache_dtype=cache_dtype))
    st = eng.init_state(device=cuda)
    st, a = eng.admit(params, st, torch.randint(0, 500, (1, 40), device=cuda), 3)
    st, b = eng.admit(params, st, torch.randint(0, 500, (1, 9), device=cuda), 2)
    kern = (bd.grouped_fused_bifurcated_decode_q8 if cache_dtype == "int8"
            else bd.grouped_fused_bifurcated_decode)
    kern.launches = 0
    eng.step_chunk(params, st, 4)
    assert kern.launches == cfg.n_layers * 4
    assert all(len(eng.outputs[s]) == 5 for s in a + b)
