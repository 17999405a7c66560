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
          (2, 3, 4, 64, 333, 5, 0.0), (4, 9, 2, 80, 130, 3, 0.0),
          (32, 32, 1, 112, 2048, 24, 0.0),   # zamba2's shared block, hd 112
          (8, 32, 6, 128, 4096, 24, 0.0),    # dbrx / internvl2: 192 rows
          (16, 32, 1, 64, 4096, 24, 0.0)]    # whisper's decoder: MHA, hd 64


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_plain_versions(cuda, shape, dtype):
    """bf16: each kernel against its plain version. float32: the kernels
    take bf16 queries only on the card, so fp32 raises TypeError (fp32
    runs the plain versions on the CPU)."""
    g, b, pn, hd, m_c, c_d, boost = shape
    x = _inputs(cuda, g, b, pn, hd, m_c, c_d, dtype, seed=hd + m_c,
                dec_boost=boost)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    if dtype == torch.float32:
        n0 = [k.launches for k in bd.KERNELS]
        with pytest.raises(TypeError, match="bfloat16"):
            bd.fused_bifurcated_decode(*x, **kw)
        with pytest.raises(TypeError, match="bfloat16"):
            bd.context_flash_partials(*x[:3], scale=hd**-0.5)
        assert [k.launches for k in bd.KERNELS] == n0
        return
    n0 = bd.fused_bifurcated_decode.launches
    out = bd.fused_bifurcated_decode(*x, **kw)
    assert bd.fused_bifurcated_decode.launches == n0 + 1
    want = bd.fused_bifurcated_decode_plain(*x, **kw)
    tol = 2e-2
    _assert_within(out, want, tol)
    acc, m, l = bd.context_flash_partials(*x[:3], scale=hd**-0.5)
    splits = bd.split_count(b * pn, g, sms=bd._sm_count(cuda.index))
    acc_p, m_p, l_p = bd.context_flash_partials_plain(*x[:3], scale=hd**-0.5,
                                                      splits=splits)
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
             (2, 3, 4, 64, 333, 5, 0.0), (4, 9, 2, 80, 130, 3, 0.0),
             (32, 32, 1, 112, 2048, 24, 0.0), (8, 32, 6, 128, 4096, 24, 0.0),
             (16, 32, 1, 64, 4096, 24, 0.0)]


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


# (g, b, pn, hd, m_c, c_d, dec_boost): the main shape and its decode-
# dominant twin, zamba2's hd 112 shape, rows off the tile at hd 16
SINGLE_SPLIT_SHAPES = [(8, 32, 2, 128, 8192, 24, 0.0),
                       (8, 32, 2, 128, 8192, 24, 3.0),
                       (32, 32, 1, 112, 1000, 24, 0.0),
                       (2, 35, 2, 16, 300, 4, 0.0)]


@pytest.mark.parametrize("shape", SINGLE_SPLIT_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("splits", [1, None, 64])
def test_single_prefix_split_kernels_match_plain_versions(cuda, shape, quant,
                                                          splits):
    """#1 / #3 at splits 1 (the single walk), the default and 64, each
    against its plain version at the same S, one launch a call; the split
    walk within the gate of the single walk; #1 / #3 bit-equal to #8 / #9
    at the same S on the same context in pages of 128."""
    g, b, pn, hd, m_c, c_d, boost = shape
    q, kc, vc, kd, vd, bias = _inputs(cuda, g, b, pn, hd, m_c, c_d,
                                      torch.bfloat16, seed=hd + m_c + 1,
                                      dec_boost=boost)
    ctx = _q8(kc.float(), vc.float()) if quant else (kc, vc)
    x = (q,) + ctx + (kd, vd, bias)
    if splits is None:
        splits = bd.split_count(q.shape[1], g, sms=bd._sm_count(q.device.index))
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn, splits=splits)
    kern = bd.fused_bifurcated_decode_q8 if quant else bd.fused_bifurcated_decode
    plain = (bd.fused_bifurcated_decode_q8_plain if quant
             else bd.fused_bifurcated_decode_plain)
    n0 = kern.launches
    out = kern(*x, **kw)
    assert kern.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    _assert_within(out, plain(*x, **kw), 2e-2)
    _assert_within(out, kern(*x, **dict(kw, splits=1)), 2e-2)
    if not quant:   # #2 over the same context at the same S
        n0 = bd.context_flash_partials.launches
        part = bd.context_flash_partials(q, kc, vc, scale=hd**-0.5,
                                         splits=splits)
        assert bd.context_flash_partials.launches == n0 + 1
        want = bd.context_flash_partials_plain(q, kc, vc, scale=hd**-0.5,
                                               splits=splits)
        _assert_within(part[0], want[0], 2e-2)
        torch.testing.assert_close(part[1], want[1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(part[2], want[2], rtol=1e-4, atol=1e-4)
    one = (q,) + tuple(t[None] for t in ctx) + (
        torch.zeros(1, q.shape[1], dtype=torch.int32, device=cuda),
        torch.tensor([m_c], dtype=torch.int32, device=cuda), kd, vd, bias)
    y = _paged_inputs(one, quant, 128, seed=3, fill=float("nan"))
    paged = (bd.paged_fused_bifurcated_decode_q8 if quant
             else bd.paged_fused_bifurcated_decode)
    assert torch.equal(out, paged(*y, **kw))


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
    """#4 and #5 at their default split against their plain versions at
    the same S (#4 also at splits 1 and 64); rows of an id outside [0, G)
    NaN at the default split and at splits=1; G = 1 the single-prefix
    kernel's function."""
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
    # both split by default: each plain version at the kernel's S
    _assert_within(out, plain(*x, **kw, **_splits_kw(x[0])), 2e-2)
    if not quant:       # #4 at splits 1 and 64 too (#5: the test below)
        for splits in (1, 64):
            _assert_within(kern(*x, **kw, splits=splits),
                           plain(*x, **kw, splits=splits), 2e-2)
    # a row of a segment id outside [0, G) comes out NaN, the others not
    row_group = x[-5].clone()
    row_group[:pn] = shape[0]
    y = x[:-5] + (row_group,) + x[-4:]
    out = kern(*y, **kw)
    assert torch.isnan(out[:, :pn].float()).all()
    assert torch.isfinite(out[:, pn:].float()).all()
    row_group[:pn] = -1     # and -1 too, split or not
    for splits in (1, None):
        out = kern(*y, **kw, splits=splits)
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


# ---- prefix-trie kernels ----

# (g, pn, hd, cap, node_lens, paths (depth, b) as rows of slot ids, c_d,
# dec_boost): the main shape's trie (root, two templates, four leaves,
# 8 slots per leaf); ragged node lengths 0, 1, 63, 64, 65 with a depth-1
# slot beside depth-3 ones and a node repeated on one path; hd 80, rows
# off the tile
TREE_LEAVES = [[0, 1, 3]] * 8 + [[0, 1, 4]] * 8 + [[0, 2, 5]] * 8 + [[0, 2, 6]] * 8
TREE_SHAPES = [
    (8, 2, 128, 4096, (4096, 2048, 1024, 1200, 500, 1800, 300, 0),
     TREE_LEAVES, 24, 0.0),
    (8, 2, 128, 4096, (4096, 2048, 1024, 1200, 500, 1800, 300, 0),
     TREE_LEAVES, 24, 3.0),
    (2, 2, 64, 130, (0, 1, 63, 64, 65, 130),
     [[0, 1, 2], [3, -1, -1], [5, 4, 4], [1, 3, 5], [2, 2, -1]], 5, 0.0),
    (4, 2, 80, 200, (200, 77, 5), [[0, 1, -1], [2, -1, -1]] * 5, 3, 0.0),
]


def _splits_kw(q, splits=None):
    """The tree and paged kernels' share count as a keyword: ``splits``,
    or the default split on this card, so that a plain version walks the
    kernel's shares."""
    if splits is None:
        splits = bd.split_count(q.shape[1], q.shape[0],
                                sms=bd._sm_count(q.device.index))
    return {"splits": splits}


def _tree_inputs(dev, shape, seed, quant):
    g, pn, hd, cap, lens, slot_paths, c_d, boost = shape
    b = len(slot_paths)
    q, _, _, kd, vd, bias = _inputs(dev, g, b, pn, hd, 8, c_d,
                                    torch.bfloat16, seed=seed,
                                    dec_boost=boost)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_nodes = len(lens)
    kc = torch.randn(n_nodes, g, cap, hd, generator=gen, device=dev)
    vc = torch.randn(n_nodes, g, cap, hd, generator=gen, device=dev)
    depth = max(len(pth) for pth in slot_paths)
    paths = torch.tensor([pth + [-1] * (depth - len(pth))
                          for pth in slot_paths], dtype=torch.int32,
                         device=dev).T.repeat_interleave(pn, dim=1)
    node_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    ctx = ((kc.to(torch.bfloat16), vc.to(torch.bfloat16)) if not quant
           else _q8(kc, vc))
    return (q,) + ctx + (paths.contiguous(), node_lens, kd, vd, bias)


@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
def test_tree_kernels_match_plain_versions(cuda, shape, quant):
    pn, hd, c_d = shape[1], shape[2], shape[6]
    x = _tree_inputs(cuda, shape, seed=hd + shape[3], quant=quant)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    kern = (bd.tree_fused_bifurcated_decode_q8 if quant
            else bd.tree_fused_bifurcated_decode)
    plain = (bd.tree_fused_bifurcated_decode_q8_plain if quant
             else bd.tree_fused_bifurcated_decode_plain)
    n0 = kern.launches
    out = kern(*x, **kw)
    assert kern.launches == n0 + 1
    _assert_within(out, plain(*x, **kw, **_splits_kw(x[0])), 2e-2)
    # a row whose path holds an id outside [-1, N) comes out NaN
    paths = x[-5].clone()
    paths[-1, :pn] = x[-4].numel()
    y = x[:-5] + (paths,) + x[-4:]
    out = kern(*y, **kw)
    assert torch.isnan(out[:, :pn].float()).all()
    assert torch.isfinite(out[:, pn:].float()).all()


@pytest.mark.parametrize("quant", [False, True])
def test_tree_kernels_at_depth_one_are_the_grouped_kernels(cuda, quant):
    """Every path one level deep: the tree kernel computes the grouped
    kernel's bits: #7 = #5 and #6 = #4 at the default split and on the
    single walk (splits=1)."""
    shape = (8, 2, 128, 1000, (1000, 0, 77, 513),
             [[2], [0], [3], [0], [2]] * 6 + [[3], [0]], 24, 0.0)
    x = _tree_inputs(cuda, shape, seed=7, quant=quant)
    kw = dict(scale=128**-0.5, c_d=24, pn=2)
    tree = (bd.tree_fused_bifurcated_decode_q8 if quant
            else bd.tree_fused_bifurcated_decode)
    grp = (bd.grouped_fused_bifurcated_decode_q8 if quant
           else bd.grouped_fused_bifurcated_decode)
    gx = x[:-5] + (x[-5][0].contiguous(),) + x[-4:]
    for splits in (None, 1):
        sk = _splits_kw(x[0], splits)
        assert torch.equal(tree(*x, **kw, **sk), grp(*gx, **kw, **sk))


def test_tree_kernels_take_bf16_only(cuda):
    x = _tree_inputs(cuda, TREE_SHAPES[2], seed=0, quant=False)
    f32 = (x[0].float(), x[1].float(), x[2].float()) + x[3:5] + (
        x[5].float(), x[6].float(), x[7])
    with pytest.raises(TypeError, match="bfloat16"):
        bd.tree_fused_bifurcated_decode(*f32, scale=0.125, c_d=5, pn=2)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_tree_serve_path_launches_the_tree_kernel(cuda, cache_dtype):
    from repro_torch.configs import TreeConfig
    from repro_torch.runtime.serve import TreeServeEngine

    cfg, model, params = _reduced_model(cuda)
    eng = TreeServeEngine(model, cfg, TreeConfig(
        n_nodes=4, depth=2, slots=5, node_capacity=48, decode_capacity=8,
        use_kernel=True, cache_dtype=cache_dtype))
    st = eng.init_state(device=cuda)
    root = torch.randint(0, 500, (1, 40), device=cuda)
    st, a = eng.admit(params, st, [root, torch.randint(0, 500, (1, 9),
                                                       device=cuda)], 3)
    st, b = eng.admit(params, st, [root, torch.randint(0, 500, (1, 7),
                                                       device=cuda)], 2)
    assert eng.node_refs[:3] == [2, 1, 1]
    kern = (bd.tree_fused_bifurcated_decode_q8 if cache_dtype == "int8"
            else bd.tree_fused_bifurcated_decode)
    for k in bd.KERNELS:
        k.launches = 0
    eng.step_chunk(params, st, 4)
    assert {k.__name__: k.launches for k in bd.KERNELS if k.launches} == {
        kern.__name__: cfg.n_layers * 4}
    assert all(len(eng.outputs[s]) == 5 for s in a + b)


# ---- paged-pool kernels ----

# (tree shape, page size): the main trie on pages of 128 and, with a
# dominant decode arm, of 64; the ragged trie on pages of 16; hd 80 on
# pages of 48 (a 64-key block straddles pages)
PAGED_SHAPES = [(TREE_SHAPES[0], 128), (TREE_SHAPES[1], 64),
                (TREE_SHAPES[2], 16), (TREE_SHAPES[3], 48)]


def _paged_inputs(x, quant, pm, seed, fill, spare=3):
    """The trie operands ``x`` (of ``_tree_inputs``) with the nodes moved
    onto shuffled pool pages of ``pm`` keys, ``spare`` pages more than the
    live ones; every page no table entry names is filled with ``fill``
    (the int8 values with 127 when ``fill`` is not 0)."""
    ctx, rest = x[1:5] if quant else x[1:3], x[5:] if quant else x[3:]
    lens = rest[1]
    n_nodes, g, cap, hd = ctx[0].shape
    ppn = -(-cap // pm)
    need = [-(-int(m) // pm) for m in lens.tolist()]
    n_pages = sum(need) + spare
    perm = torch.randperm(n_pages,
                          generator=torch.Generator().manual_seed(seed))
    tables = torch.full((n_nodes, ppn), -1, dtype=torch.int32)
    at = 0
    for n, k in enumerate(need):
        tables[n, :k] = perm[at:at + k].to(torch.int32)
        at += k
    pools = []
    for c in ctx:
        f = fill if c.dtype != torch.int8 else (127 if fill != 0 else 0)
        pool = torch.full((n_pages, g, pm) + tuple(c.shape[3:]), f,
                          dtype=c.dtype, device=c.device)
        pad = torch.zeros((n_nodes, g, ppn * pm - cap) + tuple(c.shape[3:]),
                          dtype=c.dtype, device=c.device)
        slabs = torch.cat([c, pad], dim=2)
        for n, k in enumerate(need):
            for j in range(k):
                pool[int(tables[n, j])] = slabs[n, :, j * pm:(j + 1) * pm]
        pools.append(pool)
    return ((x[0],) + tuple(pools) + (tables.to(x[0].device), lens, rest[0])
            + rest[2:])


@pytest.mark.parametrize("shape,pm", PAGED_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_match_plain_and_tree_kernels(cuda, shape, pm, quant):
    """#8/#9 against their plain versions; bit-equal to #6/#7 on the same
    logical trie; free pages full of NaN leave the output bit-identical;
    a hole is masked; rows on a segment with a live page id outside the
    pool, or with a segment id outside [-1, N), come out NaN."""
    hd, c_d, pn = shape[2], shape[6], shape[1]
    x = _tree_inputs(cuda, shape, seed=hd + shape[3], quant=quant)
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    kern = (bd.paged_fused_bifurcated_decode_q8 if quant
            else bd.paged_fused_bifurcated_decode)
    plain = (bd.paged_fused_bifurcated_decode_q8_plain if quant
             else bd.paged_fused_bifurcated_decode_plain)
    tree = (bd.tree_fused_bifurcated_decode_q8 if quant
            else bd.tree_fused_bifurcated_decode)
    y = _paged_inputs(x, quant, pm, seed=1, fill=float("nan"))
    z = _paged_inputs(x, quant, pm, seed=1, fill=0.0)
    n0 = kern.launches
    out = kern(*y, **kw)
    assert kern.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, kern(*z, **kw))
    assert torch.equal(out, tree(*x, **kw))
    split = _splits_kw(y[0])
    _assert_within(out, plain(*y, **kw, **split), 2e-2)
    tables, paths = y[-6], y[-4]
    # a hole inside the first node's live length: masked, in both
    holed = tables.clone()
    holed[0, 0] = -1
    h = y[:-6] + (holed,) + y[-5:]
    _assert_within(kern(*h, **kw), plain(*h, **kw, **split), 2e-2)
    # a live page id past the pool poisons node 0's rows; an id N past the
    # node table poisons the first slot's rows
    bad_t = tables.clone()
    bad_t[0, 0] = 1 << 20
    bad_p = paths.clone()
    bad_p[-1, :pn] = tables.shape[0]
    out = kern(*(y[:-6] + (bad_t, y[-5], bad_p) + y[-3:]), **kw)
    bad = (bad_p == 0).any(0) | (torch.arange(paths.shape[1],
                                              device=cuda) < pn)
    assert torch.isnan(out[:, bad].float()).all()
    assert torch.isfinite(out[:, ~bad].float()).all()


@pytest.mark.parametrize("case", [(0, 128, None), (1, 64, None),
                                  (2, 16, 64), (3, 48, 5)])
@pytest.mark.parametrize("quant", [False, True])
def test_split_kernels_match_plain_versions(cuda, case, quant):
    """#6 / #7 and #8 / #9 split: at the default split (main trie, its
    decode-dominant twin) and at a forced S (64 on the ragged trie: most
    shares hold only empty or masked blocks), each against its plain
    version at the same S, #8 / #9 bit-equal to #6 / #7, one launch a
    call; the default split within the gate of the single walk
    (splits=1)."""
    i, pm, splits = case
    shape = TREE_SHAPES[i]
    hd, c_d, pn = shape[2], shape[6], shape[1]
    x = _tree_inputs(cuda, shape, seed=hd + shape[3] + 5, quant=quant)
    y = _paged_inputs(x, quant, pm, seed=2, fill=float("nan"))
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn, **_splits_kw(x[0], splits))
    assert kw["splits"] > 1
    q8 = "_q8" if quant else ""
    tree = getattr(bd, f"tree_fused_bifurcated_decode{q8}")
    paged = getattr(bd, f"paged_fused_bifurcated_decode{q8}")
    outs = []
    for kern, args in ((tree, x), (paged, y)):
        n0 = kern.launches
        out = kern(*args, **kw)
        assert kern.launches == n0 + 1
        assert torch.isfinite(out.float()).all()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    _assert_within(outs[0], getattr(bd, f"tree_fused_bifurcated_decode"
                                        f"{q8}_plain")(*x, **kw), 2e-2)
    _assert_within(outs[1], getattr(bd, f"paged_fused_bifurcated_decode"
                                        f"{q8}_plain")(*y, **kw), 2e-2)
    _assert_within(outs[0], tree(*x, **dict(kw, splits=1)), 2e-2)


def test_paged_kernels_take_bf16_only(cuda):
    x = _tree_inputs(cuda, TREE_SHAPES[2], seed=0, quant=False)
    y = _paged_inputs(x, False, 16, seed=0, fill=0.0)
    f32 = (y[0].float(), y[1].float(), y[2].float()) + y[3:6] + (
        y[6].float(), y[7].float(), y[8])
    with pytest.raises(TypeError, match="bfloat16"):
        bd.paged_fused_bifurcated_decode(*f32, scale=0.125, c_d=5, pn=2)


@pytest.mark.parametrize("engine", ["single", "forest", "tree"])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_paged_serve_paths_launch_the_paged_kernel(cuda, engine,
                                                   cache_dtype):
    """Every engine with ctx_store="paged": n decode steps launch the paged
    kernel n_layers x n times and no other kernel."""
    from repro_torch.configs import ForestConfig, ServeConfig, TreeConfig
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.runtime.serve import (ForestServeEngine, ServeEngine,
                                           TreeServeEngine)

    cfg, model, params = _reduced_model(cuda)
    kern = (bd.paged_fused_bifurcated_decode_q8 if cache_dtype == "int8"
            else bd.paged_fused_bifurcated_decode)
    kw = dict(use_kernel=True, cache_dtype=cache_dtype, ctx_store="paged",
              page_size=16)
    tok = lambda m: torch.randint(0, 500, (1, m), device=cuda)  # noqa: E731
    for k in bd.KERNELS:
        k.launches = 0
    if engine == "single":
        eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                                  **kw),
                          policy=BifurcationPolicy(min_io_saving_bytes=0))
        res = eng.generate(params, tok(40), n_steps=5)
        assert torch.isfinite(res.logprobs).all()
    else:
        if engine == "forest":
            eng = ForestServeEngine(model, cfg, ForestConfig(
                n_groups=2, slots=5, ctx_capacity=48, decode_capacity=8,
                num_pages=5, **kw))
            reqs = (tok(40), tok(9))
        else:
            eng = TreeServeEngine(model, cfg, TreeConfig(
                n_nodes=4, depth=2, slots=5, node_capacity=48,
                decode_capacity=8, num_pages=6, **kw))
            root = tok(40)
            reqs = ([root, tok(9)], [root, tok(7)])
        st = eng.init_state(device=cuda)
        st, a = eng.admit(params, st, reqs[0], 3)
        st, b = eng.admit(params, st, reqs[1], 2)
        assert eng.page_alloc.free_count() == 1
        for k in bd.KERNELS:
            k.launches = 0
        eng.step_chunk(params, st, 4)
        assert all(len(eng.outputs[s]) == 5 for s in a + b)
    assert {k.__name__: k.launches for k in bd.KERNELS if k.launches} == {
        kern.__name__: cfg.n_layers * 4}


# ---- packed heterogeneous-step kernels ----

def _packed_inputs(y, pn, cp, fresh_len, fresh_start, fresh_path, seed,
                   env=None):
    """The paged operands ``y`` (of ``_paged_inputs``) with a chunk of
    ``cp`` positions (``pn`` rows each) after the decode rows: its rows'
    path [fresh_path..., N] on one more level (decode rows -1 there), its
    envelope of ``env`` rows (default two pages) holding ``fresh_len`` live
    rows from position ``fresh_start``, the chunk at its last ``cp`` live
    rows; cp = 0 gives a decode-only call. Returns (args, kwargs) of the
    packed wrappers."""
    quant = y[1].dtype == torch.int8
    n_pool = 4 if quant else 2
    q, pool = y[0], y[1:1 + n_pool]
    tables, lens, paths = y[1 + n_pool:4 + n_pool]
    kd, vd, bias = y[4 + n_pool:]
    g, nd, hd = q.shape
    dev = q.device
    pm, n_segs, depth = pool[0].shape[2], tables.shape[0], paths.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    qc = torch.randn(g, cp * pn, hd, generator=gen, device=dev).to(q.dtype)
    env = env or 2 * pm
    kf, vf = (torch.randn(env, g, hd, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    fp = torch.tensor(list(fresh_path) + [-1] * (depth - len(fresh_path))
                      + [n_segs], dtype=torch.int32, device=dev)
    path_rows = torch.cat([
        torch.cat([paths, torch.full((1, nd), -1, dtype=torch.int32,
                                     device=dev)]),
        fp[:, None].expand(depth + 1, cp * pn)], dim=1).contiguous()
    pos = fresh_start + fresh_len - cp + torch.arange(cp, device=dev)
    row_pos = torch.cat([torch.zeros(nd, dtype=torch.int32, device=dev),
                         pos.to(torch.int32).repeat_interleave(pn)])
    row_slot = torch.cat([
        torch.arange(nd, dtype=torch.int32, device=dev) // pn,
        torch.full((cp * pn,), -1, dtype=torch.int32, device=dev)])
    args = ((torch.cat([q, qc], 1).contiguous(),) + tuple(pool)
            + (kf, vf, tables, lens, path_rows, row_pos.contiguous(),
               row_slot.contiguous(), kd, vd, bias))
    return args, dict(fresh_len=fresh_len, fresh_start=fresh_start)


# (paged shape, page size, cp, fresh_len, fresh_start, fresh path): the
# main trie with a 100-position chunk under the root and first template
# (rows off the tile, a tile of decode and chunk rows), the ragged trie
# with a chunk at position 0 and no ancestors, hd 80 with fresh_len 65
PACKED_SHAPES = [(0, 100, 165, 6144, [0, 1]), (2, 7, 7, 0, []),
                 (3, 20, 65, 200, [0])]


@pytest.mark.parametrize("case", PACKED_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
def test_packed_kernels_match_plain_and_paged_kernels(cuda, case, quant):
    """#10/#11: a decode-only call bit-equal to #8/#9 at the same S (the
    default and 1); with a chunk, against their plain versions at the
    kernel's S (decode and chunk rows), the same at another S; an id
    outside [-1, N] on the chunk's path gives NaN chunk rows and leaves
    the decode rows' bits; fresh_len 0 and the pseudo id N alone poison
    nothing."""
    i, cp, fl, fs, fpath = case
    shape, pm = PAGED_SHAPES[i]
    hd, c_d, pn = shape[2], shape[6], shape[1]
    x = _tree_inputs(cuda, shape, seed=hd + shape[3], quant=quant)
    y = _paged_inputs(x, quant, pm, seed=1, fill=float("nan"))
    kw = dict(scale=hd**-0.5, c_d=c_d, pn=pn)
    kern = (bd.packed_fused_bifurcated_decode_q8 if quant
            else bd.packed_fused_bifurcated_decode)
    plain = (bd.packed_fused_bifurcated_decode_q8_plain if quant
             else bd.packed_fused_bifurcated_decode_plain)
    paged = (bd.paged_fused_bifurcated_decode_q8 if quant
             else bd.paged_fused_bifurcated_decode)
    env = -(-max(fl, 1) // pm) * pm + pm
    a0, k0 = _packed_inputs(y, pn, 0, 0, 0, fpath, seed=2, env=env)
    n0 = kern.launches
    dec_only = kern(*a0, **k0, **kw)
    assert kern.launches == n0 + 1
    # decode-only: #10 / #11 is #8 / #9 at the same S
    assert torch.equal(dec_only, paged(*y, **kw, **_splits_kw(y[0])))
    assert torch.equal(kern(*a0, **k0, **kw, splits=1),
                       paged(*y, **kw, splits=1))
    a, k = _packed_inputs(y, pn, cp, fl, fs, fpath, seed=2, env=env)
    out = kern(*a, **k, **kw)
    assert torch.isfinite(out.float()).all()
    g, rows, _ = a[0].shape
    split = bd.packed_split_count(y[0].shape[1], rows - y[0].shape[1], g,
                                  sms=bd._sm_count(cuda.index))
    assert torch.equal(kern(*a, **k, **kw, splits=(split[0], 3)), out)
    _assert_within(out, plain(*a, **k, **kw, splits=split), 2e-2)
    nd = y[0].shape[1]
    assert torch.equal(out[:, :nd], dec_only)
    empty = kern(*a, **dict(k, fresh_len=0), **kw)
    assert torch.isfinite(empty.float()).all()
    assert torch.equal(empty[:, :nd], dec_only)
    bad = a[-6].clone()
    bad[0, nd:] = a[-8].shape[0] + 1                 # N + 1
    out_b = kern(*(a[:-6] + (bad,) + a[-5:]), **k, **kw)
    assert torch.isnan(out_b[:, nd:].float()).all()
    assert torch.equal(out_b[:, :nd], dec_only)


@pytest.mark.parametrize("splits", [1, None, 64])
def test_forest_and_packed_split_kernels_match_plain_versions(cuda, splits):
    """#5 on the main-like forest and #10 on the main-like trie with a
    100-position chunk, at splits 1, the default and 64 (most shares
    empty), each against its plain version at the same S, one launch a
    call."""
    shape = GROUPED_SHAPES[0]
    x = _grouped_inputs(cuda, shape, seed=3, quant=True)
    kw = dict(scale=shape[4]**-0.5, c_d=shape[6], pn=shape[3])
    sk = _splits_kw(x[0], splits)
    kern = bd.grouped_fused_bifurcated_decode_q8
    n0 = kern.launches
    out = kern(*x, **kw, **sk)
    assert kern.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    _assert_within(out, bd.grouped_fused_bifurcated_decode_q8_plain(
        *x, **kw, **sk), 2e-2)
    tshape, pm = PAGED_SHAPES[0]
    t = _tree_inputs(cuda, tshape, seed=4, quant=False)
    y = _paged_inputs(t, False, pm, seed=1, fill=float("nan"))
    a, k = _packed_inputs(y, tshape[1], 100, 165, 6144, [0, 1], seed=2,
                          env=256)
    kw = dict(k, scale=tshape[2]**-0.5, c_d=tshape[6], pn=tshape[1])
    if splits is None:
        g, rows, _ = a[0].shape
        sk = {"splits": bd.packed_split_count(
            y[0].shape[1], rows - y[0].shape[1], g,
            sms=bd._sm_count(cuda.index))}
    kern = bd.packed_fused_bifurcated_decode
    n0 = kern.launches
    out = kern(*a, **kw, **sk)
    assert kern.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    _assert_within(out, bd.packed_fused_bifurcated_decode_plain(
        *a, **kw, **sk), 2e-2)


def test_packed_kernels_take_bf16_and_one_launch_only(cuda):
    """fp32 queries raise TypeError; entries_per_launch raises ValueError
    on CUDA tensors (one launch serves any queue on the card)."""
    from repro_torch.kernels.ops import packed_bifurcated_decode_attention

    shape, pm = PAGED_SHAPES[2]
    x = _tree_inputs(cuda, shape, seed=0, quant=False)
    y = _paged_inputs(x, False, pm, seed=0, fill=0.0)
    a, k = _packed_inputs(y, 2, 3, 3, 10, [0], seed=1)
    f32 = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in a)
    with pytest.raises(TypeError, match="bfloat16"):
        bd.packed_fused_bifurcated_decode(*f32, **k, scale=0.125, c_d=5,
                                          pn=2)
    g, rows, hd = y[0].shape
    b = rows // 2
    q = y[0].reshape(g, b, 2, 1, hd).permute(1, 0, 2, 3, 4)
    arm = torch.zeros(b, 3, g, hd, dtype=torch.bfloat16, device=cuda)
    n0 = [k.launches for k in bd.KERNELS]
    with pytest.raises(ValueError, match="entries_per_launch"):
        packed_bifurcated_decode_attention(
            q, y[1], y[2], y[3], y[4], y[5][:, ::2], arm, arm,
            torch.ones(b, 3, dtype=torch.bool, device=cuda),
            entries_per_launch=2)
    assert [k.launches for k in bd.KERNELS] == n0


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_packed_serve_path_launches_the_packed_kernel(cuda, cache_dtype):
    """TreeServeEngine(step_mode="packed") on the paged store: each step
    with a pending chunk launches #10 (#11) n_layers times and no other
    kernel; once nothing is pending, the decode-only steps launch #8 (#9);
    the requests' tokens are in range."""
    from repro_torch.configs import TreeConfig
    from repro_torch.runtime.serve import TreeServeEngine

    cfg, model, params = _reduced_model(cuda)
    q8 = cache_dtype == "int8"
    packed = (bd.packed_fused_bifurcated_decode_q8 if q8
              else bd.packed_fused_bifurcated_decode)
    paged = (bd.paged_fused_bifurcated_decode_q8 if q8
             else bd.paged_fused_bifurcated_decode)
    eng = TreeServeEngine(model, cfg, TreeConfig(
        n_nodes=4, depth=2, slots=5, node_capacity=48, decode_capacity=16,
        use_kernel=True, cache_dtype=cache_dtype, ctx_store="paged",
        page_size=16, step_mode="packed", suffix_prefill=True,
        prefill_chunk=16))
    tok = lambda m: torch.randint(0, 500, (1, m), device=cuda)  # noqa: E731
    root = tok(40)
    st = eng.init_state(device=cuda)
    st, a = eng.admit(params, st, [root, tok(9)], 3)     # 3 + 1 chunks
    for k in bd.KERNELS:
        k.launches = 0
    st = eng.step_chunk(params, st, 4)
    assert {k.__name__: k.launches for k in bd.KERNELS if k.launches} == {
        packed.__name__: cfg.n_layers * 4}
    st, b = eng.admit(params, st, [root, tok(7)], 2)     # 1 chunk
    for k in bd.KERNELS:
        k.launches = 0
    st = eng.step_chunk(params, st, 3)
    assert {k.__name__: k.launches for k in bd.KERNELS if k.launches} == {
        packed.__name__: cfg.n_layers, paged.__name__: cfg.n_layers * 2}
    assert not eng._pending
    assert [len(eng.outputs[s]) for s in a + b] == [4, 4, 4, 3, 3]
    assert all(0 <= t < cfg.vocab_size for s in a + b for t in eng.outputs[s])


# ---- flash prefill (#12) ----

# (b, n, m, h, g, hd, causal, window, q_offset): a main-path-like prefill,
# a suffix at an offset off the tile, a window cutting whole tiles, MQA,
# hd=80, n and m off the tile, one query row, bidirectional
FLASH_SHAPES = [
    (1, 2048, 2048, 16, 8, 128, True, 0, 0),
    (1, 500, 2548, 16, 8, 128, True, 0, 2048),
    (1, 2048, 2048, 16, 8, 128, True, 512, 0),
    (2, 333, 333, 8, 1, 64, True, 0, 0),
    (2, 300, 300, 4, 2, 80, True, 0, 0),
    (1, 77, 1000, 4, 2, 128, True, 100, 923),
    (3, 1, 129, 4, 4, 16, True, 0, 128),
    (1, 200, 130, 4, 2, 64, False, 0, 0),
    (1, 64, 8192, 16, 8, 128, True, 0, 8128),   # 8 CTAs: keys split
    (1, 1024, 1024, 32, 32, 112, True, 0, 0),   # zamba2's shared block
    (1, 1001, 1001, 24, 8, 128, True, 0, 0),    # p 3: tiles of 126 rows
    (1, 700, 1500, 16, 16, 64, False, 0, 0),    # whisper's cross-attention
    (1, 5000, 5000, 32, 8, 128, True, 4096, 0),  # mixtral's window
]


def _flash_inputs(dev, b, n, m, h, g, hd, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, n, h, hd), (b, m, g, hd), (b, m, g, hd))]


@pytest.mark.parametrize("case", FLASH_SHAPES)
def test_flash_prefill_kernel_matches_plain_version(cuda, case):
    """#12 against its plain version on the card, row by row: each (batch,
    query, head) row's max error within 2e-2 of that row's max |out| (a
    causal prefill's late rows are much smaller than its first); one
    launch per call."""
    from repro_torch.kernels import flash_prefill as fp

    b, n, m, h, g, hd, causal, window, off = case
    q, k, v = _flash_inputs(cuda, b, n, m, h, g, hd, seed=sum(case))
    kw = dict(causal=causal, window=window, q_offset=off)
    n0 = fp.flash_prefill_attention.launches
    out = fp.flash_prefill_attention(q, k, v, **kw)
    want = fp.flash_prefill_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.flash_prefill_attention.launches == n0 + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs().amax(-1)
    assert (err <= 2e-2 * want.float().abs().amax(-1)).all(), err.max()


def test_flash_prefill_key_split_is_one_launch(cuda):
    """A call whose tiles cannot fill the card splits their keys (the split
    kernel and its merge) and still counts one launch."""
    from repro_torch.kernels import flash_prefill as fp

    q, k, v = _flash_inputs(cuda, 1, 64, 8192, 16, 8, 128, seed=5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fp.split_count(1, 64, 8192, 8, 2, causal=True, window=0,
                          q_offset=8128, sms=sms) > 1
    n0 = fp.flash_prefill_attention.launches
    out = fp.flash_prefill_attention(q, k, v, q_offset=8128)
    want = fp.flash_prefill_attention_plain(q, k, v, q_offset=8128)
    torch.cuda.synchronize()
    assert fp.flash_prefill_attention.launches == n0 + 1
    err = (out.float() - want.float()).abs().amax(-1)
    assert (err <= 2e-2 * want.float().abs().amax(-1)).all(), err.max()


def test_flash_prefill_kernel_takes_bf16_only(cuda):
    from repro_torch.kernels import flash_prefill as fp

    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 64, 0, torch.float32)
    n0 = fp.flash_prefill_attention.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fp.flash_prefill_attention(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 24, 0)    # hd=24
    with pytest.raises(ValueError, match="head_dim"):
        fp.flash_prefill_attention(q, k, v)
    assert fp.flash_prefill_attention.launches == n0


def test_flash_prefill_serve_path_launches_the_kernel(cuda):
    """Under train_attn="flash" a prefill launches #12 once per layer, and
    the generate that follows launches the fused decode kernel as before."""
    import dataclasses

    from repro_torch.configs import ServeConfig
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    cfg, _, params = _reduced_model(cuda)
    cfg = dataclasses.replace(cfg, train_attn="flash")
    model = get_model(cfg)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              use_kernel=True),
                      policy=BifurcationPolicy(min_io_saving_bytes=0))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    fp.flash_prefill_attention.launches = 0
    bd.fused_bifurcated_decode.launches = 0
    res = eng.generate(params, ctx, n_steps=5)
    assert fp.flash_prefill_attention.launches == cfg.n_layers
    assert bd.fused_bifurcated_decode.launches == cfg.n_layers * 4
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()


# ---- chunked linear attention (#13) and the zamba2 hybrid ----

# (b, n, H, dk, dv, chunk, normalize, initial state, head-broadcast q/k):
# Mamba2's shape at a shorter n, n off the chunk with a state, dk != dv,
# n 1, the normaliser column, the reduced config's 8-wide heads, 128-wide
# heads, q and k as stride-0 views over the heads (as the model hands them)
CHUNKED_SHAPES = [
    (1, 2048, 8, 64, 64, 256, False, False, False),
    (1, 1000, 4, 64, 64, 256, False, True, False),
    (2, 333, 3, 32, 16, 64, False, False, False),
    (1, 1, 2, 64, 64, 256, False, True, False),
    (1, 300, 2, 64, 64, 64, True, False, False),
    (2, 100, 4, 8, 8, 16, False, True, False),
    (1, 200, 2, 128, 128, 128, False, True, False),
    (2, 777, 16, 64, 64, 256, False, False, True),
]


def _chunked_inputs(dev, b, n, H, dk, dv, seed, init=False, bcast=False,
                    dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if bcast:
        q, k = (r(b, n, 1, dk).to(dtype).expand(b, n, H, dk) for _ in range(2))
    else:
        q, k = (r(b, n, H, dk).to(dtype) for _ in range(2))
    v = r(b, n, H, dv).to(dtype)
    # <= 0, slow to fast over the heads, as Mamba2's dt_bias spreads them
    a = -torch.nn.functional.softplus(
        r(b, n, H) + torch.linspace(-4.0, 1.0, H, device=dev))
    s0 = r(b, H, dk, dv) if init else None
    return q, k, v, a, s0


def _rows_within(got, want, tol=2e-2):
    """Every row's (last axis) max |err| within tol x its max |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return bool((err <= tol * want.float().abs().amax(-1)).all())


def _faulty_chunked_plain(q, k, v, a, chunk, fault, s0=None):
    """The plain version's walk with one planted fault (fp32)."""
    import torch.nn.functional as F

    b, n, H, dk = q.shape
    c = min(chunk, n)
    pad = (-n) % c
    q, k, v = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    a = F.pad(a.float(), (0, 0, 0, pad),
              value=-1.0 if fault == "padded rows decay" else 0.0)
    S0 = (torch.zeros(b, H, dk, v.shape[-1], device=q.device)
          if s0 is None else s0.float())
    S = S0
    mask = torch.ones(c, c, device=q.device)
    if fault != "causal mask dropped":
        mask = torch.tril(mask)
    out = []
    for c0 in range(0, n + pad, c):
        if fault == "state not carried":
            S = S0
        qf, kf, vf, ac = q[:, c0:c0 + c], k[:, c0:c0 + c], v[:, c0:c0 + c], \
            a[:, c0:c0 + c]
        A = torch.cumsum(ac, dim=1)
        if fault == "exclusive cumsum":
            A = A - ac
        D = torch.exp(torch.clamp(A[:, :, None] - A[:, None], max=0.0)) \
            * mask[None, :, :, None]
        o = torch.einsum("bijh,bjhv->bihv",
                         torch.einsum("bihk,bjhk->bijh", qf, kf) * D, vf)
        e_a = 1.0 if fault == "inter without e^A" else torch.exp(A)[..., None]
        out.append(o + torch.einsum("bihk,bhkv->bihv", qf * e_a, S))
        a_last = A[:, -1]
        S = S * torch.exp(a_last)[..., None, None] + torch.einsum(
            "bjhk,bjhv->bhkv", kf * torch.exp(a_last[:, None] - A)[..., None],
            vf)
    return torch.cat(out, dim=1)[:, :n], S


@pytest.mark.parametrize("case", CHUNKED_SHAPES)
def test_chunked_linear_kernel_matches_plain_version(cuda, case):
    """#13 against its plain version on the card: each (batch, position,
    head) row of the output within 2e-2 of that row's max |plain|, and the
    final state of each head within 2e-2 of its max |plain|; one launch per
    call."""
    from repro_torch.kernels import chunked_linear as cl

    b, n, H, dk, dv, chunk, normalize, init, bcast = case
    q, k, v, a, s0 = _chunked_inputs(cuda, b, n, H, dk, dv, sum(case[:6]),
                                     init=init, bcast=bcast)
    if normalize and s0 is not None:
        s0 = torch.nn.functional.pad(s0, (0, 1))
    kw = dict(chunk=chunk, normalize=normalize, initial_state=s0)
    n0 = cl.chunked_linear_attention.launches
    out, st = cl.chunked_linear_attention(q, k, v, a, **kw)
    want, st_p = cl.chunked_linear_attention_plain(q, k, v, a, **kw)
    torch.cuda.synchronize()
    assert cl.chunked_linear_attention.launches == n0 + 1
    assert out.shape == want.shape and out.dtype == v.dtype
    assert st.shape == st_p.shape and st.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(st).all()
    assert _rows_within(out, want)
    assert _rows_within(st.flatten(2), st_p.flatten(2))


@pytest.mark.parametrize("fault", ["state not carried", "inter without e^A",
                                   "exclusive cumsum", "causal mask dropped",
                                   "padded rows decay"])
def test_chunked_linear_gate_catches_faulty_plain_versions(cuda, fault):
    """The per-row gate of the test above misses a plain version with any
    one of five faults by far: the kernel's output (or final state, for
    the padded rows' decay, which moves only the state) against it."""
    from repro_torch.kernels import chunked_linear as cl

    q, k, v, a, _ = _chunked_inputs(cuda, 1, 1000, 4, 64, 64, seed=5)
    out, st = cl.chunked_linear_attention(q, k, v, a, chunk=256)
    good, st_good = _faulty_chunked_plain(q, k, v, a, 256, None)
    bad, st_bad = _faulty_chunked_plain(q, k, v, a, 256, fault)
    assert _rows_within(out, good) and _rows_within(st.flatten(2),
                                                    st_good.flatten(2))
    if fault == "padded rows decay":
        assert torch.equal(bad, good)
        assert not _rows_within(st.flatten(2), st_bad.flatten(2), 0.2)
    else:
        assert not _rows_within(out, bad, 0.2)


def test_chunked_linear_kernel_bits_do_not_move_with_occupancy(cuda):
    """The chunk-parallel kernel's result does not depend on how many of
    its CTAs an SM holds (``ctas_per_sm``) or on the calls before it (the
    ticket counter and the chain flags are zero again after each call);
    one launch a call; ``occupancy`` honours the cap."""
    from repro_torch.kernels import chunked_linear as cl

    q, k, v, a, s0 = _chunked_inputs(cuda, 2, 1500, 8, 64, 64, seed=11,
                                     init=True)
    kw = dict(chunk=256, initial_state=s0)
    n0 = cl.chunked_linear_attention.launches
    out, st = cl.chunked_linear_attention(q, k, v, a, **kw)
    for cap in (1, 2, 3, None):
        o, s = cl.chunked_linear_attention(q, k, v, a, ctas_per_sm=cap, **kw)
        assert torch.equal(o, out) and torch.equal(s, st)
    torch.cuda.synchronize()
    assert cl.chunked_linear_attention.launches == n0 + 5
    assert all(int(w.abs().sum()) == 0 for w in cl._SYNC.values())
    assert _rows_within(out, cl.chunked_linear_attention_plain(
        q, k, v, a, **kw)[0])
    assert cl.occupancy(64, 64, 256) >= 1
    assert [cl.occupancy(64, 64, 256, c) <= c for c in (1, 2)] == [True] * 2


def test_chunked_linear_kernel_takes_bf16_and_small_heads_only(cuda):
    from repro_torch.kernels import chunked_linear as cl

    n0 = cl.chunked_linear_attention.launches
    q, k, v, a, _ = _chunked_inputs(cuda, 1, 64, 2, 64, 64, 0,
                                    dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        cl.chunked_linear_attention(q, k, v, a)
    # past the wide path's widest head (dk 1024), past its chunk (256),
    # and the narrow kernel's occupancy cap on the wide path
    q, k, v, a, _ = _chunked_inputs(cuda, 1, 64, 2, 2048, 64, 0)
    with pytest.raises(ValueError, match="up to"):
        cl.chunked_linear_attention(q, k, v, a)
    q, k, v, a, _ = _chunked_inputs(cuda, 1, 600, 2, 256, 64, 0)
    with pytest.raises(ValueError, match="chunks of up to"):
        cl.chunked_linear_attention(q, k, v, a, chunk=512)
    with pytest.raises(ValueError, match="narrow"):
        cl.chunked_linear_attention(q, k, v, a, ctas_per_sm=2)
    assert cl.chunked_linear_attention.launches == n0


# (b, n, H, dk, dv, chunk, normalize, initial state): the wide path, heads
# past 128: xLSTM's mLSTM head normalised (dk 1024, dv 1024 + 1) at a
# shorter n, n off the chunk from a state, n 1, dk != dv, b > 1, the first
# width past 128, a chunk off the 64-row tile
WIDE_CHUNKED_SHAPES = [
    (1, 1024, 2, 1024, 1024, 256, True, False),
    (1, 700, 2, 256, 256, 256, True, True),
    (1, 1, 2, 1024, 1024, 256, True, True),
    (1, 600, 2, 512, 1024, 256, False, True),
    (3, 300, 2, 256, 136, 64, False, False),
    (2, 333, 3, 136, 136, 100, False, True),
]


@pytest.mark.parametrize("case", WIDE_CHUNKED_SHAPES)
def test_chunked_linear_wide_path_matches_plain_version(cuda, case):
    """#13's wide path against its plain version on the card, row by row
    and head by head as above; two launches a call; the same bits on a
    second call, and the sync words zero again after each."""
    from repro_torch.kernels import chunked_linear as cl

    b, n, H, dk, dv, chunk, normalize, init = case
    q, k, v, a, s0 = _chunked_inputs(cuda, b, n, H, dk, dv, sum(case[:6]),
                                     init=init)
    if normalize and s0 is not None:
        s0 = torch.nn.functional.pad(s0, (0, 1))
    kw = dict(chunk=chunk, normalize=normalize, initial_state=s0)
    n0 = cl.chunked_linear_attention.launches
    out, st = cl.chunked_linear_attention(q, k, v, a, **kw)
    out2, st2 = cl.chunked_linear_attention(q, k, v, a, **kw)
    want, st_p = cl.chunked_linear_attention_plain(q, k, v, a, **kw)
    torch.cuda.synchronize()
    assert cl.chunked_linear_attention.launches == n0 + 4
    assert torch.equal(out, out2) and torch.equal(st, st2)
    assert all(int(w.abs().sum()) == 0 for w in cl._SYNC.values())
    assert out.shape == want.shape and out.dtype == v.dtype
    assert st.shape == st_p.shape and st.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(st).all()
    assert _rows_within(out, want)
    assert _rows_within(st.flatten(2), st_p.flatten(2))


def test_xlstm_serve_path_launches_the_wide_kernel(cuda):
    """A reduced xLSTM with 256-wide mLSTM heads: generate launches #13's
    wide path (two launches) once per mLSTM layer of the prefill and no
    other kernel; decode writes each sample's own states."""
    import dataclasses

    from repro_torch.configs import ServeConfig, get_config, reduced_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    cfg = dataclasses.replace(reduced_config(get_config("xlstm-1.3b")),
                              d_model=256)
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              temperature=0.8))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    for kern in KERNELS:
        kern.launches = 0
    res = eng.generate(params, ctx, n_steps=5)
    n_mlstm = model.n_groups * model.m_per_group
    assert {k.__name__: k.launches for k in KERNELS if k.launches} == {
        "chunked_linear_attention": 2 * n_mlstm}
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()
    assert len({tuple(t) for t in res.tokens.tolist()}) > 1


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_hybrid_serve_path_launches_its_kernels(cuda, cache_dtype):
    """A reduced zamba2 generate: every Mamba2 layer of the prefill
    launches #13 once, every shared-attention application of every decode
    step the fused (int8: q8) decode kernel, and nothing else."""
    from repro_torch.configs import ServeConfig, get_config, reduced_config
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.kernels import KERNELS
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    cfg = reduced_config(get_config("zamba2-7b"))
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              use_kernel=True,
                                              cache_dtype=cache_dtype),
                      policy=BifurcationPolicy(min_io_saving_bytes=0))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    for kern in KERNELS:
        kern.launches = 0
    res = eng.generate(params, ctx, n_steps=5)
    dec = ("fused_bifurcated_decode_q8" if cache_dtype == "int8"
           else "fused_bifurcated_decode")
    assert {k.__name__: k.launches for k in KERNELS if k.launches} == {
        "chunked_linear_attention": cfg.n_layers,
        dec: model.n_super * 4}
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()


@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-26b",
                                  "whisper-medium"])
def test_family_serve_paths_launch_the_fused_kernel(cuda, arch):
    """A reduced MoE, VLM and encoder-decoder generate (patch embeddings,
    frames and sample_batch as the CLI makes them): every decode step
    launches the fused decode kernel once per layer and no other kernel
    runs."""
    from repro_torch.configs import ServeConfig, get_config, reduced_config
    from repro_torch.core.policy import BifurcationPolicy
    from repro_torch.kernels import KERNELS
    from repro_torch.models import get_model
    from repro_torch.runtime.serve import ServeEngine

    cfg = reduced_config(get_config(arch))
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, cfg, ServeConfig(batch=4, decode_capacity=8,
                                              use_kernel=True),
                      policy=BifurcationPolicy(min_io_saving_bytes=0))
    ctx = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = 0.02 * torch.randn(1, cfg.n_image_tokens,
                                                cfg.d_model, device=cuda)
    if cfg.family == "encdec":
        kw = dict(frames=0.02 * torch.randn(1, 40, cfg.d_model, device=cuda),
                  sample_batch=4)
    for kern in KERNELS:
        kern.launches = 0
    res = eng.generate(params, ctx, n_steps=5, **kw)
    assert {k.__name__: k.launches for k in KERNELS if k.launches} == {
        "fused_bifurcated_decode": cfg.n_layers * 4}
    assert res.tokens.shape == (4, 5) and torch.isfinite(res.logprobs).all()
