"""Port parity for xLSTM's serving path on the reduced xlstm-1.3b (4 layers:
2 groups of one mLSTM and one sLSTM, 2 heads, chunk 16): the mLSTM and
sLSTM layers in fp32, ``XLSTMModel.prefill`` / ``decode_step``,
``ServeEngine.generate``, the state broadcast, the weights' dtypes and the
plain version of kernel #13 at a wide head — the port on weights converted
from the JAX reference's own initialisation, against the reference.

The reference runs xLSTM in bf16 whatever its weights (``xlstm.py`` casts
the embedding to bf16), so whole-model parity is bf16 logits within 2e-2
of the largest (``_torch_parity.assert_close_logits``) and greedy tokens;
each layer alone is held in fp32 at 1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.models import get_model as j_get_model
from repro.models import linear_scan as jls
from repro.models import xlstm as jx
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.convert import cast_weights, params_from_numpy
from repro_torch.kernels import KERNELS
from repro_torch.kernels import chunked_linear as tcl
from repro_torch.models import get_model as t_get_model
from repro_torch.models import linear_scan as tls
from repro_torch.models import xlstm as tx
from repro_torch.runtime.serve import ServeEngine as TServeEngine

CFG_J = reduced_config(get_config("xlstm-1.3b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("xlstm-1.3b"))
PARAMS_NP = jax.tree.map(np.asarray,
                         j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 40))
N_SAMPLES, N_STEPS = 4, 8
# the leaves the reference applies in float32 that this slice adds to
# convert.FP32_KEYS (xlstm.py:66, :117, :118)
NEW_FP32_LEAVES = (("mlstm", "w_gates"), ("mlstm", "gate_bias"),
                   ("slstm", "r_rec"), ("slstm", "bias"))


def _layer_np(kind):
    """The first mLSTM or sLSTM layer of the reference's stacked params,
    numpy; its constant leaves made random so that each one counts."""
    stack = PARAMS_NP[kind]
    p = jax.tree.map(lambda a: np.array(a[0, 0] if kind == "mlstm" else a[0]),
                     stack)
    rng = np.random.RandomState(11)
    p["ln"]["scale"] = (1 + 0.3 * rng.randn(*p["ln"]["scale"].shape)
                        ).astype(np.float32)
    names = ("gate_bias", "norm_scale") if kind == "mlstm" else ("bias",)
    for name in names:
        p[name] = (p[name] + 0.5 * rng.randn(*p[name].shape)).astype(np.float32)
    return p


def _bf16_rounded(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32)


def _x(seed, n=37, b=2):
    return np.random.RandomState(seed).randn(b, n, CFG_J.d_model
                                             ).astype(np.float32)


def _mlstm_reference(p, x):
    """The reference prefill's mLSTM layer (xlstm.py:243-256): the layer's
    output and its final state."""
    h = jx.rms_normalize(x, p["ln"]["scale"])
    q, k, v, log_f, z = jx._mlstm_qkv(CFG_J, p, h)
    out, S = jls.chunked_linear_attention(q, k, v, log_f,
                                          chunk=CFG_J.ssm.chunk, normalize=True)
    b, n = x.shape[:2]
    out = jx.rms_normalize(out.reshape(b, n, -1) * jax.nn.silu(z),
                           p["norm_scale"])
    return x + out @ p["down_proj"].astype(x.dtype), S


@pytest.mark.parametrize("weights", ["float32", "served bf16"])
def test_mlstm_layer_prefill_matches_fp32(weights):
    """One mLSTM layer over 37 tokens (two chunks of 16 and a ragged third)
    in fp32 at 1e-5, with its final (nh, hd, hd + 1) state; the layer's
    training form (``apply_mlstm_train``) gives the same output. "served
    bf16": the port's weights as serving loads them (params_from_numpy at
    bf16, then widened), the reference's with the same matmul weights
    rounded and its float32 leaves exact."""
    p_np = _layer_np("mlstm")
    x = _x(1)
    if weights == "float32":
        p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    else:
        p_t = cast_weights(params_from_numpy(p_np, device="cpu"), torch.float32)
        p_np = {k: (v if k in convert.FP32_KEYS else _bf16_rounded(v))
                for k, v in p_np.items()}
    p_j = jax.tree.map(jnp.asarray, p_np)
    y_j, S_j = _mlstm_reference(p_j, jnp.asarray(x))
    assert_close(jx.apply_mlstm_train(CFG_J, p_j, jnp.asarray(x), None), y_j,
                 "float32")
    y_t, S_t = tx.apply_mlstm_prefill(CFG_T, p_t, to_torch(x))
    assert_close(y_t, y_j, "float32")
    assert tuple(S_t.shape) == (2, 2, 64, 65) and S_t.dtype == torch.float32
    assert_close(S_t, S_j, "float32")


def _slstm_reference(p, x):
    """The reference prefill's sLSTM layer (xlstm.py:258-276): the layer's
    output and its final (h, c)."""
    nh, hd = CFG_J.n_heads, CFG_J.d_model // CFG_J.n_heads
    b, n = x.shape[:2]
    hn = jx.rms_normalize(x, p["ln"]["scale"])
    pre = (hn @ p["w_in"].astype(x.dtype)).reshape(b, n, 4, nh, hd)

    def step(carry, pre_t):
        h, c = jx._slstm_cell(CFG_J, p, pre_t, *carry)
        return (h, c), h

    init = (jnp.zeros((b, nh, hd), jnp.float32),) * 2
    (hf, cf), hs = jax.lax.scan(step, init, pre.transpose(1, 0, 2, 3, 4))
    out = hs.transpose(1, 0, 2, 3).reshape(b, n, -1).astype(x.dtype)
    return x + out @ p["out_proj"].astype(x.dtype), hf, cf


def test_slstm_layer_prefill_matches_fp32():
    """One sLSTM layer over 37 tokens in fp32 at 1e-5 (the port's loop
    against the reference's ``lax.scan``), with its final h and c; the
    training form gives the same output."""
    p_np = _layer_np("slstm")
    x = _x(2)
    p_j = jax.tree.map(jnp.asarray, p_np)
    y_j, h_j, c_j = _slstm_reference(p_j, jnp.asarray(x))
    assert_close(jx.apply_slstm_train(CFG_J, p_j, jnp.asarray(x), None), y_j,
                 "float32")
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    y_t, (h_t, c_t) = tx.apply_slstm_prefill(CFG_T, p_t, to_torch(x))
    assert_close(y_t, y_j, "float32")
    assert_close(h_t, h_j, "float32")
    assert_close(c_t, c_j, "float32")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_decode_matches_fp32(kind):
    """Four decode steps of one layer from a random state, fp32: outputs
    and states at 1e-5, the states updated in place."""
    p_np = _layer_np(kind)
    p_j = jax.tree.map(jnp.asarray, p_np)
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(3)
    spec = tx.XLSTMModel(CFG_T).cache_spec(3)
    if kind == "mlstm":
        st_j = jnp.asarray(rng.randn(*spec["mlstm"][0][2:]), jnp.float32)
        st_t = to_torch(np.asarray(st_j))
        held = (st_t,)
    else:
        shape = spec["slstm_h"][0][1:]
        st_j = tuple(jnp.asarray(rng.randn(*shape), jnp.float32)
                     for _ in range(2))
        st_t = tuple(to_torch(np.asarray(s)) for s in st_j)
        held = st_t
    j_step = jx.apply_mlstm_decode if kind == "mlstm" else jx.apply_slstm_decode
    t_step = tx.apply_mlstm_decode if kind == "mlstm" else tx.apply_slstm_decode
    for _ in range(4):
        x = rng.randn(3, 1, CFG_J.d_model).astype(np.float32)
        y_j, st_j = j_step(CFG_J, p_j, jnp.asarray(x), st_j, None)
        y_t, st_t = t_step(CFG_T, p_t, to_torch(x), st_t)
        assert_close(y_t, y_j, "float32")
        for got, want, same in zip(st_t if kind == "slstm" else (st_t,),
                                   st_j if kind == "slstm" else (st_j,), held):
            assert got is same
            assert_close(got, want, "float32")


def test_bf16_w_gates_misses_the_fp32_gate():
    """The gate above is the one a bf16 ``w_gates`` would fail: rounding it
    (and only it) to bf16 moves the mLSTM layer's fp32 output by far more
    than 1e-5 of its values."""
    p_np = _layer_np("mlstm")
    x = _x(1)
    y_j, _ = _mlstm_reference(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    p_t["w_gates"] = p_t["w_gates"].bfloat16().float()
    y_t, _ = tx.apply_mlstm_prefill(CFG_T, p_t, to_torch(x))
    err = np.max(np.abs(to_np(y_t) - np.asarray(y_j)))
    assert err > 100 * 1e-5, err


@pytest.mark.parametrize("leaf", NEW_FP32_LEAVES)
def test_served_weights_keep_the_reference_fp32_leaves(leaf):
    """params_from_numpy at bf16 keeps the gates' leaves float32 and casts
    the matmul weights; the port's own init does the same."""
    stack, name = leaf
    for tp in (params_from_numpy(PARAMS_NP, device="cpu"),
               t_get_model(CFG_T).init(0, device="cpu")):
        assert tp[stack][name].dtype == torch.float32, leaf
        assert tp[stack]["ln"]["scale"].dtype == torch.float32
        matmul = "up_proj" if stack == "mlstm" else "w_in"
        assert tp[stack][matmul].dtype == torch.bfloat16
        assert tp["embed"].dtype == tp["lm_head"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen1.5-32b",
                                  "stablelm-3b", "zamba2-7b"])
def test_new_fp32_keys_move_no_dense_or_hybrid_leaf(arch):
    """The four keys this family adds to FP32_KEYS ("bias" among them, also
    a layernorm leaf's name) leave every dense and hybrid leaf's dtype as
    it was: the served weights are the same with and without them."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    params = t_get_model(cfg).init(0, device="cpu", dtype=torch.float32)
    old = tuple(k for k in convert.FP32_KEYS
                if k not in {name for _, name in NEW_FP32_LEAVES})

    def dtypes(tree):
        return {k: (dtypes(v) if isinstance(v, dict) else v.dtype)
                for k, v in tree.items()}

    new_cast = dtypes(cast_weights(params, torch.bfloat16))
    saved = convert.FP32_KEYS
    try:
        convert.FP32_KEYS = old
        assert dtypes(cast_weights(params, torch.bfloat16)) == new_cast
    finally:
        convert.FP32_KEYS = saved


def test_registry_and_model_api():
    """xlstm-1.3b is registered with the reference's config and reduced
    branch; get_model returns XLSTMModel (and the MoE, VLM and enc-dec
    families their models; an unknown family raises ValueError)."""
    full_j, full_t = get_config("xlstm-1.3b"), tconfigs.get_config("xlstm-1.3b")
    for cfg_j, cfg_t in ((full_j, full_t), (CFG_J, CFG_T)):
        for f in dataclasses.fields(cfg_t):
            want = getattr(cfg_j, f.name)
            got = getattr(cfg_t, f.name)
            if f.name == "ssm":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    model = t_get_model(CFG_T)
    assert isinstance(model, tx.XLSTMModel)
    assert (model.n_groups, model.m_per_group) == (2, 1)
    assert (tx.XLSTMModel(full_t).n_groups,
            tx.XLSTMModel(full_t).m_per_group) == (6, 7)
    for family in ("moe", "vlm", "encdec"):     # ported since
        assert t_get_model(dataclasses.replace(
            tconfigs.reduced_config(tconfigs.get_config("whisper-medium")),
            family=family)).cfg.family == family
    with pytest.raises(ValueError, match="family"):
        t_get_model(dataclasses.replace(CFG_T, family="unknown"))


@pytest.fixture(scope="module")
def reference():
    """The reference's prefill of CTX, three decode steps of three samples
    after its own state broadcast, and ServeEngine.generate's greedy tokens
    at batch 4 over 8 steps: one run each, shared by the tests below."""
    jm = j_get_model(CFG_J)
    jp = jax.tree.map(jnp.asarray, PARAMS_NP)
    l_pre, cache = jax.jit(functools.partial(jm.prefill, rules=None))(
        jp, jnp.asarray(CTX))
    je = JServeEngine(jm, CFG_J, JServeConfig(batch=3))
    c = je._broadcast_state(cache, 3)
    toks = np.random.RandomState(4).randint(0, CFG_J.vocab_size, (3, 3, 1))
    j_step = jax.jit(functools.partial(jm.decode_step, rules=None))
    steps = []
    for t in range(3):
        l_dec, c = j_step(jp, c, jnp.asarray(toks[t]))
        steps.append(np.asarray(l_dec.astype(jnp.float32)))
    je = JServeEngine(jm, CFG_J, JServeConfig(
        batch=N_SAMPLES, decode_capacity=N_STEPS, temperature=0.0))
    gen = je.generate(jp, jnp.asarray(CTX), n_steps=N_STEPS)
    return dict(prefill=np.asarray(l_pre.astype(jnp.float32)),
                cache={k: np.asarray(v) for k, v in cache.items()},
                toks=toks, steps=steps, final=np.asarray(c["mlstm"]),
                tokens=np.asarray(gen.tokens),
                logprobs=np.asarray(gen.logprobs))


def test_prefill_and_decode_steps_match(reference):
    """prefill, then three decode steps of three samples (the states
    broadcast as the serve engine does), bf16: logits every step within
    2e-2 of the largest, the cache's shapes (and a zero cache's) and its
    states within 2e-2 of their largest; no kernel launches on the CPU."""
    tm = t_get_model(CFG_T)
    tp = params_from_numpy(PARAMS_NP, device="cpu")
    n0 = [k.launches for k in KERNELS]
    l_t, c_t = tm.prefill(tp, torch.as_tensor(CTX))
    assert_close_logits(l_t, reference["prefill"], "bfloat16")
    assert c_t["position"] == CTX.shape[1]
    for name, want in reference["cache"].items():
        if name == "position":
            continue
        got = to_np(c_t[name])
        assert got.shape == want.shape and c_t[name].dtype == torch.float32
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())
    zero = tm.init_cache(3, device="cpu")    # the reference's cache spec
    spec = j_get_model(CFG_J).make_cache_spec(3, 0)
    assert {k: tuple(v.shape) for k, v in zero.items() if k != "position"} \
        == {k: v.shape for k, v in spec.items() if k != "position"}
    assert zero["position"] == 0 and zero["mlstm"].dtype == torch.float32
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(batch=3))
    c_t = te._broadcast_state(c_t, 3)
    for t in range(3):
        l_t, c_t = tm.decode_step(tp, c_t, torch.as_tensor(reference["toks"][t]),
                                  impl="kernel")
        assert_close_logits(l_t, reference["steps"][t], "bfloat16")
    assert c_t["position"] == CTX.shape[1] + 3
    want = reference["final"]
    np.testing.assert_allclose(to_np(c_t["mlstm"]), want,
                               atol=2e-2 * np.abs(want).max())
    assert [k.launches for k in KERNELS] == n0     # CPU: plain versions


def test_generate_matches_jax(reference):
    """ServeEngine.generate, greedy, batch 4, 8 steps: tokens equal the
    reference's, log-probs within 2e-2 of the largest |log-prob|."""
    tm = t_get_model(CFG_T)
    tp = params_from_numpy(PARAMS_NP, device="cpu")
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(
        batch=N_SAMPLES, decode_capacity=N_STEPS, temperature=0.0))
    r_t = te.generate(tp, torch.as_tensor(CTX), n_steps=N_STEPS)
    np.testing.assert_array_equal(to_np(r_t.tokens), reference["tokens"])
    lp_j = reference["logprobs"]
    np.testing.assert_allclose(to_np(r_t.logprobs), lp_j,
                               atol=2e-2 * np.abs(lp_j).max())


def test_broadcast_state_gives_each_sample_its_own_state():
    """After ``_broadcast_state`` every sample's states are their own
    memory: a decode step run on sample 0 alone (views into the broadcast
    cache, written in place) changes sample 0's states and leaves every
    other sample's as they were."""
    tm = t_get_model(CFG_T)
    tp = params_from_numpy(PARAMS_NP, device="cpu")
    te = TServeEngine(tm, CFG_T, tconfigs.ServeConfig(batch=4))
    _, cache = te.prefill_shared(tp, torch.as_tensor(CTX[:, :20]), 4)
    assert cache["mlstm"].shape[2] == 4 and cache["slstm_h"].shape[1] == 4
    before = {k: v.clone() for k, v in cache.items() if k != "position"}
    axis = {"mlstm": 2, "slstm_h": 1, "slstm_c": 1}
    one = {k: cache[k].narrow(ax, 0, 1) for k, ax in axis.items()}
    tm.decode_step(tp, {**one, "position": cache["position"]},
                   torch.tensor([[7]]))
    for k, ax in axis.items():
        assert not torch.equal(cache[k].narrow(ax, 0, 1),
                               before[k].narrow(ax, 0, 1)), k
        assert torch.equal(cache[k].narrow(ax, 1, 3),
                           before[k].narrow(ax, 1, 3)), k


@pytest.mark.parametrize("width", [256, 1024])
def test_plain_wide_chunked_linear_matches_jax(width):
    """Kernel #13's plain version (what the wrapper runs on CPU tensors) at
    heads past the narrow kernel's 128, up to the mLSTM's 1024: dk = dv =
    ``width`` and the normaliser column, n 70 off the chunk of 32, from an
    initial state; fp32 at 1e-5 against the reference's
    chunked_linear_attention (its normaliser, linear_scan.py:100-102), and
    one step of linear_attention_decode on the final state against the
    reference's."""
    rng = np.random.RandomState(5)
    b, n, H, dk, dv = 1, 70, 2, width, width
    q, k, v = (rng.randn(b, n, H, d).astype(np.float32) * 0.3
               for d in (dk, dk, dv))
    a = -np.log1p(np.exp(rng.randn(b, n, H) - 2.0)).astype(np.float32)
    s0 = rng.randn(b, H, dk, dv + 1).astype(np.float32)
    out_j, st_j = jls.chunked_linear_attention(
        *map(jnp.asarray, (q, k, v, a)), chunk=32, normalize=True,
        initial_state=jnp.asarray(s0))
    out_t, st_t = tcl.chunked_linear_attention(
        *map(to_torch, (q, k, v, a)), chunk=32, normalize=True,
        initial_state=to_torch(s0))
    assert tuple(out_t.shape) == (b, n, H, dv)
    assert tuple(st_t.shape) == (b, H, dk, dv + 1)
    assert_close(out_t, out_j, "float32")
    assert_close(st_t, st_j, "float32")
    step = [rng.randn(b, H, d).astype(np.float32) * 0.3 for d in (dk, dk, dv)]
    a1 = a[:, 0]
    o_j, s_j = jls.linear_attention_decode(
        *map(jnp.asarray, (*step, a1)), st_j, normalize=True)
    o_t, s_t = tls.linear_attention_decode(
        *map(to_torch, (*step, a1)), st_t.clone(), normalize=True)
    assert_close(o_t, o_j, "float32")
    assert_close(s_t, s_j, "float32")
