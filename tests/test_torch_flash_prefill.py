"""Port parity for kernel #12, flash prefill attention, and the paths that
run it under ``ModelConfig.train_attn="flash"``: the plain version
(``kernels/flash_prefill.flash_prefill_attention_plain``, what the wrapper
runs on CPU tensors) against the reference's Pallas kernel in interpret mode
over its whole ``PREFILL_SWEEP`` (``tests/test_kernels.py``), and with a
query offset against the reference's ``flash_chunked_attention(q_offset=)``;
the port's ``flash_chunked_attention`` against the reference's; the
wrapper's rules; the model's ``prefill`` and ``prefill_suffix`` and
``ServeEngine.generate`` against the reference's model with the same config;
and every engine's prefill going through #12 (its plain version here) and
nothing else.

Tolerances are the reference tests' own: fp32 1e-5; bf16 2e-2 of the
largest |value| (``_torch_parity``: the Pallas kernel and the plain version
both keep fp32 logits, while the reference's ``flash_chunked_attention``
rounds its bf16 einsums)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.kernels.flash_prefill import flash_prefill_attention as j_flash
from repro.models import blocks as jblocks
from repro.models import get_model as j_get_model
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import flash_prefill as tfp
from repro_torch.models import blocks as tblocks
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import (
    ForestServeEngine,
    ServeEngine,
    TreeServeEngine,
)

# the reference's sweep (tests/test_kernels.py):
# (b, n, m, h, g, hd, block_q, block_k, causal, window)
PREFILL_SWEEP = [
    (1, 64, 64, 4, 2, 16, 16, 16, True, 0),
    (2, 100, 100, 4, 4, 32, 32, 16, True, 0),     # MHA, ragged
    (2, 128, 128, 8, 1, 64, 64, 64, True, 0),     # MQA
    (1, 96, 96, 4, 2, 16, 32, 32, True, 20),      # SWA
    (2, 80, 80, 2, 2, 80, 16, 16, False, 0),      # encoder (bidir), hd=80
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, n, m, h, g, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    jdt = DTYPES[dtype][0]
    return [np.asarray(jnp.asarray(rng.randn(*s), jdt))
            for s in ((b, n, h, hd), (b, m, g, hd), (b, m, g, hd))]


def _assert_within(got, want, dtype):
    """fp32 elementwise to 1e-5; bf16 to 2e-2 of max |want|."""
    if dtype == "float32":
        return assert_close(got, want, dtype)
    g, w = to_np(got), to_np(want)
    assert np.max(np.abs(g - w)) <= 2e-2 * np.max(np.abs(w))


@pytest.mark.parametrize("case", PREFILL_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(case, dtype):
    b, n, m, h, g, hd, bq, bk, causal, window = case
    q, k, v = _qkv(b, n, m, h, g, hd, dtype, sum(case))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, block_q=bq, block_k=bk,
                   interpret=True)
    got = tfp.flash_prefill_attention_plain(
        to_torch(q), to_torch(k), to_torch(v), causal=causal, window=window,
        block_q=bq, block_k=bk)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, n, h, hd)
    _assert_within(got, want, dtype)


# (b, n, m, h, g, hd, q_offset, window, block_q, block_k): a suffix of n
# queries at q_offset over m = q_offset + n keys, offsets off the blocks
OFFSET_CASES = [
    (2, 37, 100, 4, 2, 16, 63, None, 16, 32),
    (1, 50, 133, 4, 1, 32, 83, 20, 32, 16),      # MQA, window, ragged
    (2, 1, 70, 4, 2, 16, 69, 8, 16, 16),         # one query row
]


@pytest.mark.parametrize("case", OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_offset_matches_reference_flash_chunked(case, dtype):
    """Query row i at position q_offset + i: the plain version and the
    port's ``flash_chunked_attention`` against the reference's."""
    b, n, m, h, g, hd, off, window, bq, bk = case
    q, k, v = _qkv(b, n, m, h, g, hd, dtype, off)
    want = jblocks.flash_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_chunk=bq, kv_chunk=bk, q_offset=off)
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    got = tfp.flash_prefill_attention_plain(
        tq, tk, tv, causal=True, window=window or 0, q_offset=off,
        block_q=bq, block_k=bk)
    _assert_within(got, want, dtype)
    got = tblocks.flash_chunked_attention(tq, tk, tv, causal=True,
                                          window=window, q_chunk=bq,
                                          kv_chunk=bk, q_offset=off)
    _assert_within(got, want, dtype)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_chunked_attention_matches_reference(causal, window):
    """The port's counterpart of ``blocks.flash_chunked_attention`` at its
    default chunking, causal, windowed and bidirectional, fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        q, k, v = _qkv(2, 70, 70, 4, 2, 16, dtype, 5)
        want = jblocks.flash_chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_chunk=32, kv_chunk=16)
        got = tblocks.flash_chunked_attention(
            to_torch(q), to_torch(k), to_torch(v), causal=causal,
            window=window, q_chunk=32, kv_chunk=16)
        _assert_within(got, want, dtype)


def test_wrapper_rules():
    """A window needs causal=True (ValueError: the reference's two
    non-causal windowed masks differ); k and v must have q's dtype
    (TypeError); shapes must fit; on the CPU nothing launches."""
    q, k, v = (to_torch(x) for x in _qkv(1, 8, 8, 4, 2, 16, "float32", 0))
    f = tfp.flash_prefill_attention
    launches = f.launches
    with pytest.raises(ValueError, match="causal"):
        f(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="causal"):
        tblocks.flash_chunked_attention(q, k, v, causal=False, window=4)
    with pytest.raises(TypeError, match="dtype"):
        f(q, k.double(), v.double())
    with pytest.raises(ValueError, match="multiple"):
        f(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match=">= 0"):
        f(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="contiguous"):
        f(q.transpose(1, 2), k, v)
    assert f(q, k, v).shape == q.shape and f.launches == launches


# ---- the model and the engines under train_attn="flash" ----

CFG_J = dataclasses.replace(reduced_config(get_config("internlm2-1.8b")),
                            train_attn="flash")
CFG_T = dataclasses.replace(
    tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b")),
    train_attn="flash")
PARAMS_NP = jax.tree.map(np.asarray,
                         j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 40))


def _models(dtype, cj=CFG_J, ct=CFG_T, params=PARAMS_NP):
    """(jax model, jax params, torch model, torch params); fp32 patches
    the embedding on both sides so the whole forward runs in fp32."""
    jm, tm = j_get_model(cj), t_get_model(ct)
    if dtype == "float32":
        jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
        tm._embed = lambda p, t: p["embed"][t]
    return (jm, jax.tree.map(jnp.asarray, params), tm,
            params_from_numpy(params, device="cpu",
                              dtype=DTYPES[dtype][1]))


class Spy:
    """Counts the prefill attention calls: #12's plain version (what
    ``flash_chunked_attention`` runs on CPU tensors) and the chunked
    path."""

    def __init__(self, monkeypatch):
        self.flash = self.chunked = 0
        plain, chunked = (tfp.flash_prefill_attention_plain,
                          tblocks.chunked_attention)

        def flash_spy(*a, **kw):
            self.flash += 1
            return plain(*a, **kw)

        def chunked_spy(*a, **kw):
            self.chunked += 1
            return chunked(*a, **kw)

        monkeypatch.setattr(tblocks, "flash_prefill_attention_plain",
                            flash_spy)
        monkeypatch.setattr(tblocks, "chunked_attention", chunked_spy)

    def take(self):
        out = (self.flash, self.chunked)
        self.flash = self.chunked = 0
        return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_suffix_prefill_match_reference(dtype, monkeypatch):
    """``prefill`` of 40 tokens, then ``prefill_suffix`` of its last 13 over
    the first 27's K/V (q_offset 27): logits and K/V against the
    reference's model under train_attn="flash"; each runs #12 once per
    layer and the chunked path never."""
    spy = Spy(monkeypatch)
    jm, jp, tm, tp = _models(dtype)
    lj, cj = jm.prefill(jp, jnp.asarray(CTX), None)
    lt, ct = tm.prefill(tp, torch.as_tensor(CTX))
    assert spy.take() == (CFG_T.n_layers, 0)
    assert_close_logits(lt, lj, dtype)
    if dtype == "float32":
        assert_close(ct.k, cj.k, dtype)
        assert_close(ct.v, cj.v, dtype)
    cut = 27
    lsj, sj = jm.prefill_suffix(jp, jnp.asarray(CTX[:, cut:]),
                                cj.k[:, :, :cut], cj.v[:, :, :cut], None,
                                start=cut)
    lst, st = tm.prefill_suffix(tp, torch.as_tensor(CTX[:, cut:]),
                                ct.k[:, :, :cut], ct.v[:, :, :cut], start=cut)
    assert spy.take() == (CFG_T.n_layers, 0)
    assert_close_logits(lst, lsj, dtype)
    assert st.length == 40
    if dtype == "float32":
        assert_close(st.k, sj.k, dtype)
        assert_close(st.v, sj.v, dtype)
        assert_close(lst, lt, dtype)      # the suffix's logits = the whole's


def test_sliding_window_prefill_matches_reference():
    """h2o-danube's sliding window (8 in the reduced config) over a
    40-token prefill and a 13-token suffix, fp32, under flash."""
    cj = dataclasses.replace(reduced_config(get_config("h2o-danube-1.8b")),
                             train_attn="flash")
    ct = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("h2o-danube-1.8b")),
        train_attn="flash")
    assert ct.sliding_window == 8
    p_np = jax.tree.map(np.asarray,
                        j_get_model(cj).init(jax.random.PRNGKey(1)))
    jm, jp, tm, tp = _models("float32", cj, ct, p_np)
    lj, cache_j = jm.prefill(jp, jnp.asarray(CTX), None)
    lt, cache_t = tm.prefill(tp, torch.as_tensor(CTX))
    assert_close(lt, lj, "float32")
    assert_close(cache_t.k, cache_j.k, "float32")
    lsj, _ = jm.prefill_suffix(jp, jnp.asarray(CTX[:, 27:]),
                               cache_j.k[:, :, :27], cache_j.v[:, :, :27],
                               None, start=27)
    lst, _ = tm.prefill_suffix(tp, torch.as_tensor(CTX[:, 27:]),
                               cache_t.k[:, :, :27], cache_t.v[:, :, :27],
                               start=27)
    assert_close(lst, lsj, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_reference(dtype):
    """``ServeEngine.generate`` on the bifurcated kernel path with a flash
    prefill: fp32 greedy tokens and log-probs equal the reference's; bf16
    log-probs within 2e-2 of the largest."""
    jm, jp, tm, tp = _models(dtype)
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, bifurcated=True,
              use_kernel=True)
    je = JServeEngine(jm, CFG_J, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=0))
    te = ServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw),
                     policy=TPolicy(min_io_saving_bytes=0))
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=5)
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=5)
    if dtype == "float32":
        np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
        assert_close(rt.logprobs, rj.logprobs, dtype)
    else:
        assert_close_logits(rt.logprobs, rj.logprobs, dtype)


def test_every_engine_prefills_through_flash(monkeypatch):
    """Under train_attn="flash" every prefill of the three engines runs #12
    once per layer and nothing else: ServeEngine.prefill_shared, the
    forest's admission, the trie's synchronous admission and its suffix
    admission; a packed step on the paged kernel path prefills its chunk
    on the packed kernel (#10/#11), not on #12."""
    spy = Spy(monkeypatch)
    _, _, tm, tp = _models("bfloat16")      # the engines' stores are bf16
    n_layers = CFG_T.n_layers
    te = ServeEngine(tm, CFG_T, tconfigs.ServeConfig(batch=2,
                                                     decode_capacity=4))
    te.prefill_shared(tp, torch.as_tensor(CTX), 2)
    assert spy.take() == (n_layers, 0)
    fe = ForestServeEngine(tm, CFG_T, tconfigs.ForestConfig(
        n_groups=2, slots=4, ctx_capacity=48, decode_capacity=8))
    fs = fe.init_state(device="cpu")
    fe.admit(tp, fs, torch.as_tensor(CTX), 2)
    assert spy.take() == (n_layers, 0)
    sys_, leaf_a, leaf_b = CTX[:, :20], CTX[:, 20:31], CTX[:, 31:]
    tcfg = dict(n_nodes=4, depth=2, slots=4, node_capacity=32,
                decode_capacity=8, suffix_prefill=True)
    tr = TreeServeEngine(tm, CFG_T, tconfigs.TreeConfig(**tcfg))
    ts = tr.init_state(device="cpu")
    ts, _ = tr.admit(tp, ts, [torch.as_tensor(sys_),
                              torch.as_tensor(leaf_a)], 1)
    assert spy.take() == (n_layers, 0)           # whole path, no match
    ts, _ = tr.admit(tp, ts, [torch.as_tensor(sys_),
                              torch.as_tensor(leaf_b)], 1)
    assert spy.take() == (n_layers, 0)           # suffix over SYS's K/V
    pk = TreeServeEngine(tm, CFG_T, tconfigs.TreeConfig(
        **tcfg, ctx_store="paged", page_size=8, use_kernel=True,
        step_mode="packed", prefill_chunk=8))
    ps = pk.init_state(device="cpu")
    ps, _ = pk.admit(tp, ps, [torch.as_tensor(sys_)], 1)
    launches = [k.launches for k in tbd.KERNELS]
    ps = pk.step_chunk(tp, ps, 4)
    assert spy.take() == (0, 0) and not pk._pending
    assert [k.launches for k in tbd.KERNELS] == launches   # CPU: plain
