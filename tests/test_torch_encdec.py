"""Port parity for the encoder-decoder family (whisper-medium, reduced: 2
encoder and 2 decoder layers, learned positions, layernorm, gelu, a tied
unembedding) on weights converted from the JAX reference's own
initialisation: the non-causal and cross attention of ``blocks`` (chunked
and flash), ``encode``, ``prefill`` with a bifurcated and a standard cache,
decode steps over a bf16 and an int8 self-attention context, and
``ServeEngine.generate`` with ``frames`` / ``sample_batch``.

The reference's encoder-decoder computes in bf16 whatever its weights
(``repro/models/encdec.py`` casts the frames, ``frame_proj`` and the
embeddings to bf16, and builds its bifurcated cache in bf16); the port's
activation dtype is its weights'. So the fp32 cases patch the reference
module inside the test (its ``jnp.bfloat16`` read as float32, its
bifurcated cache built in float32): nothing of ``src/repro`` changes.
Tolerances: fp32 1e-5, bf16 2e-2 of the largest logit (``_torch_parity``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config, reduced_config
from repro.core import quantized as jq
from repro.core.policy import BifurcationPolicy as JPolicy
from repro.models import blocks as jblocks
from repro.models import encdec as jencdec
from repro.models import get_model as j_get_model
from repro.runtime.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache
from repro_torch.core.policy import BifurcationPolicy as TPolicy
from repro_torch.core.quantized import QuantBifurcatedCache
from repro_torch.models import blocks as tblocks
from repro_torch.models import get_model as t_get_model
from repro_torch.models.encdec import EncDecModel
from repro_torch.runtime.serve import ServeEngine

CFG_J = reduced_config(get_config("whisper-medium"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("whisper-medium"))
PARAMS_NP = jax.tree.map(np.asarray, j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
CTX = np.random.RandomState(0).randint(0, CFG_J.vocab_size, (1, 12))
FRAMES = (np.random.RandomState(1).randn(1, 16, CFG_J.d_model) * 0.02
          ).astype(np.float32)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Fp32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as float32."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def fp32_reference(monkeypatch):
    """The reference's encoder-decoder computing in float32: its module's
    bf16 casts and its bifurcated cache's dtype, patched for this test."""
    monkeypatch.setattr(jencdec, "jnp", _Fp32Numpy())
    real = jq.ctx_cache_family

    def family(ctx_quant="none"):
        fam = real(ctx_quant)

        class Fp32:
            @staticmethod
            def from_prefill(*a, **kw):
                return fam.from_prefill(*a, dtype=jnp.float32, **kw)

        return Fp32

    monkeypatch.setattr(jq, "ctx_cache_family", family)


def _models(dtype):
    jm, tm = j_get_model(CFG_J), t_get_model(CFG_T)
    return (jm, jax.tree.map(jnp.asarray, PARAMS_NP), tm,
            params_from_numpy(PARAMS_NP, device="cpu", dtype=TORCH_DT[dtype]))


def _rand(rng, shape, dtype):
    return np.asarray(jnp.asarray(rng.randn(*shape), jnp.dtype(dtype)))


# ---- attention ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [23, 9])
def test_non_causal_attention_matches_reference(dtype, m):
    """Non-causal chunked and flash attention of 19 queries over m keys
    (an encoder when m = n, a cross-attention otherwise; the flash path's
    ragged last key block masked) against the reference's, in chunks of
    8 queries and, for flash, blocks of 8 keys."""
    rng = np.random.RandomState(2)
    q = _rand(rng, (2, 19, 4, 16), dtype)
    k, v = (_rand(rng, (2, m, 2, 16), dtype) for _ in range(2))
    oj = jblocks.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=False, chunk=8)
    ot = tblocks.chunked_attention(*map(to_torch, (q, k, v)), causal=False,
                                   chunk=8)
    assert_close(ot, oj, dtype)
    fj = jblocks.flash_chunked_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=False, q_chunk=8, kv_chunk=8)
    ft = tblocks.flash_chunked_attention(*map(to_torch, (q, k, v)),
                                         causal=False, q_chunk=8, kv_chunk=8)
    assert_close(ft, fj, dtype)
    with pytest.raises(ValueError, match="window"):
        tblocks.chunked_attention(*map(to_torch, (q, k, v)), causal=False,
                                  window=4)


@pytest.mark.parametrize("train_attn", ["chunked", "flash"])
def test_cross_attention_train_matches_reference(train_attn):
    """attention_train with x_kv (no rope, m != n) and causal=False, on the
    decoder's xattn weights, fp32."""
    cj = dataclasses.replace(CFG_J, train_attn=train_attn)
    ct = dataclasses.replace(CFG_T, train_attn=train_attn)
    p_np = jax.tree.map(lambda a: np.array(a[0]), PARAMS_NP["dec_layers"]["xattn"])
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, cj.d_model).astype(np.float32)
    mem = rng.randn(2, 11, cj.d_model).astype(np.float32)
    oj = jblocks.attention_train(cj, jax.tree.map(jnp.asarray, p_np),
                                 jnp.asarray(x), rules=None, causal=False,
                                 x_kv=jnp.asarray(mem))
    p_t = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    ot = tblocks.attention_train(ct, p_t, torch.as_tensor(x), causal=False,
                                 x_kv=torch.as_tensor(mem))
    assert_close(ot, oj, "float32")


# ---- the model ----

def test_encode_matches_reference_fp32(fp32_reference):
    jm, jp, tm, tp = _models("float32")
    mj = jm.encode(jp, jnp.asarray(FRAMES), None)
    mt = tm.encode(tp, torch.as_tensor(FRAMES))
    assert mt.dtype == torch.float32
    assert_close(mt, mj, "float32")


@pytest.mark.parametrize("bifurcated", [True, False])
def test_prefill_matches_reference_fp32(fp32_reference, bifurcated):
    """Prefill logits, the decoder's self K/V (its context arm, or the
    standard cache padded to n + dec_capacity) and the cross K/V (sample
    0's, unbatched, or per sample) in fp32."""
    jm, jp, tm, tp = _models("float32")
    kw = dict(bifurcated=bifurcated, dec_capacity=5, sample_batch=3)
    lj, cj = jm.prefill(jp, jnp.asarray(CTX), None, frames=jnp.asarray(FRAMES),
                        **kw)
    lt, ct = tm.prefill(tp, torch.as_tensor(CTX),
                        frames=torch.as_tensor(FRAMES), **kw)
    assert_close(lt, lj, "float32")
    for name in ("cross_k", "cross_v"):
        assert tuple(ct[name].shape) == cj[name].shape
        assert_close(ct[name], cj[name], "float32")
    if bifurcated:
        assert isinstance(ct["self"], BifurcatedCache)
        assert tuple(ct["self"].k_dec.shape) == (2, 3, 5, 4, 16)
        for name in ("k_ctx", "v_ctx"):
            assert_close(getattr(ct["self"], name), getattr(cj["self"], name),
                         "float32")
    else:
        assert isinstance(ct["self"], DecodeCache)
        assert ct["self"].length == 12
        assert_close(ct["self"].k, cj["self"].k, "float32")
        assert_close(ct["self"].v, cj["self"].v, "float32")


@pytest.mark.parametrize("ctx_quant", ["none", "int8"])
def test_decode_with_bf16_and_int8_self_cache_matches_reference(ctx_quant):
    """The reference's tests/test_quantized.py case, port against
    reference: bf16 weights as served, a bifurcated self cache with a bf16
    or int8 context arm, two decode steps on the kernel path of 3 samples
    over the unbatched cross K/V; logits within 2e-2 of the largest, and
    the int8 path within the reference's 0.1 of the bf16 one."""
    jm, jp, tm, tp = _models("bfloat16")
    rng = np.random.RandomState(6)
    cont = rng.randint(0, CFG_J.vocab_size, (3, 2))
    kw = dict(bifurcated=True, sample_batch=3, ctx_quant=ctx_quant)
    _, cj = jm.prefill(jp, jnp.asarray(CTX), None, frames=jnp.asarray(FRAMES),
                       **kw)
    _, ct = tm.prefill(tp, torch.as_tensor(CTX),
                       frames=torch.as_tensor(FRAMES), **kw)
    _, c_bf = tm.prefill(tp, torch.as_tensor(CTX),
                         frames=torch.as_tensor(FRAMES), bifurcated=True,
                         sample_batch=3)
    if ctx_quant == "int8":
        assert isinstance(ct["self"], QuantBifurcatedCache)
        assert ct["self"].k_ctx.dtype == torch.int8
    for t in range(2):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(cont[:, t:t + 1]), None,
                                impl="kernel")
        lt, ct = tm.decode_step(tp, ct, torch.as_tensor(cont[:, t:t + 1]),
                                impl="kernel")
        lb, c_bf = tm.decode_step(tp, c_bf, torch.as_tensor(cont[:, t:t + 1]),
                                  impl="kernel")
        assert_close_logits(lt, lj, "bfloat16")
        scale = float(lb.float().abs().max())
        assert float((lt.float() - lb.float()).abs().max()) < 0.1 * max(scale, 1.0)
    assert ct["self"].dec_length == 2
    assert type(ct["self"]) is (QuantBifurcatedCache if ctx_quant == "int8"
                                else BifurcatedCache)


@pytest.mark.parametrize("bifurcated", [True, False])
def test_generate_with_frames_matches_reference_fp32(fp32_reference,
                                                      bifurcated):
    """ServeEngine.generate with frames (and sample_batch when bifurcated,
    as the CLI passes it): greedy tokens equal to the reference's and
    log-probs within 1e-5, on the bifurcated cache (kernel path) and on
    the policy's standard fallback (the cache copied per sample)."""
    jm, jp, tm, tp = _models("float32")
    kw = dict(batch=3, decode_capacity=8, temperature=0.0, use_kernel=True)
    thr = 0 if bifurcated else 1 << 40
    je = JServeEngine(jm, CFG_J, JServeConfig(**kw),
                      policy=JPolicy(min_io_saving_bytes=thr))
    te = ServeEngine(tm, CFG_T, tconfigs.ServeConfig(**kw),
                     policy=TPolicy(min_io_saving_bytes=thr))
    extra = {"sample_batch": 3} if bifurcated else {}
    rj = je.generate(jp, jnp.asarray(CTX), n_steps=5,
                     frames=jnp.asarray(FRAMES), **extra)
    rt = te.generate(tp, torch.as_tensor(CTX), n_steps=5,
                     frames=torch.as_tensor(FRAMES), **extra)
    np.testing.assert_array_equal(to_np(rt.tokens), np.asarray(rj.tokens))
    assert_close(rt.logprobs, rj.logprobs, "float32")
    _, cache = te.prefill_shared(tp, torch.as_tensor(CTX), 3,
                                 frames=torch.as_tensor(FRAMES), **extra)
    if bifurcated:
        assert isinstance(cache["self"], BifurcatedCache)
        assert cache["cross_k"].dim() == 4         # (L, m_enc, g, hd)
    else:
        assert tuple(cache["self"].k.shape[:3]) == (2, 3, 12 + 8)
        assert tuple(cache["cross_k"].shape[:3]) == (2, 3, 16)


def test_model_api_and_init():
    """get_model serves the encdec family with EncDecModel; its seeded
    init has the reference's tree and shapes, matmul weights and position
    tables bf16, norms float32."""
    assert isinstance(t_get_model(CFG_T), EncDecModel)
    tp = t_get_model(CFG_T).init(0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(PARAMS_NP)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        norm = any(k.key in ("ln1", "ln2", "ln_x", "enc_norm", "final_norm")
                   for k in path)
        assert node.dtype == (torch.float32 if norm else torch.bfloat16), path
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    with pytest.raises(ValueError):
        EncDecModel(tconfigs.reduced_config(tconfigs.get_config("dbrx-132b")))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
