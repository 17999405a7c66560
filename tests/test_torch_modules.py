"""Port parity, module by module: configs, rope, norms, MLP, chunked
attention, the standard and bifurcated decode attentions, the bifurcated
cache build and the weight conversion, each against its JAX counterpart on
the same numpy inputs. Also the port's isolation guards: it imports
neither jax nor anything of the JAX package."""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_np, to_torch
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.core import attention as jatt
from repro.core import bifurcated as jbif
from repro.core.kv_cache import BifurcatedCache as JBifurcatedCache
from repro.core.rotary import apply_rope as j_rope
from repro.models import blocks as jblocks
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import attention as tatt
from repro_torch.core import bifurcated as tbif
from repro_torch.core.kv_cache import BifurcatedCache as TBifurcatedCache
from repro_torch.core.rotary import apply_rope as t_rope
from repro_torch.models import blocks as tblocks

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = ["float32", "bfloat16"]
CFG_J = j_reduced(j_get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))


def _rand(rng, shape, dtype):
    return np.asarray(jnp.asarray(rng.randn(*shape), dtype))


# ---- configs ----

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + (
    "paper-7b-mh", "paper-7b-gqa", "paper-1b-mh", "paper-1b-mg", "paper-1b-mq"))
def test_configs_and_derived_props_match(arch):
    for reduce in (False, True):
        cj, ct = j_get_config(arch), tconfigs.get_config(arch)
        if reduce:
            cj, ct = j_reduced(cj), tconfigs.reduced_config(ct)
        dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
        assert {k: dj[k] for k in dt} == dt
        # the fields only other families read stay at their defaults
        assert all(not dj[k] for k in set(dj) - set(dt)), set(dj) - set(dt)
        for prop in ("kq_dim", "n_heads_padded", "n_kv_heads_padded",
                     "padded_vocab", "group_size", "param_count_estimate"):
            assert getattr(cj, prop) == getattr(ct, prop), prop


def test_serve_config_defaults_match():
    from repro.configs import ServeConfig as JServe
    assert dataclasses.asdict(JServe()) == dataclasses.asdict(tconfigs.ServeConfig())


# ---- rope / norms / mlp ----

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.RandomState(0)
    x = _rand(rng, (2, 7, 3, 16), "float32")
    pos = np.arange(5, 12)
    assert_close(t_rope(to_torch(x), torch.as_tensor(pos), theta),
                 j_rope(jnp.asarray(x), jnp.asarray(pos), theta), "float32")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_matches(norm, dtype):
    cj = dataclasses.replace(CFG_J, norm=norm)
    ct = dataclasses.replace(CFG_T, norm=norm)
    rng = np.random.RandomState(1)
    x = _rand(rng, (2, 5, 64), dtype)
    p = {"scale": rng.rand(64).astype(np.float32) + 0.5,
         "bias": rng.randn(64).astype(np.float32)}
    want = jblocks.apply_norm(cj, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = tblocks.apply_norm(ct, {k: to_torch(v) for k, v in p.items()},
                             to_torch(x))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_matches(act, dtype):
    cj = dataclasses.replace(CFG_J, act=act)
    ct = dataclasses.replace(CFG_T, act=act)
    rng = np.random.RandomState(2)
    p = jax.tree.map(np.asarray, jblocks.init_mlp(cj, jax.random.PRNGKey(0)))
    x = _rand(rng, (2, 3, 64), dtype)
    want = jblocks.apply_mlp(cj, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x), None)
    got = tblocks.apply_mlp(ct, {k: to_torch(v) for k, v in p.items()},
                            to_torch(x))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_attention_matches(window, dtype):
    rng = np.random.RandomState(3)
    q = _rand(rng, (2, 11, 4, 16), dtype)
    k = _rand(rng, (2, 11, 2, 16), dtype)
    v = _rand(rng, (2, 11, 2, 16), dtype)
    want = jblocks.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window, chunk=4)
    got = tblocks.chunked_attention(to_torch(q), to_torch(k), to_torch(v),
                                    window=window, chunk=4)
    assert_close(got, want, dtype)


# ---- decode attentions ----

def _bif_case(dtype, layout="mgk", seed=4, b=3, p=2, n=1, m_c=37, c_d=6):
    rng = np.random.RandomState(seed)
    ctx = (m_c, 2, 16) if layout == "mgk" else (2, m_c, 16)
    arrs = [_rand(rng, (b, 2, p, n, 16), dtype), _rand(rng, ctx, dtype),
            _rand(rng, ctx, dtype), _rand(rng, (b, c_d, 2, 16), dtype),
            _rand(rng, (b, c_d, 2, 16), dtype)]
    lens = rng.randint(1, c_d + 1, size=b)
    mask = np.arange(c_d)[None, :] < lens[:, None]
    ctx_mask = np.arange(m_c) > 10
    return arrs, mask, ctx_mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_ctx_mask", [False, True])
def test_bifurcated_attention_matches(dtype, use_ctx_mask):
    arrs, mask, ctx_mask = _bif_case(dtype)
    cm = ctx_mask if use_ctx_mask else None
    want = jbif.bifurcated_attention(
        *map(jnp.asarray, arrs), decode_mask=jnp.asarray(mask),
        context_mask=None if cm is None else jnp.asarray(cm))
    got = tbif.bifurcated_attention(
        *map(to_torch, arrs), decode_mask=torch.as_tensor(mask),
        context_mask=None if cm is None else torch.as_tensor(cm))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["mgk", "gmk"])
def test_bifurcated_attention_flash_matches(dtype, layout):
    arrs, mask, ctx_mask = _bif_case(dtype, layout, n=2)
    want = jbif.bifurcated_attention_flash(
        *map(jnp.asarray, arrs), decode_mask=jnp.asarray(mask),
        context_mask=jnp.asarray(ctx_mask), ctx_layout=layout)
    got = tbif.bifurcated_attention_flash(
        *map(to_torch, arrs), decode_mask=torch.as_tensor(mask),
        context_mask=torch.as_tensor(ctx_mask), ctx_layout=layout)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches(dtype):
    rng = np.random.RandomState(5)
    q = _rand(rng, (3, 2, 2, 1, 16), dtype)
    k = _rand(rng, (3, 20, 2, 16), dtype)
    v = _rand(rng, (3, 20, 2, 16), dtype)
    valid = np.broadcast_to(np.arange(20)[None] < 13, (3, 20)).copy()
    want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), valid_mask=jnp.asarray(valid))
    got = tatt.decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                valid_mask=torch.as_tensor(valid))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("layout", ["gmk", "mgk"])
def test_bifurcated_cache_from_prefill_matches(layout):
    rng = np.random.RandomState(6)
    k = _rand(rng, (2, 9, 2, 16), "bfloat16")
    v = _rand(rng, (2, 9, 2, 16), "bfloat16")
    cj = JBifurcatedCache.from_prefill(jnp.asarray(k), jnp.asarray(v), 4, 5,
                                       ctx_layout=layout)
    ct = TBifurcatedCache.from_prefill(to_torch(k), to_torch(v), 4, 5,
                                       ctx_layout=layout)
    for name in ("k_ctx", "v_ctx", "k_dec", "v_dec"):
        a, b = getattr(cj, name), getattr(ct, name)
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(b), to_np(a))
    assert (ct.context_len, ct.decode_capacity, ct.dec_length) == (9, 5, 0)


def test_params_from_numpy_keeps_tree_and_values():
    from repro.models import get_model as j_get_model
    params = j_get_model(CFG_J).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tree["layers"]["attn"]["wq"] = np.asarray(
        jnp.asarray(tree["layers"]["attn"]["wq"], jnp.bfloat16))
    out = params_from_numpy(tree, device="cpu", dtype=None)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_j:
        node = out
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(to_np(node), to_np(leaf))
    cast = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32
    assert cast["final_norm"]["scale"].dtype == torch.float32


# ---- isolation guards ----

def test_port_imports_no_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_port_sources_name_no_jax_or_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            s = line.strip()
            if (s.startswith(("import repro.", "from repro.", "import jax",
                              "from jax"))
                    or s in ("import repro", "from repro import")):
                bad.append(f"{f.relative_to(ROOT)}:{i}: {s}")
    assert not bad, bad


def test_init_matches_reference_shapes_and_scale():
    """The port's stand-alone seeded init: the reference's tree, shapes and
    scale (normal / sqrt(fan_in)); matmul weights bf16, norms f32."""
    from repro.models import get_model as j_get_model
    from repro_torch.models import get_model as t_get_model
    jp = j_get_model(CFG_J).init(jax.random.PRNGKey(0))
    tp = t_get_model(CFG_T).init(0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_t = 0
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        norm = any(k.key in ("ln1", "ln2", "final_norm") for k in path)
        assert node.dtype == (torch.float32 if norm else torch.bfloat16), path
        if not norm:
            std_j, std_t = float(jnp.std(leaf)), float(node.float().std())
            assert abs(std_t / std_j - 1) < 0.1, (path, std_t, std_j)
        n_t += 1
    assert n_t == len(flat_j)
    again = t_get_model(CFG_T).init(0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])   # seeded
