"""Shared harness for the port's serving-layer parity tests
(tests/test_torch_{frontend,recovery,scheduler}.py).

``Twin("jax")`` and ``Twin("torch")`` expose the same surface over the
reference (``repro``) and the port (``repro_torch``): the serving modules,
engine factories and token conversion, on the reference recovery tests'
tiny model (2 layers, d 32, vocab 64) with the JAX weights converted to
the port. Both run in fp32: the forward's bf16 embedding cast is patched
out and every engine's ``init_state`` builds fp32 stores in place of the
bf16 ones, so greedy tokens are compared exactly (log-probs to 1e-5, int8
nodes to 1e-3: a K/V value at a round-half-even boundary may quantize to a
neighbouring int8 value on the two sides). A scenario is written once as a
function of a ``Twin`` and run on both; ``summary`` is what the two runs
must agree on."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parity  # noqa: F401  (one intra-op thread)
from repro.configs.base import ForestConfig as JForestConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TreeConfig as JTreeConfig
from repro.core import paged as jpaged
from repro.core import quantized as jq
from repro.models import get_model as j_get_model
from repro_torch.configs.base import ForestConfig as TForestConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import TreeConfig as TTreeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import paged as tpaged
from repro_torch.models import get_model as t_get_model

TINY = dict(name="recovery-test", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
            vocab_pad_multiple=16, decode_capacity=8)
CFG_J = JModelConfig(**TINY)
CFG_T = TModelConfig(**TINY)

# the reference recovery tests' token draws
RNG = np.random.RandomState(0)
SYS_TOKS = RNG.randint(0, 64, (1, 12))
REQ_TOKS = [RNG.randint(0, 64, (1, 7)) for _ in range(4)]
ALT_TOKS = RNG.randint(0, 64, (1, 12))
SHARED_REQ_TOKS = [RNG.randint(0, 64, (1, 7)) for _ in range(6)]

TREE_KW = dict(n_nodes=6, depth=2, slots=4, node_capacity=16,
               decode_capacity=8, temperature=0.0, page_size=8, num_pages=8)
FOREST_KW = dict(n_groups=3, slots=4, ctx_capacity=24, decode_capacity=8,
                 temperature=0.0, page_size=8, num_pages=10)


@functools.lru_cache(maxsize=None)
def _jax_model_params():
    model = j_get_model(CFG_J)
    params = model.init(jax.random.PRNGKey(0))
    model._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    return model, params


@functools.lru_cache(maxsize=None)
def _torch_model_params():
    _, jparams = _jax_model_params()
    model = t_get_model(CFG_T)
    model._embed = lambda p, t: p["embed"][t]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    return model, params


def _jax_fp32_state(eng, init_state):
    """The reference engine's state with fp32 stores in place of bf16."""
    st = init_state()
    ecfg, cfg = eng.ecfg, CFG_J
    quant = "int8" if ecfg.cache_dtype == "int8" else "none"
    g, hd, L = cfg.n_kv_heads_padded, cfg.kq_dim, cfg.n_layers
    tree = hasattr(eng, "tcfg")
    if tree and eng.paged:
        cache = jpaged.PagedPrefixTreeCache.init(
            L, ecfg.n_nodes, ecfg.depth, ecfg.slots, ecfg.node_capacity,
            ecfg.decode_capacity, g, hd, dtype=jnp.float32,
            page_m=ecfg.page_size, num_pages=eng.num_pages, ctx_quant=quant)
    elif tree:
        cache = jq.tree_cache_family(quant).init(
            L, ecfg.n_nodes, ecfg.depth, ecfg.slots, ecfg.node_capacity,
            ecfg.decode_capacity, g, hd, dtype=jnp.float32,
            ctx_layout=cfg.ctx_layout)
    elif eng.paged:
        cache = jpaged.PagedGroupedBifurcatedCache.init(
            L, ecfg.n_groups, ecfg.slots, ecfg.ctx_capacity,
            ecfg.decode_capacity, g, hd, dtype=jnp.float32,
            page_m=ecfg.page_size, num_pages=eng.num_pages, ctx_quant=quant)
    else:
        cache = jq.forest_cache_family(quant).init(
            L, ecfg.n_groups, ecfg.slots, ecfg.ctx_capacity,
            ecfg.decode_capacity, g, hd, dtype=jnp.float32,
            ctx_layout=cfg.ctx_layout)
    return dataclasses.replace(st, cache=cache)


def _torch_fp32_state(eng, init_state, device="cpu"):
    """The port engine's state with fp32 stores in place of bf16."""
    st = init_state(device=device)
    model = eng.model
    ecfg, cfg = eng.ecfg, CFG_T
    quant = "int8" if ecfg.cache_dtype == "int8" else "none"
    tree = hasattr(eng, "tcfg")
    if tree and eng.paged:
        cache = model.make_paged_cache(
            ecfg.slots, ecfg.n_nodes, ecfg.depth, ecfg.node_capacity,
            page_m=ecfg.page_size, num_pages=eng.num_pages,
            dec_capacity=ecfg.decode_capacity, ctx_quant=quant,
            dtype=torch.float32, device=device)
    elif tree:
        cache = model.make_tree_cache(
            ecfg.slots, ecfg.n_nodes, ecfg.depth, ecfg.node_capacity,
            ecfg.decode_capacity, quant, dtype=torch.float32, device=device)
    elif eng.paged:
        cache = tpaged.PagedGroupedBifurcatedCache.init(
            cfg.n_layers, ecfg.n_groups, ecfg.slots, ecfg.ctx_capacity,
            ecfg.decode_capacity, cfg.n_kv_heads_padded, cfg.kq_dim,
            dtype=torch.float32, page_m=ecfg.page_size,
            num_pages=eng.num_pages, ctx_quant=quant, device=device)
    else:
        cache = model.make_forest_cache(
            ecfg.slots, ecfg.n_groups, ecfg.ctx_capacity,
            ecfg.decode_capacity, quant, dtype=torch.float32, device=device)
    return dataclasses.replace(st, cache=cache)


def _fp32(eng, make_state):
    """Patch one engine instance so that ``init_state`` builds fp32
    stores."""
    orig = eng.init_state
    eng.init_state = lambda **kw: make_state(eng, orig, **kw)
    return eng


class Twin:
    """The reference ("jax") or the port ("torch") behind one surface."""

    def __init__(self, which: str):
        self.which = which
        if which == "jax":
            from repro.checkpoint import ServeCheckpointer
            from repro.core import errors
            from repro.runtime import (fault_tolerance, faults, frontend,
                                       journal, recovery, scheduler, serve)
            self._model_params = _jax_model_params
            self.cfg = CFG_J
            self.TreeConfig, self.ForestConfig = JTreeConfig, JForestConfig
            self.dev_kw = {}
        else:
            from repro_torch.checkpoint import ServeCheckpointer
            from repro_torch.core import errors
            from repro_torch.runtime import (fault_tolerance, faults,
                                             frontend, journal, recovery,
                                             scheduler, serve)
            self._model_params = _torch_model_params
            self.cfg = CFG_T
            self.TreeConfig, self.ForestConfig = TTreeConfig, TForestConfig
            self.dev_kw = {"device": "cpu"}
        self.ServeCheckpointer = ServeCheckpointer
        self.errors, self.faults, self.frontend = errors, faults, frontend
        self.fault_tolerance, self.journal = fault_tolerance, journal
        self.recovery, self.scheduler, self.serve = recovery, scheduler, serve

    # the model is built at first use, not when a test module is imported
    @property
    def model(self):
        return self._model_params()[0]

    @property
    def params(self):
        return self._model_params()[1]

    # ---- inputs ----
    def tok(self, a):
        a = np.asarray(a)
        return jnp.asarray(a) if self.which == "jax" else torch.as_tensor(a)

    # ---- engines ----
    def engine(self, kind="tree", store="paged", dtype="bfloat16", **kw):
        """One fresh engine with fp32 stores."""
        if kind == "tree":
            ecfg = self.TreeConfig(**{**TREE_KW, "cache_dtype": dtype,
                                      "ctx_store": store, **kw})
            eng = self.serve.TreeServeEngine(self.model, self.cfg, ecfg)
        else:
            ecfg = self.ForestConfig(**{**FOREST_KW, "cache_dtype": dtype,
                                        "ctx_store": store, **kw})
            eng = self.serve.ForestServeEngine(self.model, self.cfg, ecfg)
        return _fp32(eng, _jax_fp32_state if self.which == "jax"
                     else _torch_fp32_state)

    def factory(self, kind="tree", store="paged", dtype="bfloat16", **kw):
        return lambda: self.engine(kind, store, dtype, **kw)

    # ---- frontends ----
    def frontend_(self, engine, **kw):
        return self.frontend.ServeFrontend(engine, **self.dev_kw, **kw)

    def durable(self, factory, directory, **kw):
        return self.recovery.DurableFrontend(factory, directory,
                                             **self.dev_kw, **kw)


def both():
    return Twin("jax"), Twin("torch")


def summary(fe):
    """What two frontends on the same workload must agree on."""
    return {
        "tickets": [(t.tid, t.status, t.reason, t.preemptions,
                     t.fault_touched,
                     None if t.tokens is None
                     else [[int(x) for x in tok] for tok in t.tokens])
                    for t in fe.tickets],
        "counters": dict(fe.counters),
        "round": fe.round,
    }


def logprobs(fe):
    return [None if t.logprobs is None
            else [np.asarray(lp, np.float64) for lp in t.logprobs]
            for t in fe.tickets]


def assert_same_run(fe_t, fe_j, tol=1e-5):
    """The port's frontend ended as the reference's: statuses, reasons,
    counters and tokens equal, log-probs within ``tol``."""
    assert summary(fe_t) == summary(fe_j)
    for a, b in zip(logprobs(fe_t), logprobs(fe_j)):
        assert (a is None) == (b is None)
        for x, y in zip(a or [], b or []):
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol)
