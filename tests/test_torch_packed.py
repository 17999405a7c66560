"""Port parity for the PACKED heterogeneous step and suffix-only prefill:
the work queue bit for bit against the reference's; the packed
dispatchers (the kernels' plain versions, CPU tensors) against the
reference's Pallas packed kernels in interpret mode, decode-only bit for
bit against the port's paged dispatchers, chained walks bit for bit
against one walk; ``prefill_suffix`` and ``decode_step_packed`` against
the reference's; ``TreeServeEngine(step_mode="packed")`` against the
reference's packed engine on its own workload ({dense, paged} x {bf16,
int8} nodes, kernel and reference paths) and against the port's decode
mode; ``suffix_prefill`` in decode mode; the pending-prefill lifecycle
(``PrefillInFlight``, cancel, retire, the capacity guard); and the two
repairs that every path samples through: top-p where the fp32 cumulative
softmax ends below ``top_p``, and sampled (temperature, top-p) parity of
the forest and trie engines under shared noise.

Tolerances: fp32 1e-5, bf16 2e-2 of max |ref| (``_torch_parity``). The
engines run in fp32 on both sides (the whole forward patched to fp32,
fp32 stores in place of the reference's bf16 ones). Log-probs of int8
nodes are gated at 1e-3: the nodes are quantized from fp32 K/V that the
two frameworks compute to the last bit only, and a value at a
round-half-even boundary may round to neighbouring int8 values on the
two sides (one V value of the reference path's 16,384 does on this
workload, moving later log-probs by 2.4e-4); tokens are compared
exactly everywhere."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_close_logits, to_np, to_torch
from conftest import build_page_pool
from repro.configs import ForestConfig as JForestConfig
from repro.configs import TreeConfig as JTreeConfig
from repro.configs import get_config, reduced_config
from repro.core import paged as jpaged
from repro.core import quantized as jq
from repro.kernels import ops as jops
from repro.models import get_model as j_get_model
from repro.runtime.serve import ForestServeEngine as JForestEngine
from repro.runtime.serve import TreeServeEngine as JTreeEngine
from repro.runtime.serve import sample_tokens as j_sample_tokens
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.errors import DecodeCapacityExceeded, PrefillInFlight
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model as t_get_model
from repro_torch.runtime.serve import (
    ForestServeEngine,
    TreeServeEngine,
    sample_tokens,
)

G_KV, HD = 2, 32


# ---- the work queue ----

QUEUE_CASES = {
    # name: (seg_lens, tables, pm, fresh_len, fresh_start, fcap)
    "empty": ([0, 0, 0], [[-1, -1]] * 3, 8, 0, 0, 2),
    "free_segment_exclusion": ([13, 0, 8], [[4, 5, -1], [-1, -1, -1],
                                            [2, -1, -1]], 8, 0, 0, 1),
    "single_row_chunk": ([8], [[3]], 8, 1, 21, 2),
    "fresh_tile_positions": ([8], [[0]], 8, 13, 40, 2),
    "streamed_tiles": ([13, 0, 8], [[4, 5, -1], [-1, -1, -1],
                                    [2, -1, -1]], 8, 9, 25, 2),
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_packed_work_queue_matches_reference(case):
    """Every array of the work queue bit for bit and dtype for dtype equal
    to the reference's, on its own test cases (tests/test_packed.py)."""
    lens, tables, pm, fl, fs, fcap = QUEUE_CASES[case]
    want = jops.packed_work_queue(
        jnp.asarray(tables, jnp.int32), jnp.asarray(lens, jnp.int32), pm,
        fresh_len=jnp.int32(fl), fresh_start=jnp.int32(fs),
        num_fresh_tiles=fcap, pseudo_seg=len(lens))
    got = tops.packed_work_queue(
        torch.tensor(tables, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), pm, fresh_len=fl,
        fresh_start=fs, num_fresh_tiles=fcap, pseudo_seg=len(lens))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    n_ent = int(got[5][0])
    assert n_ent == {"empty": 0, "free_segment_exclusion": 3,
                     "single_row_chunk": 2, "fresh_tile_positions": 3,
                     "streamed_tiles": 5}[case]


# ---- the packed dispatchers ----

def _packed_case(dtype, quant, *, m_anc=40, cp=6, buf=3, pm=16, fcap=2,
                 fresh_start=None, chunk=True, seed=0):
    """A paged trie of two segments (40 and 20 keys) on shuffled pages of
    16, three slots (two q heads each) over it, and a chunk of ``cp`` rows
    whose envelope holds ``buf + cp`` live rows at ``fresh_start`` (default
    the end of segment 0, its ancestor): numpy arrays for both
    dispatchers, [positional args], {chunk kwargs}."""
    rng = np.random.RandomState(seed)

    def f(*shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), dtype))

    b, c_d = 3, 4
    q, kd, vd = f(b, G_KV, 2, 1, HD), f(b, c_d, G_KV, HD), f(b, c_d, G_KV, HD)
    mask = np.arange(c_d)[None] < np.array([1, 4, 2])[:, None]
    lens = np.array([m_anc, 20], np.int32)
    kc, vc = (rng.randn(2, G_KV, 64, HD).astype(np.float32) for _ in range(2))
    if quant:
        kq, ks = jq.quantize_ctx(jnp.asarray(kc), fold_scale=HD**-0.5)
        vq, vs = jq.quantize_ctx(jnp.asarray(vc))
        slabs = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        slabs = [np.asarray(jnp.asarray(x, dtype)) for x in (kc, vc)]
    pool, table = build_page_pool(slabs, lens, pm, perm_seed=5,
                                  extra_pages=1)
    paths = np.array([[0, 0, 1], [-1, 1, -1]], np.int32)
    args = [q] + [np.asarray(x) for x in pool] + [
        np.asarray(table), lens, paths, kd, vd, mask]
    if not chunk:
        return args, {}
    fl = buf + cp
    kf = np.zeros((fcap * pm, G_KV, HD), np.float32)
    vf = np.zeros_like(kf)
    kf[:fl], vf[:fl] = rng.randn(fl, G_KV, HD), rng.randn(fl, G_KV, HD)
    start = m_anc if fresh_start is None else fresh_start
    kw = dict(q_fresh=f(cp, G_KV, 2, HD),
              k_fresh=np.asarray(jnp.asarray(kf, dtype)),
              v_fresh=np.asarray(jnp.asarray(vf, dtype)),
              fresh_len=fl, fresh_start=start,
              fresh_pos=(start + buf + np.arange(cp)).astype(np.int32),
              fresh_path=np.array([0 if start else -1, -1], np.int32))
    return args, kw


def _run_packed(args, kw, quant, **extra):
    """(reference (out_dec, out_fresh), port (out_dec, out_fresh))."""
    fj = (jops.packed_bifurcated_decode_attention_q8 if quant
          else jops.packed_bifurcated_decode_attention)
    ft = (tops.packed_bifurcated_decode_attention_q8 if quant
          else tops.packed_bifurcated_decode_attention)
    jkw = {k: (jnp.int32(v) if isinstance(v, int) else jnp.asarray(v))
           for k, v in kw.items()}
    want = fj(*map(jnp.asarray, args), **jkw, interpret=True, **extra)
    tkw = {k: (v if isinstance(v, int) else to_torch(v))
           for k, v in kw.items()}
    got = ft(*map(to_torch, args), **tkw, **extra)
    return want, got


def _assert_close_out(got, want, dtype):
    if dtype == "float32":
        assert_close(got, want, dtype)
    else:
        g, w = to_np(got), to_np(want)
        assert np.max(np.abs(g - w)) <= 2e-2 * np.max(np.abs(w))


@pytest.mark.parametrize("dtype,quant,case", [
    ("float32", False, "decode_only"), ("float32", True, "decode_only"),
    ("float32", False, "chunk"), ("float32", True, "chunk"),
    ("bfloat16", False, "chunk"), ("bfloat16", True, "chunk"),
    ("float32", False, "no_ancestors"), ("float32", True, "ragged"),
    ("float32", False, "two_entries_per_launch"),
    ("float32", True, "two_entries_per_launch")])
def test_packed_dispatch_matches_reference(dtype, quant, case):
    """The port's packed dispatcher through the plain versions (CPU
    tensors, no launch) against the reference's through its Pallas packed
    kernels in interpret mode (g=2, hd=32, pages of 16): decode-only
    (also bit for bit the port's paged dispatcher), a chunk of 6 rows over
    its ancestor segment, a chunk at position 0 with no ancestors, a
    ragged envelope (fresh_len 17 of 32, one row past a tile), and chained
    walks of two queue entries each (bit for bit one walk; the reference
    chains launches the same way)."""
    kern = (tbd.packed_fused_bifurcated_decode_q8 if quant
            else tbd.packed_fused_bifurcated_decode)
    extra = {}
    if case == "decode_only":
        args, kw = _packed_case(dtype, quant, chunk=False)
    elif case == "no_ancestors":
        args, kw = _packed_case(dtype, quant, fresh_start=0, buf=0)
    elif case == "ragged":
        args, kw = _packed_case(dtype, quant, buf=11, cp=6)
    else:
        args, kw = _packed_case(dtype, quant)
    if case == "two_entries_per_launch":
        extra = dict(entries_per_launch=2)
    launches = kern.launches
    (jd, jf), (td, tf) = _run_packed(args, kw, quant, **extra)
    assert kern.launches == launches          # CPU: the plain versions
    assert td.shape == jd.shape and tf.shape == jf.shape
    _assert_close_out(td, jd, dtype)
    if tf.numel():
        _assert_close_out(tf, jf, dtype)
    t = [to_torch(x) for x in args]
    if case == "decode_only":
        paged = (tops.paged_bifurcated_decode_attention_q8 if quant
                 else tops.paged_bifurcated_decode_attention)
        assert torch.equal(td, paged(*t))
    if case == "two_entries_per_launch":
        tkw = {k: (v if isinstance(v, int) else to_torch(v))
               for k, v in kw.items()}
        ft = (tops.packed_bifurcated_decode_attention_q8 if quant
              else tops.packed_bifurcated_decode_attention)
        one = ft(*t, **tkw)
        assert torch.equal(one[0], td) and torch.equal(one[1], tf)


def test_packed_rows_outside_the_tables_give_nan():
    """A chunk row's path id outside [-1, N] gives NaN rows in the plain
    versions (as in the kernels); the pseudo id N itself poisons nothing:
    the other rows are finite and equal a run without the bad id."""
    args, kw = _packed_case("float32", False)
    t = [to_torch(x) for x in args]
    tkw = {k: (v if isinstance(v, int) else to_torch(v))
           for k, v in kw.items()}
    d0, f0 = tops.packed_bifurcated_decode_attention(*t, **tkw)
    tkw["fresh_path"] = torch.tensor([0, 5], dtype=torch.int32)   # N = 2
    d1, f1 = tops.packed_bifurcated_decode_attention(*t, **tkw)
    assert torch.isnan(f1).all() and torch.equal(d0, d1)
    assert torch.isfinite(d0).all() and torch.isfinite(f0).all()


def test_packed_kernel_wrappers_check_their_operands():
    """The wrappers' contract on the CPU: entries_per_launch runs the
    plain versions only (on CUDA tensors it raises), fp32 runs the plain
    path, a fresh envelope off the page size or fresh_len past it and
    misshapen row tables raise."""
    args, kw = _packed_case("float32", False)
    t = [to_torch(x) for x in args]
    tkw = {k: (v if isinstance(v, int) else to_torch(v))
           for k, v in kw.items()}
    f = tops.packed_bifurcated_decode_attention
    with pytest.raises(ValueError, match="envelope"):
        f(*t, **{**tkw, "k_fresh": tkw["k_fresh"][:20],
                 "v_fresh": tkw["v_fresh"][:20]})
    with pytest.raises(ValueError, match="fresh_len"):
        f(*t, **{**tkw, "fresh_len": 33})
    with pytest.raises(TypeError, match="dtype"):
        f(*t, **{**tkw, "k_fresh": tkw["k_fresh"].double(),
                 "v_fresh": tkw["v_fresh"].double()})
    qk, path_rows, row_pos, row_slot, kd, vd, bias = tops._packed_operands(
        t[0], t[5], t[6], t[7], t[8], tkw["q_fresh"], tkw["fresh_pos"],
        tkw["fresh_path"], 2)
    assert path_rows.shape == (3, 3 * 2 + 6 * 2)
    assert path_rows[2, :6].tolist() == [-1] * 6
    assert path_rows[2, 6:].tolist() == [2] * 12
    assert row_slot.tolist() == [0, 0, 1, 1, 2, 2] + [-1] * 12
    with pytest.raises(ValueError, match="row_pos"):
        tbd.packed_fused_bifurcated_decode(
            qk, t[1], t[2], tkw["k_fresh"], tkw["v_fresh"], t[3], t[4],
            path_rows, row_pos[:-1], row_slot, kd, vd, bias, fresh_len=9,
            fresh_start=40, scale=HD**-0.5, c_d=4, pn=2)


# ---- the model: suffix prefill and the packed step ----

CFG_J = reduced_config(get_config("internlm2-1.8b"))
CFG_T = tconfigs.reduced_config(tconfigs.get_config("internlm2-1.8b"))
PARAMS_NP = jax.tree.map(np.asarray,
                         j_get_model(CFG_J).init(jax.random.PRNGKey(0)))
RNG = np.random.RandomState(0)
SYS = RNG.randint(0, CFG_J.vocab_size, (1, 12))      # the reference's
TPL = RNG.randint(0, CFG_J.vocab_size, (1, 6))       # packed workload
REQ_A = RNG.randint(0, CFG_J.vocab_size, (1, 9))
REQ_B = RNG.randint(0, CFG_J.vocab_size, (1, 7))


def _torch_model():
    tm = t_get_model(CFG_T)
    tm._embed = lambda p, t: p["embed"][t]      # the forward in fp32
    return tm, params_from_numpy(PARAMS_NP, device="cpu", dtype=torch.float32)


def _jax_model():
    jm = j_get_model(CFG_J)
    jm._embed = lambda p, t: jnp.take(p["embed"], t, axis=0)
    return jm, jax.tree.map(jnp.asarray, PARAMS_NP)


TM, TP = _torch_model()


def test_prefill_suffix_matches_reference_and_full_prefill():
    """fp32 suffix prefill of 9 tokens over a cached 18-token prefix:
    logits and the suffix's K/V equal the reference's prefill_suffix, and
    equal the port's own prefill of all 27 tokens (its last logits and
    its K/V rows 18..26)."""
    prefix = np.concatenate([SYS, TPL], axis=1)
    jm, jp = _jax_model()
    _, cj = jm.prefill(jp, jnp.asarray(prefix), None)
    lj, sj = jm.prefill_suffix(jp, jnp.asarray(REQ_A), cj.k, cj.v, None,
                               start=18)
    _, ct = TM.prefill(TP, torch.as_tensor(prefix))
    lt, st = TM.prefill_suffix(TP, torch.as_tensor(REQ_A), ct.k, ct.v,
                               start=18)
    assert_close(lt, lj, "float32")
    assert_close(st.k, sj.k, "float32")
    assert_close(st.v, sj.v, "float32")
    assert st.length == 27 and tuple(st.k.shape[:3]) == (2, 1, 9)
    lf, cf = TM.prefill(TP, torch.as_tensor(np.concatenate(
        [prefix, REQ_A], axis=1)))
    assert_close(lt, lf, "float32")
    assert_close(st.k, cf.k[:, :, 18:], "float32")
    assert_close(st.v, cf.v[:, :, 18:], "float32")


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
def test_decode_step_packed_matches_reference(pool):
    """One packed step of the model over a paged trie (3 nodes of 24, 16
    and 10 keys on shuffled pages of 8; 4 slots at per-slot depths) with a
    chunk of 5 tokens (4 valid) continuing node 0 past 3 buffered envelope
    rows: decode logits, chunk logits, the envelope rows written and the
    decode arms equal the reference's (its Pallas packed kernel in
    interpret mode). fp32 and int8 pools run the fp32 model, the bf16
    pool the bf16 model as served."""
    rng = np.random.RandomState(3)
    L, hd, g = CFG_J.n_layers, CFG_J.kq_dim, CFG_J.n_kv_heads_padded
    b, cap, c_d, pm, cp = 4, 32, 8, 8, 5
    lens = [24, 16, 10]
    quant = "int8" if pool == "int8" else "none"
    bf16 = pool == "bfloat16"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kv = [[np.asarray(jnp.asarray(rng.randn(L, m, g, hd), jdt))
           for _ in range(2)] for m in lens]
    perm = [int(i) for i in rng.permutation(sum(-(-m // pm) for m in lens))]
    n_pages = len(perm)
    cj = jpaged.PagedPrefixTreeCache.init(
        L, 3, 2, b, cap, c_d, g, hd, dtype=jdt, page_m=pm,
        num_pages=n_pages, ctx_quant=quant)
    if bf16:
        tm, tp = t_get_model(CFG_T), params_from_numpy(PARAMS_NP,
                                                       device="cpu")
        jm, jp = j_get_model(CFG_J), jax.tree.map(jnp.asarray, PARAMS_NP)
    else:
        (tm, tp), (jm, jp) = (TM, TP), _jax_model()
    ct = tm.make_paged_cache(b, 3, 2, cap, page_m=pm, num_pages=n_pages,
                             dec_capacity=c_d, ctx_quant=quant, dtype=tdt,
                             device="cpu")
    for s, (k, v) in enumerate(kv):
        ids, perm = perm[:-(-lens[s] // pm)], perm[-(-lens[s] // pm):]
        cj = cj.write_node(jnp.asarray(k), jnp.asarray(v), s, ids)
        ct.write_node(to_torch(k), to_torch(v), s, ids)
    paths = np.array([[0, 0, 2, 0], [1, -1, -1, 1]], np.int32)
    dec_lens = np.array([2, 0, 5, 1], np.int32)
    kd, vd = (np.asarray(jnp.asarray(rng.randn(L, b, c_d, g, hd), jdt))
              for _ in range(2))
    cj = dataclasses.replace(cj, paths=jnp.asarray(paths),
                             k_dec=jnp.asarray(kd), v_dec=jnp.asarray(vd),
                             dec_lens=jnp.asarray(dec_lens))
    for name, x in (("paths", paths), ("k_dec", kd), ("v_dec", vd),
                    ("dec_lens", dec_lens)):
        getattr(ct, name).copy_(to_torch(x))
    env = np.zeros((L, 32, g, hd), np.float32)
    env[:, :3] = rng.randn(L, 3, g, hd)
    env = np.asarray(jnp.asarray(env, jdt))
    tokens = rng.randint(0, CFG_J.vocab_size, (b, 1))
    chunk = rng.randint(0, CFG_J.vocab_size, (1, cp))
    chunk[0, 4] = 0                                   # padded row
    fresh_start, buf_len, cv = 24, 3, 4
    fpos = (fresh_start + buf_len + np.arange(cp)).astype(np.int32)
    fpath = np.array([0, -1], np.int32)
    lj, lcj, cj2, kfj, vfj = jm.decode_step_packed(
        jp, cj, jnp.asarray(tokens), jnp.asarray(chunk), None,
        k_fresh=jnp.asarray(env), v_fresh=jnp.asarray(env),
        buf_len=jnp.int32(buf_len), chunk_valid=jnp.int32(cv),
        fresh_start=jnp.int32(fresh_start), fresh_pos=jnp.asarray(fpos),
        fresh_path=jnp.asarray(fpath))
    kft, vft = to_torch(env), to_torch(env)
    lt, lct, ct2, kf2, vf2 = tm.decode_step_packed(
        tp, ct, torch.as_tensor(tokens), torch.as_tensor(chunk),
        k_fresh=kft, v_fresh=vft, buf_len=buf_len, chunk_valid=cv,
        fresh_start=fresh_start, fresh_pos=to_torch(fpos),
        fresh_path=to_torch(fpath))
    assert ct2 is ct and kf2 is kft and vf2 is vft
    assert ct.dec_lens.tolist() == (dec_lens + 1).tolist()
    assert_close_logits(lt, lj, "bfloat16" if bf16 else "float32")
    # the chunk's valid rows (a padded row's output is the online state's
    # finite garbage on both sides, over different walks)
    assert_close_logits(lct[:, :cv], lcj[:, :cv],
                        "bfloat16" if bf16 else "float32")
    assert torch.isfinite(lct).all()
    if not bf16:
        assert_close(kf2[:, :buf_len + cv], kfj[:, :buf_len + cv], "float32")
        assert_close(vf2[:, :buf_len + cv], vfj[:, :buf_len + cv], "float32")
        assert_close(ct2.k_dec, cj2.k_dec, "float32")


# ---- TreeServeEngine: step_mode="packed", suffix_prefill ----

def _tree_kw(step_mode, **kw):
    return {**dict(n_nodes=8, depth=3, slots=6, node_capacity=32,
                   decode_capacity=16, temperature=0.0, suffix_prefill=True,
                   prefill_chunk=5, step_mode=step_mode), **kw}


def _jax_tree_state(eng, tcfg):
    """The reference engine's state with an fp32 store in place of its
    bf16 one."""
    st = eng.init_state()
    quant = "int8" if tcfg.cache_dtype == "int8" else "none"
    if tcfg.ctx_store == "paged":
        cache = jpaged.PagedPrefixTreeCache.init(
            CFG_J.n_layers, tcfg.n_nodes, tcfg.depth, tcfg.slots,
            tcfg.node_capacity, tcfg.decode_capacity,
            CFG_J.n_kv_heads_padded, CFG_J.kq_dim, dtype=jnp.float32,
            page_m=tcfg.page_size, ctx_quant=quant)
    else:
        cache = jq.tree_cache_family(quant).init(
            CFG_J.n_layers, tcfg.n_nodes, tcfg.depth, tcfg.slots,
            tcfg.node_capacity, tcfg.decode_capacity,
            CFG_J.n_kv_heads_padded, CFG_J.kq_dim, dtype=jnp.float32,
            ctx_layout=CFG_J.ctx_layout)
    return dataclasses.replace(st, cache=cache)


def _torch_tree(step_mode, **kw):
    """The port's engine on the CPU with an fp32 store."""
    tcfg = tconfigs.TreeConfig(**_tree_kw(step_mode, **kw))
    eng = TreeServeEngine(TM, CFG_T, tcfg)
    st = eng.init_state(device="cpu")
    quant = "int8" if tcfg.cache_dtype == "int8" else "none"
    if tcfg.ctx_store == "paged":
        cache = TM.make_paged_cache(
            tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
            page_m=tcfg.page_size, dec_capacity=tcfg.decode_capacity,
            ctx_quant=quant, dtype=torch.float32, device="cpu")
    else:
        cache = TM.make_tree_cache(
            tcfg.slots, tcfg.n_nodes, tcfg.depth, tcfg.node_capacity,
            tcfg.decode_capacity, quant, dtype=torch.float32, device="cpu")
    return eng, dataclasses.replace(st, cache=cache)


def _serve(eng, st, params, conv):
    """The reference's packed workload (tests/test_packed.py): a fresh
    2-level admission, 6 steps, then a partially matched 3-level admission
    mid-stream, 8 more steps."""
    st, sa = eng.admit(params, st, [conv(SYS), conv(REQ_A)], 2)
    st = eng.step_chunk(params, st, 6)
    st, sb = eng.admit(params, st, [conv(SYS), conv(TPL), conv(REQ_B)], 2)
    st = eng.step_chunk(params, st, 8)
    return st, sa + sb


@functools.lru_cache(maxsize=None)
def _jax_packed(ctx_store, cache_dtype, use_kernel):
    jm, jp = _jax_model()
    tcfg = JTreeConfig(**_tree_kw("packed", ctx_store=ctx_store,
                                  cache_dtype=cache_dtype,
                                  use_kernel=use_kernel))
    eng = JTreeEngine(jm, CFG_J, tcfg)
    _, slots = _serve(eng, _jax_tree_state(eng, tcfg), jp, jnp.asarray)
    return eng.outputs, eng.logps, slots, dict(eng.prefix_stats)


@pytest.mark.parametrize("ctx_store,cache_dtype,use_kernel", [
    ("dense", "bfloat16", False), ("dense", "int8", False),
    ("paged", "bfloat16", True), ("paged", "bfloat16", False),
    ("paged", "int8", True), ("paged", "int8", False)])
def test_packed_engine_matches_reference(ctx_store, cache_dtype, use_kernel):
    """The reference's packed workload on the port and on the reference,
    both fp32: greedy tokens equal, log-probs within the module's
    tolerances, prefix statistics equal; every pending prefill drained;
    the packed kernel launched nowhere (CPU: its plain version runs on the
    paged kernel path). Then the port's packed run against its own decode
    mode: each slot's packed output a prefix of its decode-mode output
    (chunk steps displace decode steps), log-probs within 1e-5 except on
    the int8 kernel path, whose chunks attend their ancestors' int8 pages
    where a synchronous admission prefills them in fp32."""
    kw = dict(ctx_store=ctx_store, cache_dtype=cache_dtype,
              use_kernel=use_kernel)
    eng, st = _torch_tree("packed", **kw)
    launches = [k.launches for k in tbd.KERNELS]
    _, slots = _serve(eng, st, TP, torch.as_tensor)
    assert [k.launches for k in tbd.KERNELS] == launches
    assert not eng._pending and not eng.node_pending
    j_out, j_logps, j_slots, j_stats = _jax_packed(ctx_store, cache_dtype,
                                                   use_kernel)
    assert slots == j_slots and eng.prefix_stats == j_stats
    tol = 1e-3 if cache_dtype == "int8" else 1e-5
    for s in slots:
        assert eng.outputs[s] == j_out[s], s
        assert len(eng.outputs[s]) >= 2
        np.testing.assert_allclose(eng.logps[s], j_logps[s], rtol=tol,
                                   atol=tol)
    dec, dst = _torch_tree("decode", **kw)
    _, d_slots = _serve(dec, dst, TP, torch.as_tensor)
    tol = 1e-1 if (cache_dtype == "int8" and use_kernel) else 1e-5
    for sd, sp in zip(d_slots, slots):
        od, op = dec.outputs[sd], eng.outputs[sp]
        assert od[:len(op)] == op, (sd, od, op)
        np.testing.assert_allclose(dec.logps[sd][:len(op)], eng.logps[sp],
                                   rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_suffix(cache_dtype):
    jm, jp = _jax_model()
    tcfg = JTreeConfig(**_tree_kw("decode", cache_dtype=cache_dtype))
    eng = JTreeEngine(jm, CFG_J, tcfg)
    st, slots = _serve(eng, _jax_tree_state(eng, tcfg), jp, jnp.asarray)
    st, s2 = eng.admit(jp, st, [jnp.asarray(SYS), jnp.asarray(REQ_A)], 1)
    st = eng.step_chunk(jp, st, 2)
    return eng.outputs, eng.logps, slots + s2, dict(eng.prefix_stats)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_suffix_prefill_matches_reference(cache_dtype):
    """``suffix_prefill=True`` in decode mode: a fresh admission, a
    partial hit (the new levels prefilled over the root's cached K/V) and
    a full-path hit (the last cached token re-run as a one-token suffix):
    tokens, log-probs and prefix statistics equal the reference's, and
    only the new tokens ran through the model."""
    eng, st = _torch_tree("decode", cache_dtype=cache_dtype)
    st, slots = _serve(eng, st, TP, torch.as_tensor)
    st, s2 = eng.admit(TP, st, [torch.as_tensor(SYS),
                                torch.as_tensor(REQ_A)], 1)
    st = eng.step_chunk(TP, st, 2)
    j_out, j_logps, j_slots, j_stats = _jax_suffix(cache_dtype)
    assert slots + s2 == j_slots and eng.prefix_stats == j_stats
    assert j_stats == {"admits": 3, "full_hits": 1, "partial_hits": 1,
                       "reused_tokens": 12 + 21, "new_tokens": 21 + 13,
                       "computed_tokens": 21 + 13 + 1, "evictions": 0}
    tol = 1e-3 if cache_dtype == "int8" else 1e-5
    for s in slots + s2:
        assert eng.outputs[s] == j_out[s], s
        np.testing.assert_allclose(eng.logps[s], j_logps[s], rtol=tol,
                                   atol=tol)


def test_prefill_in_flight_then_drain_and_reuse():
    """An admission whose first new level is a node still being prefilled
    raises the retryable PrefillInFlight and changes nothing; once the
    pending chunks land, the same admission succeeds and reuses the now
    live node."""
    eng, st = _torch_tree("packed", ctx_store="paged", use_kernel=True)
    st, sa = eng.admit(TP, st, [torch.as_tensor(SYS),
                                torch.as_tensor(REQ_A)], 1)
    assert eng._pending and eng.node_pending == {0, 1}
    before = (eng.page_alloc.free_count(), len(eng.free_nodes()),
              dict(eng.node_index), eng.next_rid, dict(eng.prefix_stats))
    with pytest.raises(PrefillInFlight) as ei:
        eng.admit(TP, st, [torch.as_tensor(SYS), torch.as_tensor(REQ_B)], 1)
    assert ei.value.retryable and ei.value.reason == "prefill_in_flight"
    assert before == (eng.page_alloc.free_count(), len(eng.free_nodes()),
                      dict(eng.node_index), eng.next_rid,
                      dict(eng.prefix_stats))
    assert eng.outputs[sa[0]] == []           # nothing emitted while pending
    st = eng.step_chunk(TP, st, 6)            # SYS 12 + REQ_A 9 in chunks of 5
    assert not eng._pending and not eng.node_pending
    assert len(eng.outputs[sa[0]]) == 2       # first token + one decode step
    free = len(eng.free_nodes())
    st, sb = eng.admit(TP, st, [torch.as_tensor(SYS), torch.as_tensor(REQ_B)],
                       1)
    st = eng.step_chunk(TP, st, 4)
    assert len(eng.free_nodes()) == free - 1  # SYS reused, one node written
    assert eng.node_refs[0] == 2 and eng.outputs[sb[0]]


def test_cancel_mid_prefill_and_retire_skip_pending():
    """``retire_requests`` skips a pending request (its slots are inactive
    until it activates); ``cancel_request`` mid-prefill aborts it: every
    reserved node and page returns, the trie index is clean (the root
    whose chunks already landed frees with its last reference), and the
    engine serves on."""
    eng, st = _torch_tree("packed", ctx_store="paged", use_kernel=True)
    free0, pages0 = len(eng.free_nodes()), eng.page_alloc.free_count()
    st, sa = eng.admit(TP, st, [torch.as_tensor(SYS),
                                torch.as_tensor(REQ_A)], 1)
    rid = eng.last_rid
    st = eng.step_chunk(TP, st, 3)            # SYS lands, REQ_A pending
    assert eng.node_live[0] and eng.node_pending == {1}
    assert eng.retire_requests(st) == [] and eng.request_live(rid)
    st = eng.cancel_request(st, rid)
    assert not eng._pending and not eng.node_pending
    assert len(eng.free_nodes()) == free0 and not any(eng.node_live)
    assert eng.page_alloc.free_count() == pages0 and eng.node_index == {}
    assert eng.node_refs == [0] * 8 and not eng.request_live(rid)
    st, sb = eng.admit(TP, st, [torch.as_tensor(SYS),
                                torch.as_tensor(REQ_B)], 1)
    st = eng.step_chunk(TP, st, 6)
    assert not eng._pending and eng.outputs[sb[0]]


def test_packed_step_capacity_guard():
    """A packed step raises DecodeCapacityExceeded before it runs when a
    live slot has no decode slot left, as a decode chunk does."""
    eng, st = _torch_tree("packed", decode_capacity=4)
    st, _ = eng.admit(TP, st, [torch.as_tensor(SYS)], 1)
    st = eng.step_chunk(TP, st, 3 + 4)        # 3 chunk steps, 4 decode steps
    st, _ = eng.admit(TP, st, [torch.as_tensor(REQ_A)], 1)
    pend = dict(next(iter(eng._pending.values())))
    with pytest.raises(DecodeCapacityExceeded, match="packed step"):
        eng.step_chunk(TP, st, 1)
    assert next(iter(eng._pending.values()))["done"] == pend["done"] == 0


def test_unported_tree_knobs_still_raise():
    """The prefix-cache knobs, once unported, now construct an engine that
    holds no cache entry yet (in packed mode too); an unknown step_mode
    or evict_policy still raises."""
    for knob in (dict(prefix_cache=True), dict(evict_policy="sharing"),
                 dict(ctx_store="paged", prefix_cache=True),
                 dict(prefix_cache=True, step_mode="packed",
                      suffix_prefill=True)):
        eng = TreeServeEngine(TM, CFG_T, tconfigs.TreeConfig(**knob))
        assert eng.cached_nodes() == [] and eng.node_cached == {}
    with pytest.raises(ValueError, match="evict_policy"):
        TreeServeEngine(TM, CFG_T, tconfigs.TreeConfig(evict_policy="fifo"))
    with pytest.raises(ValueError, match="step_mode"):
        TreeServeEngine(TM, CFG_T, tconfigs.TreeConfig(step_mode="fused"))


# ---- the repairs: top-p, sampled parity ----

def _row_below_one():
    """The first row of 7 logits (2 x standard normal, seed 1) whose fp32
    cumulative sorted softmax ends below 1.0."""
    rng = np.random.default_rng(1)
    while True:
        row = (rng.standard_normal((1, 7)) * 2).astype(np.float32)
        probs = torch.softmax(torch.sort(torch.as_tensor(row), -1,
                                         descending=True).values, -1)
        if torch.cumsum(probs, -1)[0, -1] < 1.0:
            return row


@pytest.mark.parametrize("top_p", [0.9999999, 0.99999999])
def test_top_p_above_the_cumsum_samples_as_the_reference(top_p):
    """Where the fp32 cumulative softmax ends below ``top_p`` the reference
    masks nothing (its gather past the end gives NaN); the port returns the
    same token under the same Gumbel draws, and never gathers out of
    range."""
    row = _row_below_one()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = j_sample_tokens(key, jnp.asarray(row), 1.0, top_p)
        noise = jax.random.gumbel(key, row.shape, jnp.float32)
        got = sample_tokens(torch.as_tensor(row), 1.0, top_p,
                            noise=torch.as_tensor(np.array(noise)))
        assert got.tolist() == np.asarray(want).tolist()


def _gumbel(key, shape):
    """The reference's draws for one sampling call of the engines: one key
    split, ``categorical(sub, l) == argmax(l + gumbel(sub))``. Returns
    (next key, noise)."""
    key, sub = jax.random.split(key)
    return key, np.array(jax.random.gumbel(sub, shape, jnp.float32))


def _chunk_noise(key, n_steps, shape):
    out = []
    for _ in range(n_steps):
        key, noise = _gumbel(key, shape)
        out.append(noise)
    return torch.as_tensor(np.stack(out))


def _packed_sampled_steps(je, js, jp, te, ts, n_steps, V):
    """Step both packed engines one step at a time, the port fed the
    reference's draws: each step splits the reference's key once for the
    decode step and, where a pending request activates, once more for its
    first tokens (drawn (n_samples, V), placed at its slots' rows)."""
    b = te.tcfg.slots
    for _ in range(n_steps):
        key, dec = _gumbel(js.key, (b, V))
        first = np.zeros((b, V), np.float32)
        if te._pending:
            slots = te._pending[min(te._pending)]["slots"]
            first[slots] = _gumbel(key, (len(slots), V))[1]
        js = je.step_chunk(jp, js, 1)
        ts = te.step_chunk(TP, ts, 1, noise=torch.as_tensor(dec)[None],
                           first_noise=torch.as_tensor(first)[None])
    return js, ts


@pytest.mark.parametrize("engine", ["forest", "tree", "tree_packed"])
def test_sampled_slot_engines_match_under_shared_noise(engine):
    """Temperature 0.8, top-p 0.9: the forest and trie engines' tokens and
    log-probs equal the reference's when both draw the same Gumbel noise
    (the port's ``noise`` hook on admit and step_chunk, and in packed mode
    ``first_noise`` for the activations' first tokens, fed the draws of
    the reference engine's key sequence). The packed case runs the kernel
    path on the paged store (the packed kernel's plain version here)."""
    jm, jp = _jax_model()
    V = CFG_J.padded_vocab
    common = dict(slots=5, decode_capacity=16, temperature=0.8, top_p=0.9)
    if engine == "tree_packed":
        kw = dict(slots=5, temperature=0.8, top_p=0.9, ctx_store="paged",
                  use_kernel=True)
        jcfg = JTreeConfig(**_tree_kw("packed", **kw))
        je = JTreeEngine(jm, CFG_J, jcfg)
        js = _jax_tree_state(je, jcfg)
        te, ts = _torch_tree("packed", **kw)
        for req, n in [([SYS, REQ_A], 3), ([SYS, TPL, REQ_B], 2)]:
            js, _ = je.admit(jp, js, [jnp.asarray(x) for x in req], n)
            ts, _ = te.admit(TP, ts, [torch.as_tensor(x) for x in req], n)
            js, ts = _packed_sampled_steps(je, js, jp, te, ts, 6, V)
        assert not te._pending and not je._pending
        for s in range(5):
            assert te.outputs[s] == je.outputs[s], s
            assert_close(torch.tensor(te.logps[s]), np.array(je.logps[s]),
                         "float32")
        # SYS + REQ_A: 5 chunk steps, so a first token and 7 more
        assert len(te.outputs[0]) == 8 and len(set(te.outputs[0])) > 1
        return
    if engine == "forest":
        jcfg = JForestConfig(n_groups=2, ctx_capacity=32, **common)
        je = JForestEngine(jm, CFG_J, jcfg)
        js = je.init_state()
        js = dataclasses.replace(js, cache=jq.forest_cache_family(
            "none").init(CFG_J.n_layers, 2, 5, 32, 16,
                         CFG_J.n_kv_heads_padded, CFG_J.kq_dim,
                         dtype=jnp.float32, ctx_layout=CFG_J.ctx_layout))
        te = ForestServeEngine(TM, CFG_T, tconfigs.ForestConfig(
            n_groups=2, ctx_capacity=32, **common))
        ts = te.init_state(device="cpu")
        ts = dataclasses.replace(ts, cache=TM.make_forest_cache(
            5, 2, 32, 16, dtype=torch.float32, device="cpu"))
        reqs = [(SYS, 3), (REQ_A, 2)]
    else:
        jcfg = JTreeConfig(**_tree_kw("decode", slots=5, temperature=0.8,
                                      top_p=0.9, suffix_prefill=False))
        je = JTreeEngine(jm, CFG_J, jcfg)
        js = _jax_tree_state(je, jcfg)
        te, ts = _torch_tree("decode", slots=5, temperature=0.8, top_p=0.9,
                             suffix_prefill=False)
        reqs = [([SYS, REQ_A], 3), ([SYS, TPL, REQ_B], 2)]
    conv_j = (jnp.asarray if engine == "forest"
              else (lambda r: [jnp.asarray(x) for x in r]))
    conv_t = (torch.as_tensor if engine == "forest"
              else (lambda r: [torch.as_tensor(x) for x in r]))
    for req, n in reqs:
        _, noise = _gumbel(js.key, (n, V))
        js, _ = je.admit(jp, js, conv_j(req), n)
        ts, _ = te.admit(TP, ts, conv_t(req), n,
                         noise=torch.as_tensor(noise))
        noise = _chunk_noise(js.key, 4, (5, V))
        js = je.step_chunk(jp, js, 4)
        ts = te.step_chunk(TP, ts, 4, noise=noise)
    for s in range(5):
        assert te.outputs[s] == je.outputs[s], s
        assert_close(torch.tensor(te.logps[s]), np.array(je.logps[s]),
                     "float32")
    assert len(te.outputs[0]) == 9 and len(set(te.outputs[0])) > 1
