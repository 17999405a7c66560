"""Port parity for the split walks of the two-pass partials kernel #2
(``context_flash_partials``) and the int8 packed-step kernel #11
(``packed_fused_bifurcated_decode_q8``): their plain versions at S shares
per (64-row tile, kv head), merged exactly, against the reference's Pallas
kernels in interpret mode; one result for every S > 1; #11's decode rows
bit-equal to #9's (``paged_fused_bifurcated_decode_q8``) split walk; a
chunk row's output unmoved by another request's retire and readmit and by
S; ``packed_split_count``; and the wrappers' ``splits`` contract.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_torch
from conftest import build_page_pool
from repro.core import quantized as jq
from repro.kernels import bifurcated_decode as jbd
from repro.kernels import ops as jops
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops

G, HD, PM = 2, 32, 16


# ---- #2: context_flash_partials ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m_c", [300, 700])
def test_partials_split_plain_matches_reference(m_c, dtype):
    """#2's plain version at S = 2 and 5 (pieces of 256 keys from key 0,
    m_c off the 64-key block) against the reference's Pallas kernel in
    interpret mode: acc, m and l, fp32 at 1e-5 and bf16 at 2e-2; one bit
    pattern for every S > 1; S = 1 the single walk the wrapper runs on the
    CPU (splits None)."""
    rng = np.random.RandomState(m_c)
    a = [np.asarray(jnp.asarray(rng.randn(G, n, HD), dtype))
         for n in (70, m_c, m_c)]
    want = jbd.context_flash_partials(*map(jnp.asarray, a), scale=HD**-0.5,
                                      block_m=128, interpret=True)
    t = [to_torch(x) for x in a]
    split = tbd.context_flash_partials_plain(*t, scale=HD**-0.5, splits=2)
    for got, ref in zip(split, want):
        assert got.dtype == torch.float32
        assert_close(got, ref, dtype)
    assert all(torch.equal(x, y) for x, y in zip(
        tbd.context_flash_partials_plain(*t, scale=HD**-0.5, splits=5),
        split))
    n0 = tbd.context_flash_partials.launches
    single = tbd.context_flash_partials(*t, scale=HD**-0.5)
    assert tbd.context_flash_partials.launches == n0
    assert all(torch.equal(x, y) for x, y in zip(
        single, tbd.context_flash_partials_plain(*t, scale=HD**-0.5,
                                                 splits=1)))


# ---- #11: packed_fused_bifurcated_decode_q8 ----

# an int8 ragged trie on shuffled pages of 16: segment lengths 150, 40, 77,
# 0 (retired) and 20; 35 samples of 2 rows (two decode tiles, 64 + 6 rows)
# on six paths of depth 2 (a node twice on one, a -1 level), 1..4 live of
# 4 decode slots each; a 40-position chunk (80 rows: tiles of 64 and 16)
# under [0, 2], 50 live envelope rows of 64 from position 227
LENS = (150, 40, 77, 0, 20)
SLOT_PATHS = ([0, 1], [0, 2], [4, -1], [0, 0], [2, 1], [4, 0])
B, C_D, P = 35, 4, 2
CP, BUF, FRESH_START, FRESH_PATH = 40, 10, 227, (0, 2)


def _packed_case(seed=0, slot_paths=SLOT_PATHS, lens=LENS, chunk=True):
    """numpy operands of the packed dispatchers: [positional args],
    {chunk kwargs} (empty for a decode-only call)."""
    rng = np.random.RandomState(seed)
    cap = 160
    kc, vc = (rng.randn(len(lens), G, cap, HD).astype(np.float32)
              for _ in range(2))
    kq, ks = jq.quantize_ctx(jnp.asarray(kc), fold_scale=HD**-0.5)
    vq, vs = jq.quantize_ctx(jnp.asarray(vc))
    lens = np.array(lens, np.int32)
    pool, table = build_page_pool([np.asarray(x) for x in (kq, vq, ks, vs)],
                                  lens, PM, perm_seed=seed + 1,
                                  extra_pages=2)
    paths = np.array([slot_paths[s % len(slot_paths)] for s in range(B)],
                     np.int32).T.copy()
    q = rng.randn(B, G, P, 1, HD).astype(np.float32)
    kd, vd = (rng.randn(B, C_D, G, HD).astype(np.float32) for _ in range(2))
    mask = np.arange(C_D)[None] < rng.randint(1, C_D + 1, size=B)[:, None]
    args = [q] + [np.asarray(x) for x in pool] + [
        np.asarray(table), lens, paths, kd, vd, mask]
    if not chunk:
        return args, {}
    fl = BUF + CP
    kf = np.zeros((4 * PM, G, HD), np.float32)
    vf = np.zeros_like(kf)
    kf[:fl], vf[:fl] = rng.randn(fl, G, HD), rng.randn(fl, G, HD)
    kw = dict(q_fresh=rng.randn(CP, G, P, HD).astype(np.float32),
              k_fresh=kf, v_fresh=vf, fresh_len=fl, fresh_start=FRESH_START,
              fresh_pos=(FRESH_START + BUF + np.arange(CP)).astype(np.int32),
              fresh_path=np.array(FRESH_PATH, np.int32))
    return args, kw


def _port_packed(args, kw, splits, monkeypatch):
    """The port's packed dispatcher (CPU tensors: the plain versions) with
    #11 at ``splits``: (out_dec, out_fresh)."""
    monkeypatch.setattr(tops, "packed_fused_bifurcated_decode_q8",
                        functools.partial(
                            tbd.packed_fused_bifurcated_decode_q8,
                            splits=splits))
    tkw = {k: (v if isinstance(v, int) else to_torch(v))
           for k, v in kw.items()}
    return tops.packed_bifurcated_decode_attention_q8(*map(to_torch, args),
                                                      **tkw)


@pytest.mark.parametrize("pieces", ["kernel", "small"])
@pytest.mark.parametrize("splits", [1, 3])
def test_packed_split_plain_matches_reference(splits, pieces, monkeypatch):
    """#11's plain version at S 1 (the queue walk) and 3 (the kernel's
    pieces; "small": pieces of 64 and 128 keys, so that a node, the
    envelope and the decode arm span several) on the int8 ragged trie with
    a chunk, against the reference's packed dispatcher through its Pallas
    kernel in interpret mode, fp32 at 1e-5, decode and chunk rows."""
    if pieces == "small":
        monkeypatch.setattr(tbd, "PIECE_BLOCKS", 1)
        monkeypatch.setattr(tbd, "CHUNK_PIECE_BLOCKS", 2)
    args, kw = _packed_case()
    jkw = {k: (jnp.int32(v) if isinstance(v, int) else jnp.asarray(v))
           for k, v in kw.items()}
    jd, jf = jops.packed_bifurcated_decode_attention_q8(
        *map(jnp.asarray, args), **jkw, interpret=True)
    td, tf = _port_packed(args, kw, splits, monkeypatch)
    assert torch.isfinite(td).all() and torch.isfinite(tf).all()
    assert_close(td, jd, "float32")
    assert_close(tf, jf, "float32")


def _kernel_args(seed=0, slot_paths=SLOT_PATHS, lens=LENS, chunk=True):
    """The case as #11's kernel-level operands (CPU tensors), its keyword
    arguments, and #9's operands on the same decode rows."""
    args, kw = _packed_case(seed, slot_paths, lens, chunk)
    t = [to_torch(x) for x in args]
    q, kq, vq, ks, vs, tables, seg_lens, paths, kd, vd, mask = t
    if chunk:
        qf, kf, vf = (to_torch(kw[k]) for k in ("q_fresh", "k_fresh",
                                                "v_fresh"))
        fpos, fpath = to_torch(kw["fresh_pos"]), to_torch(kw["fresh_path"])
    else:
        qf = q.new_zeros((0, G, P, HD))
        kf = vf = kd.new_zeros((PM, G, HD))
        fpos = torch.zeros(0, dtype=torch.int32)
        fpath = torch.full((paths.shape[0],), -1, dtype=torch.int32)
    qk, path_rows, row_pos, row_slot, kdk, vdk, bias = tops._packed_operands(
        q, paths, kd, vd, mask, qf, fpos, fpath, tables.shape[0])
    pool = (kq, vq, ks, vs)
    packed = (qk, *pool, kf, vf, tables, seg_lens, path_rows, row_pos,
              row_slot, kdk, vdk, bias)
    nd = B * P
    paged = (qk[:, :nd].contiguous(), *pool, tables, seg_lens,
             path_rows[:-1, :nd].contiguous(), kdk, vdk, bias)
    pkw = dict(fresh_len=kw.get("fresh_len", 0),
               fresh_start=kw.get("fresh_start", 0), scale=HD**-0.5, c_d=C_D,
               pn=P)
    return packed, pkw, paged


@pytest.mark.parametrize("splits", [2, 5])
def test_packed_decode_rows_are_the_paged_split_walk(splits):
    """#11's decode rows are #9's decode tiles: a decode-only call of #11's
    plain version equals #9's plain split walk at the same S bit for bit,
    and so do the decode rows of a call with the chunk."""
    packed, pkw, paged = _kernel_args(chunk=False)
    want = tbd.paged_fused_bifurcated_decode_q8_plain(
        *paged, scale=pkw["scale"], c_d=C_D, pn=P, splits=splits)
    got = tbd.packed_fused_bifurcated_decode_q8_plain(*packed, **pkw,
                                                      splits=splits)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    packed, pkw, _ = _kernel_args()
    got = tbd.packed_fused_bifurcated_decode_q8_plain(*packed, **pkw,
                                                      splits=splits)
    assert torch.equal(got[:, :B * P], want)


def test_packed_chunk_rows_move_with_nothing_else():
    """A chunk row's bits depend on its own path and the piece sizes only:
    unmoved when another request is retired and readmitted (its slots on
    another path, its leaf node rewritten with another length) and at
    every S > 1 (an int or a pair); the decode rows move."""
    nd = B * P
    packed, pkw, _ = _kernel_args()
    base = tbd.packed_fused_bifurcated_decode_q8_plain(*packed, **pkw,
                                                       splits=3)
    readmit = tuple(p if i else [1, 4] for i, p in enumerate(SLOT_PATHS))
    lens = (150, 33, 77, 0, 20)
    other, _, _ = _kernel_args(seed=0, slot_paths=readmit, lens=lens)
    for splits in (2, 7, (33, 2), (2, 5)):
        got = tbd.packed_fused_bifurcated_decode_q8_plain(
            *other, **pkw, splits=splits)
        assert torch.equal(got[:, nd:], base[:, nd:]), splits
        assert not torch.equal(got[:, :nd], base[:, :nd])


@pytest.mark.parametrize("case", [
    # (n_dec, n_chunk, g, sms, want): the main packed shape, decode only
    # (#9's count), a chunk alone, rows off the tile, a batch that fills
    # the card, a chunk wider than the card
    (64, 1024, 8, 132, (16, 2)), (64, 0, 8, 132, (33, 33)),
    (0, 1024, 8, 132, (1, 2)), (70, 80, 2, 132, (33, 64)),
    (2048, 1024, 8, 132, (1, 2)), (64, 16384, 8, 132, (16, 1))])
def test_packed_split_count(case):
    """``packed_split_count`` is a pure function of the rows, g and the SM
    count; with no chunk rows it is #9's ``split_count``."""
    n_dec, n_chunk, g, sms, want = case
    assert tbd.packed_split_count(n_dec, n_chunk, g, sms=sms) == want
    if n_chunk == 0:
        s = tbd.split_count(n_dec, g, sms=sms)
        assert want == (s, s)


def test_split_wrappers_refuse_invalid_splits():
    """``splits`` is None or an int in 1..MAX_SPLITS (#11: or a pair of
    such ints), on the CPU too; a valid one runs the plain version at that
    S."""
    rng = np.random.RandomState(0)
    t = [to_torch(rng.randn(G, n, HD).astype(np.float32))
         for n in (70, 300, 300)]
    for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1, (2, 2)):
        with pytest.raises(ValueError, match="splits"):
            tbd.context_flash_partials(*t, scale=0.25, splits=bad)
    assert all(torch.equal(x, y) for x, y in zip(
        tbd.context_flash_partials(*t, scale=0.25, splits=4),
        tbd.context_flash_partials_plain(*t, scale=0.25, splits=4)))
    packed, pkw, _ = _kernel_args()
    for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1, (2,), (0, 2), (None, 2),
                (2, 2, 2)):
        with pytest.raises(ValueError, match="splits"):
            tbd.packed_fused_bifurcated_decode_q8(*packed, **pkw, splits=bad)
    assert torch.equal(
        tbd.packed_fused_bifurcated_decode_q8(*packed, **pkw, splits=(4, 2)),
        tbd.packed_fused_bifurcated_decode_q8_plain(*packed, **pkw,
                                                    splits=3))
    with pytest.raises(ValueError, match="entries_per_launch"):
        tbd.packed_fused_bifurcated_decode_q8_plain(
            *packed, **pkw, splits=3, entries_per_launch=2)
