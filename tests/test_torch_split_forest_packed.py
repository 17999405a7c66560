"""Port parity for the split walks of the int8 forest kernel #5
(``grouped_fused_bifurcated_decode_q8``) and the bf16 packed-step kernel
#10 (``packed_fused_bifurcated_decode``): their plain versions at S shares
per (64-row tile, kv head), merged exactly, against the reference's Pallas
kernels in interpret mode; one result for every S > 1; #5 the int8 trie's
split walk (#7) at depth 1, bit for bit, and a forest row unmoved when
another segment changes; #10's decode rows bit-equal to #8's
(``paged_fused_bifurcated_decode``) split walk, with and without the
chunk; and the wrappers' ``splits`` contract.

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


# ---- #5: grouped_fused_bifurcated_decode_q8 ----

# an int8 forest of 5 segments of capacity 600: live lengths off the
# 64-key block (577 and 300 span three and two pieces of 256 keys), 65, 1
# and 0; 35 samples of 2 rows (a tile of 64 rows and one of 6), rows
# shuffled across the segments; ids -1 and G on two samples (their rows
# NaN)
SEG_LENS = (577, 65, 0, 1, 300)
B, C_D, P, CAP = 35, 4, 2, 600


def _forest_case(seed=0, lens=SEG_LENS, bad_ids=True):
    """numpy operands of the forest kernels: q (g, rows, hd), int8 K/V
    (G, g, cap, hd), folded k and v scales (G, g, cap), the (rows,) group
    map, (G,) lengths, the decode arm (g, b * c_d, hd) and its (1, b * c_d)
    bias."""
    rng = np.random.RandomState(seed)
    n_groups = len(lens)
    kc, vc = (rng.randn(n_groups, G, CAP, HD).astype(np.float32)
              for _ in range(2))
    kq, ks = jq.quantize_ctx(jnp.asarray(kc), fold_scale=HD**-0.5)
    vq, vs = jq.quantize_ctx(jnp.asarray(vc))
    gid = np.random.RandomState(7).randint(0, n_groups, size=B)
    if bad_ids:
        gid[3], gid[20] = -1, n_groups
    rows = np.repeat(gid, P).astype(np.int32)
    q = rng.randn(G, B * P, HD).astype(np.float32)
    kd, vd = (rng.randn(G, B * C_D, HD).astype(np.float32) for _ in range(2))
    live = np.arange(C_D)[None] < rng.randint(1, C_D + 1, size=B)[:, None]
    bias = np.where(live.reshape(1, -1), 0.0, -1e30).astype(np.float32)
    ctx = [np.asarray(x) for x in (kq, vq, ks, vs)]
    return [q, *ctx, rows, np.array(lens, np.int32), kd, vd, bias]


def _same(a, b):
    """Bit-equal, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _forest_bad(case):
    rows = case[5]
    return torch.from_numpy((rows < 0) | (rows >= len(case[6])))


FKW = dict(scale=HD**-0.5, c_d=C_D, pn=P)


@pytest.mark.parametrize("splits", [2, 5])
def test_forest_split_plain_matches_reference(splits):
    """#5's plain version at S = 2 and 5 against the reference's Pallas
    kernel in interpret mode (its lane-replicated row map and per-segment
    bias), fp32 at 1e-5 on the rows of ids in [0, G); the rows of ids -1
    and G come out NaN (the reference gives them the decode arm alone);
    one bit pattern for every S > 1."""
    case = _forest_case()
    q, kq, vq, ks, vs, rows, lens, kd, vd, bias = case
    cbias = np.where(np.arange(CAP)[None, :] < lens[:, None], 0.0,
                     -1e30).astype(np.float32)
    want = jbd.grouped_fused_bifurcated_decode_q8(
        *map(jnp.asarray, (q, kq, vq, ks, vs,
                           np.broadcast_to(rows[:, None], (rows.size, 128)),
                           cbias, kd, vd, bias)),
        block_m=128, interpret=True, **FKW)
    t = [to_torch(x) for x in case]
    got = tbd.grouped_fused_bifurcated_decode_q8_plain(*t, **FKW,
                                                       splits=splits)
    bad = _forest_bad(case)
    assert torch.isnan(got[:, bad]).all()
    assert torch.isfinite(got[:, ~bad]).all()
    assert_close(got[:, ~bad], np.asarray(want)[:, ~bad.numpy()], "float32")
    other = tbd.grouped_fused_bifurcated_decode_q8_plain(
        *t, **FKW, splits=2 if splits > 2 else 7)
    assert torch.equal(other[:, ~bad], got[:, ~bad])


@pytest.mark.parametrize("splits", [2, 3, 64])
def test_forest_split_is_the_trie_split_at_depth_one(splits):
    """The forest is the int8 trie at depth 1: #5's plain split walk
    equals #7's at the same S on the rows of ids in [0, G), bit for bit
    (where an id of -1 reads no node in the trie and is NaN in the
    forest)."""
    case = _forest_case()
    t = [to_torch(x) for x in case]
    got = tbd.grouped_fused_bifurcated_decode_q8_plain(*t, **FKW,
                                                       splits=splits)
    paths = t[5].clone()
    paths[paths >= len(SEG_LENS)] = -1     # the trie's NaN is another id's
    want = tbd.tree_fused_bifurcated_decode_q8_plain(
        *t[:5], paths[None].contiguous(), *t[6:], **FKW, splits=splits)
    bad = _forest_bad(case)
    assert torch.equal(got[:, ~bad], want[:, ~bad])


def test_forest_split_rows_move_with_nothing_else():
    """A forest row's bits depend on its own segment only: unmoved when
    another segment is retired and readmitted with another length and
    other contents, at every S > 1; that segment's rows move."""
    case = _forest_case(bad_ids=False)
    t = [to_torch(x) for x in case]
    base = tbd.grouped_fused_bifurcated_decode_q8_plain(*t, **FKW, splits=3)
    lens = list(SEG_LENS)
    lens[4] = 77                      # segment 4 readmitted: 77 new keys
    new = _forest_case(seed=5, lens=lens, bad_ids=False)
    u = [to_torch(x) for x in case]
    for j in range(1, 5):             # K, V and scales of segment 4 only
        u[j][4] = to_torch(new[j])[4]
    u[6] = to_torch(np.array(lens, np.int32))
    rows4 = t[5] == 4
    assert rows4.any() and not rows4.all()
    for splits in (2, 3, 9):
        got = tbd.grouped_fused_bifurcated_decode_q8_plain(*u, **FKW,
                                                           splits=splits)
        assert torch.equal(got[:, ~rows4], base[:, ~rows4]), splits
        assert not torch.equal(got[:, rows4], base[:, rows4])


# ---- #10: packed_fused_bifurcated_decode ----

# a bf16-kernel (bf16 or fp32 values) ragged trie on shuffled pages of 16:
# segment lengths 150, 40, 77, 0 (retired) and 20; 35 samples of 2 rows
# on six paths of depth 2 (a node twice on one, a -1 level), 1..4 live of
# 4 decode slots each; a 40-position chunk (80 rows) under [0, 2], 50 live
# envelope rows of 64 from position 227
LENS = (150, 40, 77, 0, 20)
SLOT_PATHS = ([0, 1], [0, 2], [4, -1], [0, 0], [2, 1], [4, 0])
CP, BUF, FRESH_START, FRESH_PATH = 40, 10, 227, (0, 2)


def _packed_case(dtype, seed=0, chunk=True):
    """numpy operands of the packed dispatchers in ``dtype``: [positional
    args], {chunk kwargs} (empty for a decode-only call)."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), dtype))

    kc, vc = r(len(LENS), G, 160, HD), r(len(LENS), G, 160, HD)
    lens = np.array(LENS, np.int32)
    pool, table = build_page_pool([kc, vc], lens, PM, perm_seed=seed + 1,
                                  extra_pages=2)
    paths = np.array([SLOT_PATHS[s % len(SLOT_PATHS)] for s in range(B)],
                     np.int32).T.copy()
    q = r(B, G, P, 1, HD)
    kd, vd = r(B, C_D, G, HD), r(B, C_D, G, HD)
    mask = np.arange(C_D)[None] < rng.randint(1, C_D + 1, size=B)[:, None]
    args = [q] + [np.asarray(x) for x in pool] + [
        np.asarray(table), lens, paths, kd, vd, mask]
    if not chunk:
        return args, {}
    fl = BUF + CP
    kf = np.zeros((4 * PM, G, HD), kc.dtype)
    vf = np.zeros_like(kf)
    kf[:fl], vf[:fl] = r(fl, G, HD), r(fl, G, HD)
    kw = dict(q_fresh=r(CP, G, P, HD), k_fresh=kf, v_fresh=vf, fresh_len=fl,
              fresh_start=FRESH_START,
              fresh_pos=(FRESH_START + BUF + np.arange(CP)).astype(np.int32),
              fresh_path=np.array(FRESH_PATH, np.int32))
    return args, kw


@pytest.mark.parametrize("pieces", ["kernel", "small"])
@pytest.mark.parametrize("splits", [2, (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_bf16_split_plain_matches_reference(dtype, splits, pieces,
                                                   monkeypatch):
    """#10's plain version at S = 2 and (2, 3) on the ragged trie with a
    chunk ("small": pieces of 64 and 128 keys, so that a node, the
    envelope and the decode arm span several), through the port's packed
    dispatcher, against the reference's dispatcher through its Pallas
    kernel in interpret mode: decode and chunk rows, fp32 at 1e-5 and bf16
    at 2e-2."""
    if pieces == "small":
        monkeypatch.setattr(tbd, "PIECE_BLOCKS", 1)
        monkeypatch.setattr(tbd, "CHUNK_PIECE_BLOCKS", 2)
    args, kw = _packed_case(dtype)
    jkw = {k: (jnp.int32(v) if isinstance(v, int) else jnp.asarray(v))
           for k, v in kw.items()}
    jd, jf = jops.packed_bifurcated_decode_attention(
        *map(jnp.asarray, args), **jkw, interpret=True)
    monkeypatch.setattr(tops, "packed_fused_bifurcated_decode",
                        functools.partial(tbd.packed_fused_bifurcated_decode,
                                          splits=splits))
    tkw = {k: (v if isinstance(v, int) else to_torch(v))
           for k, v in kw.items()}
    td, tf = tops.packed_bifurcated_decode_attention(*map(to_torch, args),
                                                     **tkw)
    assert torch.isfinite(td.float()).all()
    assert torch.isfinite(tf.float()).all()
    assert_close(td, jd, dtype)
    assert_close(tf, jf, dtype)


def _kernel_args(chunk=True, dtype="float32"):
    """The case as #10's kernel-level operands (CPU tensors), its keyword
    arguments, and #8's operands on the same decode rows."""
    args, kw = _packed_case(dtype, chunk=chunk)
    t = [to_torch(x) for x in args]
    q, kp, vp, tables, seg_lens, paths, kd, vd, mask = t
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
    packed = (qk, kp, vp, kf, vf, tables, seg_lens, path_rows, row_pos,
              row_slot, kdk, vdk, bias)
    nd = B * P
    paged = (qk[:, :nd].contiguous(), kp, vp, tables, seg_lens,
             path_rows[:-1, :nd].contiguous(), kdk, vdk, bias)
    pkw = dict(fresh_len=kw.get("fresh_len", 0),
               fresh_start=kw.get("fresh_start", 0), scale=HD**-0.5, c_d=C_D,
               pn=P)
    return packed, pkw, paged


@pytest.mark.parametrize("splits", [2, 5])
def test_packed_bf16_decode_rows_are_the_paged_split_walk(splits):
    """#10's decode rows are #8's decode tiles: a decode-only call of #10's
    plain version equals #8's plain split walk at the same S bit for bit,
    and so do the decode rows of a call with the chunk (at any chunk
    tiles' S)."""
    packed, pkw, paged = _kernel_args(chunk=False)
    want = tbd.paged_fused_bifurcated_decode_plain(
        *paged, scale=pkw["scale"], c_d=C_D, pn=P, splits=splits)
    got = tbd.packed_fused_bifurcated_decode_plain(*packed, **pkw,
                                                   splits=splits)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    packed, pkw, _ = _kernel_args()
    for chunk_splits in (splits, 3):
        got = tbd.packed_fused_bifurcated_decode_plain(
            *packed, **pkw, splits=(splits, chunk_splits))
        assert torch.equal(got[:, :B * P], want)


def test_split_wrappers_refuse_invalid_splits():
    """#5's and #10's ``splits``: None or an int in 1..MAX_SPLITS (#10: or
    a pair of such ints), on the CPU too; None runs splits=1 there (the
    single walks, bit for bit); a valid one runs the plain version at that
    S; no call moves ``.launches`` on the CPU."""
    forest = [to_torch(x) for x in _forest_case()]
    packed, pkw, _ = _kernel_args()
    kerns = (tbd.grouped_fused_bifurcated_decode_q8,
             tbd.packed_fused_bifurcated_decode)
    n0 = [k.launches for k in kerns]
    for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1, (2, 2)):
        with pytest.raises(ValueError, match="splits"):
            tbd.grouped_fused_bifurcated_decode_q8(*forest, **FKW,
                                                   splits=bad)
    for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1, (2,), (0, 2), (None, 2),
                (2, 2, 2)):
        with pytest.raises(ValueError, match="splits"):
            tbd.packed_fused_bifurcated_decode(*packed, **pkw, splits=bad)
    plain_f = tbd.grouped_fused_bifurcated_decode_q8_plain
    plain_p = tbd.packed_fused_bifurcated_decode_plain
    assert _same(tbd.grouped_fused_bifurcated_decode_q8(*forest, **FKW),
                 plain_f(*forest, **FKW, splits=1))
    assert torch.equal(tbd.packed_fused_bifurcated_decode(*packed, **pkw),
                       plain_p(*packed, **pkw, splits=1))
    assert _same(
        tbd.grouped_fused_bifurcated_decode_q8(*forest, **FKW, splits=4),
        plain_f(*forest, **FKW, splits=3))
    assert torch.equal(
        tbd.packed_fused_bifurcated_decode(*packed, **pkw, splits=(4, 2)),
        plain_p(*packed, **pkw, splits=3))
    with pytest.raises(ValueError, match="entries_per_launch"):
        plain_p(*packed, **pkw, splits=3, entries_per_launch=2)
    assert [k.launches for k in kerns] == n0
