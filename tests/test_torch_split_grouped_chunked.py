"""Port parity for the split walk of the bf16 forest kernel #4
(``grouped_fused_bifurcated_decode``) and for the chunk order of kernel
#13 (``chunked_linear_attention``).

#4: its plain version at S shares per (64-row tile, kv head), merged
exactly, against the reference's Pallas kernel in interpret mode; one
result for every S > 1; the bf16 trie's split walk (#6) at depth 1, bit
for bit; a forest row unmoved when another segment changes.

#13: its plain version computes each chunk on its own, then the chain of
states, then the inter term (the kernel's order); held against the
reference's Pallas kernel in interpret mode and its sequential recurrence
in fp32, from an initial state too, and split at a chunk boundary into two
calls chained by the state.

Both wrappers' contracts on the CPU. The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_np, to_torch
from repro.kernels import bifurcated_decode as jbd
from repro.kernels.chunked_linear import chunked_linear_attention_kernel
from repro.models import linear_scan as jls
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import chunked_linear as tcl

# ---- #4: grouped_fused_bifurcated_decode ----

# a bf16-kernel forest of 5 segments of capacity 600: live lengths off the
# 64-key block (577 and 300 span three and two pieces of 256 keys), 65, 1
# and 0; 35 samples of 2 rows (a tile of 64 rows and one of 6), rows
# shuffled across the segments; ids -1 and G on two samples (NaN rows)
G, HD = 2, 32
SEG_LENS = (577, 65, 0, 1, 300)
B, C_D, P, CAP = 35, 4, 2, 600
FKW = dict(scale=HD**-0.5, c_d=C_D, pn=P)


def _forest_case(dtype="float32", seed=0, lens=SEG_LENS, bad_ids=True):
    """numpy operands of #4 in ``dtype``: q (g, rows, hd), K/V (G, g, cap,
    hd), the (rows,) group map, (G,) lengths, the decode arm (g, b * c_d,
    hd) and its (1, b * c_d) bias."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), dtype))

    n_groups = len(lens)
    kc, vc = r(n_groups, G, CAP, HD), r(n_groups, G, CAP, HD)
    gid = np.random.RandomState(7).randint(0, n_groups, size=B)
    if bad_ids:
        gid[3], gid[20] = -1, n_groups
    rows = np.repeat(gid, P).astype(np.int32)
    q = r(G, B * P, HD)
    kd, vd = r(G, B * C_D, HD), r(G, B * C_D, HD)
    live = np.arange(C_D)[None] < rng.randint(1, C_D + 1, size=B)[:, None]
    bias = np.where(live.reshape(1, -1), 0.0, -1e30).astype(np.float32)
    return [q, kc, vc, rows, np.array(lens, np.int32), kd, vd, bias]


def _bad(case):
    rows = case[3]
    return torch.from_numpy((rows < 0) | (rows >= len(case[4])))


@pytest.mark.parametrize("splits", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_split_plain_matches_reference(dtype, splits):
    """#4's plain version at S = 2 and 5 against the reference's Pallas
    kernel in interpret mode (its lane-replicated row map and per-segment
    bias) on the rows of ids in [0, G), fp32 at 1e-5 and bf16 at 2e-2; the
    rows of ids -1 and G come out NaN (the reference gives them the decode
    arm alone); one bit pattern for every S > 1."""
    case = _forest_case(dtype)
    q, kc, vc, rows, lens, kd, vd, bias = case
    cbias = np.where(np.arange(CAP)[None, :] < lens[:, None], 0.0,
                     -1e30).astype(np.float32)
    want = jbd.grouped_fused_bifurcated_decode(
        *map(jnp.asarray, (q, kc, vc,
                           np.broadcast_to(rows[:, None], (rows.size, 128)),
                           cbias, kd, vd, bias)),
        block_m=128, interpret=True, **FKW)
    t = [to_torch(x) for x in case]
    got = tbd.grouped_fused_bifurcated_decode_plain(*t, **FKW, splits=splits)
    bad = _bad(case)
    assert got.dtype == t[0].dtype
    assert torch.isnan(got[:, bad].float()).all()
    assert torch.isfinite(got[:, ~bad].float()).all()
    assert_close(got[:, ~bad], np.asarray(want)[:, ~bad.numpy()], dtype)
    other = tbd.grouped_fused_bifurcated_decode_plain(
        *t, **FKW, splits=2 if splits > 2 else 7)
    assert torch.equal(other[:, ~bad], got[:, ~bad])


@pytest.mark.parametrize("splits", [2, 3, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_split_is_the_trie_split_at_depth_one(dtype, splits):
    """The forest is the bf16 trie at depth 1: #4's plain split walk
    equals #6's at the same S on the rows of ids in [0, G), bit for bit
    (an id of -1 reads no node in the trie and is NaN in the forest)."""
    case = _forest_case(dtype)
    t = [to_torch(x) for x in case]
    got = tbd.grouped_fused_bifurcated_decode_plain(*t, **FKW, splits=splits)
    paths = t[3].clone()
    paths[paths >= len(SEG_LENS)] = -1     # the trie's NaN is another id's
    want = tbd.tree_fused_bifurcated_decode_plain(
        *t[:3], paths[None].contiguous(), *t[4:], **FKW, splits=splits)
    bad = _bad(case)
    assert torch.equal(got[:, ~bad], want[:, ~bad])


def test_grouped_split_rows_move_with_nothing_else():
    """A forest row's bits depend on its own segment only: unmoved when
    another segment is retired and readmitted with another length and
    other contents, at every S > 1; that segment's rows move."""
    case = _forest_case(bad_ids=False)
    t = [to_torch(x) for x in case]
    base = tbd.grouped_fused_bifurcated_decode_plain(*t, **FKW, splits=3)
    lens = list(SEG_LENS)
    lens[4] = 77                      # segment 4 readmitted: 77 new keys
    new = _forest_case(seed=5, lens=lens, bad_ids=False)
    u = [to_torch(x) for x in case]
    for j in (1, 2):                  # K and V of segment 4 only
        u[j][4] = to_torch(new[j])[4]
    u[4] = to_torch(np.array(lens, np.int32))
    rows4 = t[3] == 4
    assert rows4.any() and not rows4.all()
    for splits in (2, 3, 9):
        got = tbd.grouped_fused_bifurcated_decode_plain(*u, **FKW,
                                                        splits=splits)
        assert torch.equal(got[:, ~rows4], base[:, ~rows4]), splits
        assert not torch.equal(got[:, rows4], base[:, rows4])


def _same(a, b):
    """Bit-equal, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def test_grouped_wrapper_refuses_invalid_splits():
    """#4's ``splits``: None or an int in 1..MAX_SPLITS, on the CPU too;
    None runs splits=1 there (the single walk, bit for bit); a valid one
    runs the plain version at that S; no call moves ``.launches`` on the
    CPU."""
    forest = [to_torch(x) for x in _forest_case()]
    kern = tbd.grouped_fused_bifurcated_decode
    plain = tbd.grouped_fused_bifurcated_decode_plain
    n0 = kern.launches
    for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1, (2, 2)):
        with pytest.raises(ValueError, match="splits"):
            kern(*forest, **FKW, splits=bad)
    assert _same(kern(*forest, **FKW), plain(*forest, **FKW, splits=1))
    assert _same(kern(*forest, **FKW, splits=4),
                 plain(*forest, **FKW, splits=3))
    with pytest.raises(ValueError):            # k_ctx and v_ctx differ
        kern(forest[0], forest[1], forest[2][:, :, :10], *forest[3:], **FKW)
    assert kern.launches == n0


# ---- #13: chunked_linear_attention ----

# (b, n, H, dk, dv, chunk, normalize, initial state)
CHUNK_CASES = [
    (2, 50, 3, 8, 8, 16, False, False),     # ragged n: 3 chunks and 2 rows
    (1, 64, 2, 16, 16, 16, True, False),    # the normaliser column
    (2, 100, 16, 8, 8, 16, False, False),   # the reduced config's heads
    (2, 70, 3, 16, 8, 32, False, True),     # an initial state, dk != dv
    (1, 48, 2, 8, 8, 16, True, True),       # both
]


def _chunk_inputs(case):
    b, n, H, dk, dv, _, normalize, init = case
    rng = np.random.RandomState(sum(case[:6]))
    x = [rng.randn(b, n, H, dk).astype(np.float32),
         rng.randn(b, n, H, dk).astype(np.float32),
         rng.randn(b, n, H, dv).astype(np.float32),
         (-np.abs(rng.randn(b, n, H)) * 0.3).astype(np.float32)]
    s0 = (rng.randn(b, H, dk, dv + normalize).astype(np.float32) if init
          else None)
    return x, s0


def _recurrence(x, s0, normalize):
    """The reference's sequential oracle, one token at a time
    (``linear_attention_decode``), from ``s0`` (None: zero)."""
    if s0 is None:
        return jls.reference_linear_attention(*map(jnp.asarray, x),
                                              normalize=normalize)
    q, k, v, a = map(jnp.asarray, x)
    state, outs = jnp.asarray(s0), []
    for t in range(q.shape[1]):
        o, state = jls.linear_attention_decode(q[:, t], k[:, t], v[:, t],
                                               a[:, t], state,
                                               normalize=normalize)
        outs.append(o)
    return jnp.stack(outs, axis=1), state


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunked_plain_in_chain_order_matches_reference(case):
    """The plain version (each chunk on its own, then the chain of states,
    then the inter term) against the reference's sequential recurrence and,
    with no initial state, its Pallas kernel in interpret mode: fp32 at
    1e-5; the wrapper on CPU tensors runs it and launches nothing."""
    chunk, normalize = case[5], case[6]
    x, s0 = _chunk_inputs(case)
    t = [to_torch(a) for a in x]
    s0_t = None if s0 is None else to_torch(s0)
    n0 = tcl.chunked_linear_attention.launches
    out, st = tcl.chunked_linear_attention(*t, chunk=chunk,
                                           normalize=normalize,
                                           initial_state=s0_t)
    assert tcl.chunked_linear_attention.launches == n0
    out_p, st_p = tcl.chunked_linear_attention_plain(
        *t, chunk=chunk, normalize=normalize, initial_state=s0_t)
    assert torch.equal(out, out_p) and torch.equal(st, st_p)
    out_r, st_r = _recurrence(x, s0, normalize)
    assert_close(out, out_r, "float32")
    assert_close(st, st_r, "float32")
    if s0 is None:
        out_j, st_j = chunked_linear_attention_kernel(
            *map(jnp.asarray, x), chunk=chunk, normalize=normalize,
            interpret=True)
        assert_close(out, out_j, "float32")
        assert_close(st, st_j, "float32")


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_plain_chain_crosses_calls(normalize):
    """The chain is the whole carry: a sequence cut at a chunk boundary
    into two calls, the second from the first's final state, gives the one
    call's output and final state bit for bit."""
    case = (2, 80, 3, 8, 8, 16, normalize, True)
    x, s0 = _chunk_inputs(case)
    t = [to_torch(a) for a in x]
    kw = dict(chunk=16, normalize=False)
    v = t[2]
    if normalize:      # the ones column is v's: carried by the state too
        v = torch.cat([v, torch.ones(*v.shape[:-1], 1)], dim=-1)
    whole, st = tcl.chunked_linear_attention_plain(
        t[0], t[1], v, t[3], initial_state=to_torch(s0), **kw)
    first, st1 = tcl.chunked_linear_attention_plain(
        *(a[:, :48] for a in (t[0], t[1], v, t[3])),
        initial_state=to_torch(s0), **kw)
    second, st2 = tcl.chunked_linear_attention_plain(
        *(a[:, 48:] for a in (t[0], t[1], v, t[3])), initial_state=st1, **kw)
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert torch.equal(st2, st)


def test_chunked_plain_chain_faults_move_the_output():
    """What the kernel's chain must get right shows in the output: the
    state handed one chunk late, or the initial state dropped, moves rows
    by far more than the fp32 agreement above."""
    case = (1, 64, 2, 8, 8, 16, False, True)
    x, s0 = _chunk_inputs(case)
    t = [to_torch(a) for a in x]
    good, _ = tcl.chunked_linear_attention_plain(
        *t, chunk=16, initial_state=to_torch(s0))
    dropped, _ = tcl.chunked_linear_attention_plain(*t, chunk=16)
    err = (good - dropped).abs().amax()
    assert err > 1e-2 * good.abs().amax()
    # one chunk late: chunk c's rows against S_{c-1}; the second chunk on
    # its own from S_0 gives its intra term plus e^{A_i} q_i . S_0
    late, _ = tcl.chunked_linear_attention_plain(
        *(a[:, 16:32] for a in t), chunk=16, initial_state=to_torch(s0))
    assert (late - good[:, 16:32]).abs().amax() > 1e-2 * good.abs().amax()


def test_chunked_wrapper_refuses_what_it_refused():
    """Shapes, dtypes and the state's shape as before, and the
    ``ctas_per_sm`` knob (None or 1..MAX_CTAS_PER_SM), all before any
    launch; on the CPU a valid knob runs the plain version."""
    q = torch.zeros(1, 8, 2, 4)
    v = torch.zeros(1, 8, 2, 3)
    a = torch.zeros(1, 8, 2)
    n0 = tcl.chunked_linear_attention.launches
    with pytest.raises(ValueError):          # log_decay of the wrong shape
        tcl.chunked_linear_attention(q, q, v, a[:, :4])
    with pytest.raises(ValueError):          # an empty chunk
        tcl.chunked_linear_attention(q, q, v, a, chunk=0)
    with pytest.raises(ValueError):          # initial state of the wrong shape
        tcl.chunked_linear_attention(q, q, v, a,
                                     initial_state=torch.zeros(1, 2, 4, 4))
    with pytest.raises(TypeError):           # mixed dtypes
        tcl.chunked_linear_attention(q, q, v.bfloat16(), a)
    for bad in (0, True, 2.0, tcl.MAX_CTAS_PER_SM + 1):
        with pytest.raises(ValueError, match="ctas_per_sm"):
            tcl.chunked_linear_attention(q, q, v, a, ctas_per_sm=bad)
    x, s0 = _chunk_inputs((1, 40, 2, 8, 8, 16, False, True))
    t = [to_torch(y) for y in x]
    out, st = tcl.chunked_linear_attention(*t, chunk=16, ctas_per_sm=3,
                                           initial_state=to_torch(s0))
    want = tcl.chunked_linear_attention_plain(*t, chunk=16,
                                              initial_state=to_torch(s0))
    assert torch.equal(out, want[0]) and torch.equal(st, want[1])
    assert tcl.chunked_linear_attention.launches == n0
    assert np.isfinite(to_np(out)).all()
