"""Port parity for the split walk of the node-set decode kernels: #6 / #7
(``tree_fused_bifurcated_decode[_q8]``, bf16 / int8 nodes) and #8 / #9
(``paged_fused_bifurcated_decode[_q8]``): their plain versions at S
shares per (64-row tile, kv head), merged exactly, against the
reference's Pallas kernels in interpret mode (fp32, 1e-5) on a ragged
trie; S = 1 bit-identical to the single walk the dispatchers run on the
CPU; and ``split_count`` / ``split_shares``, which the kernels' cut
mirrors; and the rows of one request keeping their bits when another's
leaf changes.

The kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_torch
from repro.core import quantized as jq
from repro.kernels import ops as jops
from repro_torch.kernels import bifurcated_decode as tbd
from repro_torch.kernels import ops as tops

G_KV, HD, CAP, PM, C_D = 2, 16, 160, 48, 4
# ragged lengths (0, 1, 63, 64, 65 and a block split across pages of 48),
# a node repeated on one path, a depth-1 path beside depth-3 ones
NODE_LENS = np.array([150, 1, 63, 64, 65, 0, 130], np.int32)
PATHS = np.array([[0, 0, 3, 0, 6, 0, 2],
                  [1, 2, -1, 1, -1, 4, 2],
                  [4, 5, -1, 6, -1, 4, -1]], np.int32)
NODES = ["bf16", "int8"]


def _n_ctx(nodes):
    """The context operands a kernel of ``nodes`` takes: K, V (and their
    scales for int8)."""
    return 4 if nodes == "int8" else 2


def _case(kind, n, nodes="int8"):
    """[q, K/V (dense nodes, or shuffled pool pages of 48 and their
    tables): fp32 for bf16 nodes, int8 values and f32 scales for int8,
    node lens, paths, decode arm, mask] as numpy; ``n`` fresh positions
    per slot (2 x 7 x n query rows)."""
    rng = np.random.RandomState(11)
    b = PATHS.shape[1]
    shape = (len(NODE_LENS), G_KV, CAP, HD)
    kc, vc = rng.randn(*shape), rng.randn(*shape)
    if nodes == "int8":
        kq, ks = jq.quantize_ctx(jnp.asarray(kc, jnp.float32),
                                 fold_scale=HD**-0.5)
        vq, vs = jq.quantize_ctx(jnp.asarray(vc, jnp.float32))
        ctx = [np.asarray(x) for x in (kq, vq, ks, vs)]
    else:
        ctx = [kc.astype(np.float32), vc.astype(np.float32)]
    q = rng.randn(b, G_KV, 2, n, HD).astype(np.float32)
    kd = rng.randn(b, C_D, G_KV, HD).astype(np.float32)
    vd = rng.randn(b, C_D, G_KV, HD).astype(np.float32)
    mask = np.arange(C_D)[None, :] < rng.randint(1, C_D + 1, size=b)[:, None]
    tail = [NODE_LENS, PATHS, kd, vd, mask]
    if kind == "tree":
        return [q] + ctx + [PATHS, NODE_LENS, kd, vd, mask]
    ppn = -(-CAP // PM)
    need = [-(-int(m) // PM) for m in NODE_LENS]
    perm = rng.permutation(sum(need) + 3)
    tables = np.full((len(NODE_LENS), ppn), -1, np.int32)
    pools = [np.zeros((len(perm),) + x.shape[1:2] + (PM,) + x.shape[3:],
                      x.dtype) for x in ctx]
    at = 0
    for nid, k in enumerate(need):
        tables[nid, :k] = perm[at:at + k]
        at += k
        for j in range(k):
            for src, pool in zip(ctx, pools):
                part = src[nid, :, j * PM:(j + 1) * PM]
                pool[tables[nid, j], :, :part.shape[1]] = part
    return [q] + pools + [tables] + tail


def _port(kind, arrs, splits, nodes="int8"):
    """The port's wrapper at ``splits`` on CPU tensors (the plain
    version), in the dispatchers' layout."""
    t = [to_torch(x) for x in arrs]
    n_ctx = _n_ctx(nodes)
    q, kd, vd, mask = t[0], t[-3], t[-2], t[-1]
    ctx, (first, lens) = t[1:1 + n_ctx], t[1 + n_ctx:3 + n_ctx]
    paths = t[-4] if kind == "paged" else first
    qk, path_rows, kd_, vd_, bias = tops._slot_operands(q, paths, kd, vd,
                                                        mask)
    kw = dict(scale=HD**-0.5, c_d=C_D, pn=q.shape[2] * q.shape[3],
              splits=splits)
    q8 = "_q8" if nodes == "int8" else ""
    if kind == "tree":
        out = getattr(tbd, f"tree_fused_bifurcated_decode{q8}")(
            qk, *ctx, path_rows, lens.contiguous(), kd_, vd_, bias, **kw)
    else:
        out = getattr(tbd, f"paged_fused_bifurcated_decode{q8}")(
            qk, *ctx, first, lens, path_rows, kd_, vd_, bias, **kw)
    return tops._from_rows(out, q)


def _reference(kind, arrs, nodes="int8"):
    a = [jnp.asarray(x) for x in arrs]
    q8 = "_q8" if nodes == "int8" else ""
    if kind == "tree":
        return getattr(jops, f"tree_bifurcated_decode_attention{q8}")(
            *a, block_m=128, interpret=True, ctx_layout="gmk")
    return getattr(jops, f"paged_bifurcated_decode_attention{q8}")(
        *a, interpret=True)


@pytest.mark.parametrize("nodes", NODES)
@pytest.mark.parametrize("kind", ["tree", "paged"])
def test_split_plain_matches_reference(kind, nodes):
    """#6 / #7 / #8 / #9's plain versions at S = 2, 5 and 64 (most shares
    empty) against the reference's Pallas kernel in interpret mode, fp32
    at 1e-5, over two row tiles; S = 1 is the single walk the dispatcher
    runs, bit for bit; the split result does not depend on S."""
    arrs = _case(kind, 5, nodes)     # 70 rows: a tile of 64 and one of 6
    want = _reference(kind, arrs, nodes)
    single = _port(kind, arrs, 1, nodes)
    q8 = "_q8" if nodes == "int8" else ""
    disp = getattr(tops, f"{kind}_bifurcated_decode_attention{q8}")
    assert torch.equal(single, disp(*[to_torch(x) for x in arrs]))
    assert torch.equal(single, _port(kind, arrs, None, nodes))
    assert_close(single, want, "float32")
    split = _port(kind, arrs, 2, nodes)
    assert_close(split, want, "float32")
    for splits in (5, 64):
        assert torch.equal(_port(kind, arrs, splits, nodes), split)


@pytest.mark.parametrize("nodes", NODES)
def test_split_walks_of_tree_and_pages_agree(nodes):
    """The shares are cut by logical key positions: the tree and paged
    plain versions of one logical trie at the same S agree in fp32, and a
    bad id on a path gives NaN rows at any S."""
    tree, paged = _case("tree", 1, nodes), _case("paged", 1, nodes)
    for splits in (3, 7):
        assert_close(_port("tree", tree, splits, nodes),
                     _port("paged", paged, splits, nodes), "float32")
    bad = [x.copy() for x in tree]
    bad[1 + _n_ctx(nodes)][1, 2] = len(NODE_LENS)   # slot 2: an id past
    out = _port("tree", bad, 4, nodes)              # the table
    assert torch.isnan(out[2]).all()
    assert torch.isfinite(out[[0, 1, 3, 4, 5, 6]]).all()


@pytest.mark.parametrize("nodes", NODES)
def test_split_rows_do_not_move_with_other_requests(nodes):
    """A piece's bounds depend on its own node's length alone: when another
    request's leaf changes length and contents (a cancel and readmit), the
    other rows' split outputs keep their bits."""
    arrs = _case("tree", 1, nodes)
    before = _port("tree", arrs, 6, nodes)
    moved = [x.copy() for x in arrs]
    at = 2 + _n_ctx(nodes)           # the node lengths
    lens = moved[at].copy()
    lens[5] = 140                    # node 5: slot 1's leaf, 0 keys before
    moved[at] = lens
    for i in (1, 2):                 # its keys and values
        moved[i][5] = np.roll(moved[i][5], 3, axis=1)
    after = _port("tree", moved, 6, nodes)
    others = [0, 2, 3, 4, 5, 6]      # every slot but 1 (node 5 on its path)
    assert torch.equal(before[others], after[others])
    assert not torch.equal(before[1], after[1])


# the main shapes (g 8, 64 rows): single prefix m_c 8192 with 32 x 24 decode
# slots; the served trie's node lengths with 32 x 64
SINGLE = ([8192], 32 * 24)
TRIE = ([4096, 2048, 1200, 500, 1024, 1800, 300], 32 * 64)


@pytest.mark.parametrize("case", [
    ("main single", 64, 8, 132, SINGLE, 33),
    ("main trie", 64, 8, 132, TRIE, 33),
    ("tiles fill the card", 64 * 17, 8, 132, SINGLE, 1),
    ("two tiles", 72, 8, 132, TRIE, 16),
    ("tiny", 9, 1, 132, ([0, 1, 65], 5 * 9), 64)])
def test_split_count_and_shares(case):
    """``split_count`` returns 1 once the tiles x g CTAs fill the SMs and a
    wave of two CTAs an SM otherwise; ``split_shares`` gives each context
    and decode block to exactly one share, in order, cut only at piece
    bounds; at the main shapes the decode arm spans at least two shares."""
    name, rows, g, sms, (lens, dec_slots), want = case
    splits = tbd.split_count(rows, g, sms=sms)
    assert splits == want, name
    blocks = [-(-m // tbd.KEY_BLOCK) for m in lens]
    n_ctx, n_dec = sum(blocks), -(-dec_slots // tbd.KEY_BLOCK)
    first, bounds = 0, {n_ctx}   # where context pieces may start or end
    for nb in blocks:
        bounds.update(range(first, first + nb, tbd.PIECE_BLOCKS))
        first += nb
    for s in {2, 5, 16, 64, splits} - {1}:
        shares = tbd.split_shares(blocks, n_dec, s)
        assert len(shares) == s
        for k, total, cuts in ((0, n_ctx, bounds),
                               (1, n_dec, set(range(0, n_dec,
                                                    tbd.PIECE_BLOCKS))
                                | {n_dec})):
            ranges = [sh[k] for sh in shares]
            assert [b for lo, hi in ranges for b in range(lo, hi)] == list(
                range(total)), (name, s, k)
            assert all(lo in cuts | {total} for lo, _ in ranges)
    if name.startswith("main"):
        shares = tbd.split_shares(blocks, n_dec, splits)
        assert sum(hi > lo for _, (lo, hi) in shares) >= 2
