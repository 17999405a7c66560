"""Port parity for the split walk of the single-prefix decode kernels #1
(``fused_bifurcated_decode``, bf16 context) and #3
(``fused_bifurcated_decode_q8``, int8 context): their plain versions at S
shares per (64-row tile, kv head), merged exactly, against the reference's
Pallas kernels in interpret mode (fp32, 1e-5) over ragged context lengths
and two row tiles; the result the same at every S > 1; S = 1 bit-identical
to the single walk the wrappers run on the CPU; #3's split walk bit-equal
to #9's (``paged_fused_bifurcated_decode_q8``) and #1's to #8's
(``paged_fused_bifurcated_decode``) on the same context in shuffled
pages; and ``split_shares`` at the bf16 context's weight.

The kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_torch
from repro.core import quantized as jq
from repro.kernels import bifurcated_decode as jbd
from repro_torch.kernels import bifurcated_decode as tbd

G, HD, C_D, PM = 2, 16, 4, 48
B, PN = 35, 2           # 70 query rows: a tile of 64 and one of 6
BLOCK_M = 128           # the reference's context block
KEYS = {"bf16": ("q", "kc", "vc", "kd", "vd", "bias"),
        "int8": ("q", "kq", "vq", "ks", "vs", "kd", "vd", "bias")}


def _inputs(m_c, seed=0):
    """fp32 queries, context (and its int8 quantization, the logit scale
    folded into k_scale) and decode arm of B samples of PN rows, each with
    1..C_D live slots, as numpy."""
    rng = np.random.RandomState(seed)
    rows, ld = B * PN, B * C_D
    kc, vc = rng.randn(G, m_c, HD), rng.randn(G, m_c, HD)
    kq, ks = jq.quantize_ctx(jnp.asarray(kc, jnp.float32), fold_scale=HD**-0.5)
    vq, vs = jq.quantize_ctx(jnp.asarray(vc, jnp.float32))
    live = np.arange(C_D)[None, :] < rng.randint(1, C_D + 1, size=B)[:, None]
    a = {"q": rng.randn(G, rows, HD), "kc": kc, "vc": vc,
         "kd": rng.randn(G, ld, HD), "vd": rng.randn(G, ld, HD)}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a.update(kq=np.asarray(kq), vq=np.asarray(vq), ks=np.asarray(ks),
             vs=np.asarray(vs),
             bias=np.where(live.reshape(1, ld), 0.0, -1e30).astype(np.float32))
    return a


def _port(kind, a, **kw):
    fn = (tbd.fused_bifurcated_decode_plain if kind == "bf16"
          else tbd.fused_bifurcated_decode_q8_plain)
    return fn(*(to_torch(a[k]) for k in KEYS[kind]), scale=HD**-0.5,
              c_d=C_D, pn=PN, **kw)


@pytest.mark.parametrize("m_c", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_single_split_plain_matches_reference(kind, m_c):
    """#1 / #3's plain versions at S = 2, 5 and 64 (most shares empty)
    against the reference's Pallas kernel in interpret mode, fp32 at 1e-5:
    one bit pattern for every S > 1; S = 1 is the single walk the wrapper
    runs on the CPU (splits None), bit for bit."""
    a = _inputs(m_c, seed=m_c)
    ref = jbd.fused_bifurcated_decode if kind == "bf16" else \
        jbd.fused_bifurcated_decode_q8
    want = ref(*(jnp.asarray(a[k]) for k in KEYS[kind]), scale=HD**-0.5,
               c_d=C_D, pn=PN, block_m=BLOCK_M, interpret=True)
    split = _port(kind, a, splits=2)
    assert_close(split, want, "float32")
    for splits in (5, 64):
        assert torch.equal(_port(kind, a, splits=splits), split)
    single = _port(kind, a)
    assert torch.equal(_port(kind, a, splits=1), single)
    wrapper = (tbd.fused_bifurcated_decode if kind == "bf16"
               else tbd.fused_bifurcated_decode_q8)
    n0 = wrapper.launches
    got = wrapper(*(to_torch(a[k]) for k in KEYS[kind]), scale=HD**-0.5,
                  c_d=C_D, pn=PN)
    assert wrapper.launches == n0 and torch.equal(got, single)
    assert_close(single, want, "float32")


def _single_pages(a, names, seed):
    """The context arrays ``names`` of ``a`` (m_c 300) on shuffled pages of
    48 in a pool with 2 spare pages of NaN (int8: 127): (page table row
    (1, ppn), pools as torch)."""
    ppn = -(-300 // PM)
    perm = np.random.RandomState(seed).permutation(ppn + 2)
    table = perm[:ppn].astype(np.int32)[None]
    pools = []
    for name in names:
        x = a[name]
        pad = np.zeros(x.shape[:1] + (ppn * PM - 300,) + x.shape[2:], x.dtype)
        slab = np.concatenate([x, pad], 1).reshape(
            (G, ppn, PM) + x.shape[2:]).swapaxes(0, 1)
        pool = np.full((ppn + 2, G, PM) + x.shape[2:],
                       127 if x.dtype == np.int8 else np.nan, x.dtype)
        pool[table[0]] = slab
        pools.append(to_torch(pool))
    return to_torch(table), pools


def _paged_single(kind, a, pools, table, splits):
    """#8 / #9's plain version over the single prefix's pages at
    ``splits``: one segment of 300 keys on every row's depth-1 path."""
    fn = (tbd.paged_fused_bifurcated_decode_plain if kind == "bf16"
          else tbd.paged_fused_bifurcated_decode_q8_plain)
    t = {k: to_torch(a[k]) for k in ("q", "kd", "vd", "bias")}
    return fn(t["q"], *pools, table, torch.tensor([300], dtype=torch.int32),
              torch.zeros(1, B * PN, dtype=torch.int32), t["kd"], t["vd"],
              t["bias"], scale=HD**-0.5, c_d=C_D, pn=PN, splits=splits)


def test_q8_split_walk_is_the_paged_split_walk():
    """#3 cuts #9's pieces: its plain split walk equals #9's plain split
    walk over the same context on shuffled pages of 48 (a block straddles
    pages; spare pages of NaN are never read), bit for bit, at S 3 and 7."""
    a = _inputs(300, seed=7)
    table, pools = _single_pages(a, ("kq", "vq", "ks", "vs"), 8)
    for splits in (3, 7):
        paged = _paged_single("int8", a, pools, table, splits)
        assert torch.isfinite(paged).all()
        assert torch.equal(_port("int8", a, splits=splits), paged)


def test_bf16_split_walk_is_the_paged_split_walk():
    """#1 cuts #8's pieces: the bf16 twin of the int8 case above, #1's
    plain split walk against #8's over shuffled pages of 48, bit for bit,
    at S 3 and 7."""
    a = _inputs(300, seed=9)
    table, pools = _single_pages(a, ("kc", "vc"), 10)
    for splits in (3, 7):
        paged = _paged_single("bf16", a, pools, table, splits)
        assert torch.isfinite(paged).all()
        assert torch.equal(_port("bf16", a, splits=splits), paged)


# the main shapes: g 8, 64 rows, m_c 8192, 32 x 24 decode slots (S 33);
# zamba2's shared block: g 32, 32 rows (S 8); a ragged single context
@pytest.mark.parametrize("case", [
    ("main", 64, 8, 8192, 32 * 24, 33),
    ("hd 112", 32, 32, 8192, 32 * 24, 8),
    ("ragged", 70, 2, 300, 35 * 4, 64)])
def test_single_split_shares(case):
    """``split_count`` at #1 / #3's shapes, and ``split_shares`` at the
    bf16 context's weight as at the int8 one: every context and decode
    block in exactly one share, in order, cut only at piece bounds, no
    share heavier than the cap a tighter packing would need."""
    name, rows, g, m_c, dec_slots, want = case
    assert tbd.split_count(rows, g, sms=132) == want, name
    n_ctx = -(-m_c // tbd.KEY_BLOCK)
    n_dec = -(-dec_slots // tbd.KEY_BLOCK)
    for weight in (tbd.CTX_WEIGHT_BF16, tbd.CTX_WEIGHT):
        for s in sorted({2, 5, want}):
            shares = tbd.split_shares([n_ctx], n_dec, s, ctx_weight=weight)
            assert len(shares) == s
            for k, total in ((0, n_ctx), (1, n_dec)):
                ranges = [sh[k] for sh in shares]
                assert [b for lo, hi in ranges for b in range(lo, hi)] == \
                    list(range(total)), (name, weight, s, k)
                assert all(lo % tbd.PIECE_BLOCKS == 0 or lo == total
                           for lo, _ in ranges)
            loads = [weight * (i1 - i0) + (b1 - b0)
                     for (i0, i1), (b0, b1) in shares]
            pieces = [weight * min(tbd.PIECE_BLOCKS, n_ctx - b)
                      for b in range(0, n_ctx, tbd.PIECE_BLOCKS)]
            pieces += [min(tbd.PIECE_BLOCKS, n_dec - b)
                       for b in range(0, n_dec, tbd.PIECE_BLOCKS)]
            # the heaviest share is as light as a greedy packing of whole
            # pieces into s runs allows
            assert max(loads) >= max(pieces)
            assert max(loads) <= max(pieces) + -(-sum(pieces) // s)


def test_single_wrappers_take_only_valid_splits():
    """``splits`` is None or an int in 1..MAX_SPLITS, on the CPU too."""
    a = _inputs(65)
    for kind in ("bf16", "int8"):
        wrapper = (tbd.fused_bifurcated_decode if kind == "bf16"
                   else tbd.fused_bifurcated_decode_q8)
        args = [to_torch(a[k]) for k in KEYS[kind]]
        for bad in (0, True, 1.5, tbd.MAX_SPLITS + 1):
            with pytest.raises(ValueError, match="splits"):
                wrapper(*args, scale=HD**-0.5, c_d=C_D, pn=PN, splits=bad)
        assert torch.equal(
            wrapper(*args, scale=HD**-0.5, c_d=C_D, pn=PN, splits=4),
            _port(kind, a, splits=4))
