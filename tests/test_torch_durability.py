"""Port parity for the serving layer's durability pieces, host-side and
fast: the write-ahead journal (``runtime/journal``), fault plans
(``runtime/faults``), heartbeat and supervision
(``runtime/fault_tolerance``), the snapshot store
(``checkpoint.ServeCheckpointer``) and the KV checksums
(``core/integrity``).

The journal and the fault plans are held against the reference's own
modules: the same records give the same file bytes, each reads the other's
files, and the same seed gives the same plan and the same victims.
``segment_checksum`` equals the reference's on identical bytes, for dense
and paged stores of the trie and the forest, bf16 and int8: the same
float32 K/V are written into the reference's cache and the port's (both
round them to bf16, or quantize them round-half-even, bit for bit)."""
import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread)
from repro.core import integrity as j_integrity
from repro.core import paged as jpaged
from repro.core import quantized as jq
from repro.runtime import faults as jfaults
from repro.runtime.journal import Journal as JJournal
from repro_torch.checkpoint import ServeCheckpointer
from repro_torch.core import integrity
from repro_torch.core import paged as tpaged
from repro_torch.core import quantized as tq
from repro_torch.core.errors import KVCorruption
from repro_torch.runtime.fault_tolerance import (Heartbeat, StaleHeartbeat,
                                                 supervise)
from repro_torch.runtime.faults import (FaultEvent, FaultKind, FaultPlan,
                                        ProcessKilled)
from repro_torch.runtime.journal import Journal
from repro_torch.runtime.serve import ForestState


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------

RECORDS = [{"ev": "submit", "tid": 0, "segments": [[1, 2, 3]]},
           {"ev": "round", "round": 1, "obs": [{"ev": "admit", "slots": [0]}]},
           {"ev": "round", "round": 2, "decode_steps": None, "obs": []}]


def _write(cls, path, records):
    j = cls(path)
    for r in records:
        j.append(r)
    j.close()


def test_journal_bytes_equal_the_reference_and_read_across(tmp_path):
    pt, pj = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    _write(Journal, pt, RECORDS)
    _write(JJournal, pj, RECORDS)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert Journal.read(pj) == JJournal.read(pt) == (RECORDS, True)


@pytest.mark.parametrize("damage", ["torn", "crc", "seq"])
def test_journal_damage_stops_read_like_the_reference(tmp_path, damage):
    p = str(tmp_path / "j.log")
    _write(Journal, p, RECORDS)
    raw = open(p, "rb").read()
    if damage == "torn":
        raw = raw[:-5]
    elif damage == "crc":
        lines = raw.splitlines(keepends=True)
        line = bytearray(lines[1])
        line[-3] ^= 0x01
        raw = lines[0] + bytes(line) + lines[2]
    else:
        payload = json.dumps({"i": "rogue"}, separators=(",", ":"))
        raw += f"7 {zlib.crc32(payload.encode()):08x} {payload}\n".encode()
    open(p, "wb").write(raw)
    got = Journal.read(p)
    assert got == JJournal.read(p)
    assert not got[1]
    assert got[0] == RECORDS[:{"torn": 2, "crc": 1, "seq": 3}[damage]]


def test_journal_reopen_compact_and_missing_file(tmp_path):
    assert Journal.read(str(tmp_path / "nope.log")) == ([], True)
    p = str(tmp_path / "j.log")
    _write(Journal, p, RECORDS)
    assert Journal(p).seq == 3
    before = open(p, "rb").read()
    assert Journal.compact(p) == 3 and open(p, "rb").read() == before
    os.truncate(p, os.path.getsize(p) - 5)
    assert Journal.compact(p) == 2
    j = Journal(p)
    assert j.seq == 2
    j.append({"i": 9})
    j.close()
    assert Journal.read(p) == (RECORDS[:2] + [{"i": 9}], True)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 353, 9886])
def test_fault_plan_random_equals_the_reference(seed):
    for kw in (dict(rounds=10, rate=0.35), dict(rounds=50, rate=0.5),
               dict(rounds=30, rate=1.0, max_arg=7, max_hold=5)):
        got = FaultPlan.random(seed, **kw)
        want = jfaults.FaultPlan.random(seed, **kw)
        assert ([(e.round, e.kind, e.arg, e.hold) for e in got.events]
                == [(e.round, e.kind, e.arg, e.hold) for e in want.events])
        assert got.counts() == want.counts()
    a, b = FaultPlan(seed=seed), jfaults.FaultPlan(seed=seed)
    for n in (1, 3, 10, 2, 7):
        assert a.choose(list(range(n))) == b.choose(list(range(n)))
    assert a.rng_state() == b.rng_state()


def test_fault_kinds_and_plan_surface():
    assert FaultKind.ALL == FaultKind.registered() == jfaults.FaultKind.ALL
    assert set(FaultPlan.random(3, rounds=4000, rate=1.0).counts()) == set(
        FaultKind.ALL)
    ev = [FaultEvent(5, FaultKind.POOL_EXHAUST, arg=3, hold=2),
          FaultEvent(2, FaultKind.DOUBLE_RELEASE)]
    plan = FaultPlan(ev, seed=0)
    assert [e.round for e in plan.events] == [2, 5]
    assert plan.at(5) == [ev[0]] and plan.at(3) == []
    assert "pool_exhaust" in repr(plan) and FaultPlan(seed=9).choose([]) is None
    plan = FaultPlan([FaultEvent(2, FaultKind.KILL_PROCESS),
                      FaultEvent(5, FaultKind.KILL_PROCESS),
                      FaultEvent(5, FaultKind.POOL_EXHAUST)])
    assert plan.disable(FaultKind.KILL_PROCESS, upto_round=4) == 1
    assert [(e.round, e.kind) for e in plan.events] == [
        (5, FaultKind.KILL_PROCESS), (5, FaultKind.POOL_EXHAUST)]
    assert issubclass(ProcessKilled, RuntimeError)


def test_fault_plan_rng_state_json_roundtrip_across_packages():
    a = FaultPlan(seed=5)
    seq = list(range(20))
    [a.choose(seq) for _ in range(3)]
    state = json.loads(json.dumps(a.rng_state()))
    b = FaultPlan(seed=0).set_rng_state(state)
    c = jfaults.FaultPlan(seed=0).set_rng_state(state)
    picks = [a.choose(seq) for _ in range(10)]
    assert picks == [b.choose(seq) for _ in range(10)]
    assert picks == [c.choose(seq) for _ in range(10)]


# ---------------------------------------------------------------------------
# heartbeat + supervise
# ---------------------------------------------------------------------------

def test_heartbeat_staleness(tmp_path):
    hb = Heartbeat(str(tmp_path / "deep" / "hb"))
    assert hb.last() is None and not hb.stale(0.0)   # never beaten
    hb.beat(7)
    step, ts = hb.last()
    assert step == 7 and not hb.stale(60.0)
    open(hb.path, "w").write(f"3 {ts - 100}\n")
    assert hb.stale(60.0) and not hb.stale(1000.0)
    open(hb.path, "w").write(f"3 {ts + 3600}\n")     # clock skew: not stale
    assert not hb.stale(60.0)
    open(hb.path, "w").write("garbage")
    assert hb.last() is None and not hb.stale(0.0)
    assert issubclass(StaleHeartbeat, RuntimeError)


def test_supervise_restart_ladder():
    assert supervise(lambda: 42) == 42
    calls, hooks, sleeps = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise RuntimeError("boom")
        return "ok"

    assert supervise(flaky, max_restarts=5, backoff_s=1.0, backoff_cap_s=3.0,
                     sleep=sleeps.append,
                     on_failure=lambda a, e: hooks.append(a)) == "ok"
    assert hooks == [1, 2, 3] and sleeps == [1.0, 2.0, 3.0]

    def boom():
        raise ValueError("always")

    with pytest.raises(ValueError):
        supervise(boom, max_restarts=2, on_failure=lambda a, e: None)

    def bad_recover(a, e):
        raise KeyError("recovery failed")

    with pytest.raises(KeyError):
        supervise(boom, max_restarts=5, on_failure=bad_recover)


# ---------------------------------------------------------------------------
# ServeCheckpointer
# ---------------------------------------------------------------------------

def _device_state():
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)                      # a moved stream
    return ForestState(
        cache={"pool": torch.from_numpy(rng.randn(2, 4, 8).astype(
                   np.float32)).to(torch.bfloat16),
               "scales": torch.from_numpy(
                   rng.randint(-127, 127, (2, 4)).astype(np.int8)),
               "lens": torch.from_numpy(rng.randint(0, 9, (4,)).astype(
                   np.int32))},
        tokens=torch.arange(4, dtype=torch.int64)[:, None],
        active=torch.tensor([True, False, True, True]),
        steps=torch.tensor([1, 0, 3, 2], dtype=torch.int32),
        generator=gen)


def _like(st):
    return ForestState(
        cache={k: torch.zeros_like(v) for k, v in st.cache.items()},
        tokens=torch.zeros_like(st.tokens), active=torch.zeros_like(
            st.active), steps=torch.zeros_like(st.steps),
        generator=torch.Generator())


def test_serve_ckpt_bit_exact_roundtrip_with_generator(tmp_path):
    ck = ServeCheckpointer(str(tmp_path))
    dev = _device_state()
    host = {"round": 5, "tickets": [1, 2, 3]}
    ck.save(5, dev, host)
    meta = json.load(open(os.path.join(ck.path_for(5), "meta.json")))
    assert {e["key"]: e["dtype"] for e in meta["manifest"]} == {
        "cache.lens": "int32", "cache.pool": "bfloat16",
        "cache.scales": "int8", "tokens": "int64", "active": "bool",
        "steps": "int32", "generator": "uint8"}
    r, dev2, host2 = ck.load_latest(_like(dev))
    assert r == 5 and host2 == host
    for k in dev.cache:
        a, b = dev.cache[k], dev2.cache[k]
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    for name in ("tokens", "active", "steps"):
        assert torch.equal(getattr(dev, name), getattr(dev2, name))
    # the restored stream draws the noise the saved one would have drawn
    assert torch.equal(torch.rand(6, generator=dev2.generator),
                       torch.rand(6, generator=dev.generator))


def test_serve_ckpt_loads_into_the_template_in_place(tmp_path):
    """A load fills the template's own tensors and generator (no second
    copy of the state); a load refused by a CRC check writes none."""
    ck = ServeCheckpointer(str(tmp_path))
    dev = _device_state()
    ck.save(1, dev, {"round": 1})
    ck.save(2, dev, {"round": 2})
    path = os.path.join(ck.path_for(2), "arrays.bin")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 1)
        b = f.read(1)
        f.seek(os.path.getsize(path) - 1)
        f.write(bytes([b[0] ^ 0x01]))
    tmpl = _like(dev)
    with pytest.raises(KVCorruption):
        ck.load(2, tmpl)
    assert all(not v.any() for v in tmpl.cache.values())
    dev2, _ = ck.load(1, tmpl)
    assert dev2.generator is tmpl.generator
    for k in dev.cache:
        assert dev2.cache[k] is tmpl.cache[k]
    for name in ("tokens", "active", "steps"):
        assert getattr(dev2, name) is getattr(tmpl, name)
        assert torch.equal(getattr(dev2, name), getattr(dev, name))
    assert torch.equal(torch.rand(4, generator=dev2.generator),
                       torch.rand(4, generator=dev.generator))


def test_serve_ckpt_detects_bit_flip_and_falls_back(tmp_path):
    ck = ServeCheckpointer(str(tmp_path))
    dev = _device_state()
    ck.save(2, dev, {"round": 2})
    ck.save(4, dev, {"round": 4})
    path = os.path.join(ck.path_for(4), "arrays.bin")
    with open(path, "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(KVCorruption):
        ck.load(4, _like(dev))
    r, _, host2 = ck.load_latest(_like(dev))
    assert r == 2 and host2 == {"round": 2}
    assert ck.all_rounds() == [2]
    assert os.path.exists(ck.path_for(4) + ".corrupt")


def test_serve_ckpt_rejections(tmp_path):
    ck = ServeCheckpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.load_latest({"x": torch.zeros(2)})
    dev = _device_state()
    ck.save(1, dev, {"secret": "payload"})
    bad = _like(dev)
    bad.cache["extra"] = torch.zeros(3)
    with pytest.raises(KVCorruption, match="incompatible"):
        ck.load(1, bad)
    short = _like(dev)
    short.cache["lens"] = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(KVCorruption, match="shape"):
        ck.load(1, short)
    meta_path = os.path.join(ck.path_for(1), "meta.json")
    meta = json.loads(open(meta_path).read())
    meta["host"] = meta["host"].replace("payload", "tampered")
    open(meta_path, "w").write(json.dumps(meta))
    with pytest.raises(KVCorruption):
        ck.load(1, _like(dev))


def test_serve_ckpt_validate_hook_and_gc(tmp_path):
    ck = ServeCheckpointer(str(tmp_path / "a"))
    dev = _device_state()
    ck.save(2, dev, {"round": 2})
    ck.save(4, dev, {"round": 4})

    def validate(round_, device_state, host):
        if round_ == 4:
            raise KVCorruption("engine-level verification failed")

    assert ck.load_latest(_like(dev), validate=validate)[0] == 2
    assert os.path.exists(ck.path_for(4) + ".corrupt")
    ck = ServeCheckpointer(str(tmp_path / "b"), keep_last_k=2)
    for r in (1, 2, 3, 4):
        ck.save(r, dev, {})
    assert ck.all_rounds() == [3, 4]


# ---------------------------------------------------------------------------
# KV checksums: equal to the reference's on identical bytes
# ---------------------------------------------------------------------------

L, G_KV, HD, CAP, PAGE, SLOTS, C_D = 2, 2, 16, 24, 8, 4, 4
LENS = [19, 7, 24]


def _kv(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(L, m, G_KV, HD).astype(np.float32),
             rng.randn(L, m, G_KV, HD).astype(np.float32)) for m in LENS]


def _pair_caches(kind, store, dtype):
    """The reference's cache and the port's, both holding the same three
    segments (written through each package's own write path)."""
    quant = "int8" if dtype == "int8" else "none"
    n = len(LENS)
    ppn = CAP // PAGE
    if kind == "tree":
        dims = (L, n, 2, SLOTS, CAP, C_D, G_KV, HD)
        if store == "paged":
            j = jpaged.PagedPrefixTreeCache.init(
                *dims, page_m=PAGE, num_pages=n * ppn + 2, ctx_quant=quant)
            t = tpaged.PagedPrefixTreeCache.init(
                *dims, page_m=PAGE, num_pages=n * ppn + 2, ctx_quant=quant,
                device="cpu")
        else:
            j = jq.tree_cache_family(quant).init(*dims)
            t = tq.tree_cache_family(quant).init(*dims, device="cpu")
        j_write, t_write = "write_node", "write_node"
    else:
        dims = (L, n, SLOTS, CAP, C_D, G_KV, HD)
        if store == "paged":
            j = jpaged.PagedGroupedBifurcatedCache.init(
                *dims, page_m=PAGE, num_pages=n * ppn + 2, ctx_quant=quant)
            t = tpaged.PagedGroupedBifurcatedCache.init(
                *dims, page_m=PAGE, num_pages=n * ppn + 2, ctx_quant=quant,
                device="cpu")
        else:
            j = jq.forest_cache_family(quant).init(*dims)
            t = tq.forest_cache_family(quant).init(*dims, device="cpu")
        j_write, t_write = "write_context", "write_context"
    # shuffled, non-contiguous page ids (two spare pages stay free)
    perm = np.random.RandomState(5).permutation(n * ppn + 2).tolist()
    for i, (k, v) in enumerate(_kv(1)):
        extra = ()
        if store == "paged":
            extra = (perm[i * ppn: i * ppn + -(-k.shape[1] // PAGE)],)
        j = getattr(j, j_write)(jnp.asarray(k), jnp.asarray(v), i, *extra)
        getattr(t, t_write)(torch.from_numpy(k), torch.from_numpy(v), i,
                            *extra)
    return j, t


@pytest.mark.parametrize("kind", ["tree", "forest"])
@pytest.mark.parametrize("store", ["dense", "paged"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_segment_checksum_equals_the_reference(kind, store, dtype):
    j, t = _pair_caches(kind, store, dtype)
    crcs = [integrity.segment_checksum(t, i) for i in range(len(LENS))]
    assert crcs == [j_integrity.segment_checksum(j, i)
                    for i in range(len(LENS))]
    assert len(set(crcs)) == len(crcs)
    for i, c in enumerate(crcs):
        assert integrity.verify_segment(t, i, c) == c
    # one flipped bit inside a live region is caught; dead capacity is not
    # part of a segment's identity
    src = t.store if store == "paged" else t
    name = "k_pages" if store == "paged" else "k_ctx"
    pool = getattr(src, name)
    if store == "paged":
        pid = int(src.page_tables[1, 0])
        bits = pool[0, pid, 0, 0].view(torch.uint8)
    else:
        bits = (pool[0, 1, 0, 0] if t.ctx_layout == "gmk"
                else pool[0, 1, 0, :, 0]).view(torch.uint8)
    bits[0] ^= 1
    with pytest.raises(KVCorruption, match="checksum mismatch"):
        integrity.verify_segment(t, 1, crcs[1])
    assert integrity.segment_checksum(t, 0) == crcs[0]
    bits[0] ^= 1
    if store == "dense":
        dead = (pool[0, 1, 0, LENS[1]:] if t.ctx_layout == "gmk"
                else pool[0, 1, LENS[1]:])
        dead.fill_(7)
        assert integrity.segment_checksum(t, 1) == crcs[1]
