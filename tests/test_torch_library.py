"""The port's tiered KV library (``repro_torch.cache.library``) against the
JAX package's ``KVLibrary``.

The same sequence of ``put`` / ``get`` / ``spool_now`` / ``expire_now`` /
``delete`` calls, with the same stored bytes and capacities that force
hbm -> host -> disk demotions, gives equal tiers after every call and equal
counters (per-tier hits, promotes and demotes; misses; disk fetches) at
the end, fp and int8.  Also: a pinned entry is never spooled, and a
``quantize=True`` library stores int8 bit-identical to the JAX package's,
dequantizing lazily and counting it; and 16 threads hammering one
library lose no count, no pin and no byte.  Inputs are seeded numpy
arrays; every comparison is exact.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache import quant as jq
from repro_torch.cache import KVLibrary
from repro_torch.cache import quant as tq

MEDIA = ["a", "b", "c", "d", "e"]


def _kv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
                 for _ in range(2))


def _put(lib, mid, ttl=None):
    k, v = _kv(MEDIA.index(mid) if mid in MEDIA else 99)
    if isinstance(lib, KVLibrary):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    return lib.put("u", mid, k, v, ttl=ttl)


def _tiers(lib):
    return [lib.peek_tier("u", m) for m in MEDIA + ["x"]]


def _counters(lib):
    st = lib.stats()
    tiers = {t: {c: st["tiers"][t][c] for c in ("hits", "promotes",
                                                "demotes")}
             for t in ("hbm", "host", "disk")}
    return tiers, st["misses"], st["tiers"]["disk"]["fetches"], \
        st["entries"], st["bytes_by_tier"]


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_tier_sequence_matches_reference(quantize, tmp_path):
    nbytes = _put(JaxLibrary(spool_dir=str(tmp_path / "probe"),
                             quantize=quantize), "a").nbytes
    kw = dict(hbm_capacity=2 * nbytes, host_capacity=3 * nbytes,
              quantize=quantize)
    libs = [JaxLibrary(spool_dir=str(tmp_path / "jax"), **kw),
            KVLibrary(spool_dir=str(tmp_path / "torch"), **kw)]
    steps = [
        ("put", "a"), ("put", "b"), ("put", "c"), ("put", "d"),
        ("put", "e"),                       # a spooled, b..c host, d..e hbm
        ("get", "a"),                       # disk hit, promoted
        ("get", "b"), ("get", "missing"),
        ("spool_now", "d"), ("get", "d"),
        ("put", "x"),                       # another block: more pressure
        ("spool_now", "e"), ("spool_now", "e"),
        ("delete", "c"), ("get", "c"),
        ("put_expiring", "b"), ("expire_now", None), ("get", "b"),
        ("get", "e"), ("get", "a"),
    ]
    for op, mid in steps:
        outs = []
        for lib in libs:
            if op == "put":
                outs.append(_put(lib, mid).nbytes)
            elif op == "put_expiring":
                outs.append(_put(lib, mid, ttl=-1.0).nbytes)
            elif op == "get":
                e = lib.get("u", mid)
                outs.append(None if e is None else e.tier)
            elif op == "expire_now":
                outs.append(lib.expire_now())
            elif op == "delete":
                outs.append(lib.delete("u", mid))
            else:
                outs.append(getattr(lib, op)("u", mid))
        assert outs[0] == outs[1], (op, mid)
        assert _tiers(libs[0]) == _tiers(libs[1]), (op, mid)
    assert _counters(libs[0]) == _counters(libs[1])
    st = libs[1].stats()
    assert st["tiers"]["disk"]["promotes"] > 0
    assert st["tiers"]["host"]["demotes"] > 0
    assert st["tiers"]["hbm"]["demotes"] > 0
    assert st["tiers"]["disk"]["corrupt"] == 0


def test_disk_read_returns_the_stored_bytes(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _kv(0))
    lib.put("u", "a", k, v)
    assert lib.spool_now("u", "a") and lib.peek_tier("u", "a") == "disk"
    e = lib.get("u", "a")
    assert e.tier == "host"
    assert e.k.dtype == torch.bfloat16 and torch.equal(e.k, k)
    assert torch.equal(e.v, v)


def test_a_corrupt_spool_file_is_a_miss_and_drops_the_entry(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    _put(lib, "a")
    lib.spool_now("u", "a")
    path = lib.disk.path_for(lib._entries[("u", "a")].meta.key)
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert lib.get("u", "a") is None
    assert lib.peek_tier("u", "a") is None
    assert lib.stats()["tiers"]["disk"]["corrupt"] == 1


def test_pinned_entry_is_never_spooled(tmp_path):
    nbytes = _put(KVLibrary(spool_dir=str(tmp_path / "p")), "a").nbytes
    # every resident entry is over budget: each one spools unless pinned
    lib = KVLibrary(spool_dir=str(tmp_path / "lib"), hbm_capacity=0,
                    host_capacity=nbytes - 1)
    _put(lib, "a")
    assert lib.peek_tier("u", "a") == "disk"
    e = lib.get("u", "a", pin=True)
    assert e.pins == 1 and lib.peek_tier("u", "a") == "host"
    assert not lib.spool_now("u", "a")
    for mid in ("b", "c", "d"):
        _put(lib, mid)
    assert e.payload.k is not None and lib.peek_tier("u", "a") == "host"
    assert [lib.peek_tier("u", m) for m in "bcd"] == ["disk"] * 3
    lib.unpin(e)                         # the deferred demotion runs now
    assert e.pins == 0 and lib.peek_tier("u", "a") == "disk"
    assert e.payload.k is None
    assert lib.try_pin(e) is False


def test_quantized_library_stores_int8(tmp_path):
    k, v = _kv(3)
    lib = KVLibrary(spool_dir=str(tmp_path), quantize=True)
    jlib = JaxLibrary(spool_dir=str(tmp_path / "jax"), quantize=True)
    e = lib.put("u", "a", torch.from_numpy(k), torch.from_numpy(v))
    je = jlib.put("u", "a", k, v)
    assert e.payload.k is None and e.qk.q.dtype == torch.int8
    assert e.meta.key is None        # hashed at the first spool
    np.testing.assert_array_equal(e.qk.q.numpy(), je.qk.q)
    np.testing.assert_array_equal(e.qv.scale.numpy(), je.qv.scale)
    assert lib.stats()["dequants"] == 0
    # an fp consumer dequantizes once, lazily, as the reference does
    np.testing.assert_array_equal(e.k.numpy(), jq.dequantize_kv(je.qk))
    np.testing.assert_array_equal(e.v.numpy(), np.asarray(je.v))
    assert lib.stats()["dequants"] == jlib.stats()["dequants"] == 1
    np.testing.assert_array_equal(
        tq.dequantize_kv(e.qk).numpy(), e.k.numpy())
    # the spool keeps int8, and the disk read too
    lib.note_direct_link(2)
    lib.spool_now("u", "a")
    assert e.meta.key == je.meta.key
    back = lib.get("u", "a")
    assert back.payload.k is None and back.qk.q.dtype == torch.int8
    assert lib.stats()["direct_links"] == 2


def test_put_hashes_nothing_until_the_first_spool(tmp_path, monkeypatch):
    """Only a spool file is named by the content key: a library that
    never spools never hashes (nor copies to the host) what it stores."""
    from repro_torch.cache import library as tlib
    hashed = []
    real = tlib.content_key
    monkeypatch.setattr(tlib, "content_key",
                        lambda p, scope, salt=None: hashed.append(scope)
                        or real(p, scope, salt))
    lib = KVLibrary(spool_dir=str(tmp_path))
    _put(lib, "a")
    _put(lib, "a")                       # a replacement evicts unhashed
    _put(lib, "b")
    assert lib.get("u", "a") is not None and hashed == []
    assert lib.stats()["tiers"]["hbm"]["hits"] == 1
    lib.spool_now("u", "b")
    lib.spool_now("u", "b")              # already on disk: no second hash
    assert hashed == [("u", "b")]
    assert lib.get("u", "b").meta.key == real(
        lib._entries[("u", "b")].payload, ("u", "b"))
    lib.delete("u", "b")
    assert not any(tmp_path.iterdir())   # the spool file went with it


def test_scopes_and_replacement(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    shared = KVLibrary(spool_dir=str(tmp_path / "s"), shared=True)
    _put(lib, "a")
    _put(shared, "a")
    assert lib.get("v", "a") is None                 # another user's scope
    assert shared.get("v", "a") is not None          # the shared corpus
    seen = []
    lib.add_invalidation_listener(lambda u, m: seen.append((u, m)))
    old = lib._entries[("u", "a")]
    lib.spool_now("u", "a")
    old_path = lib.disk.path_for(old.meta.key)
    k, v = _kv(7)
    lib.put("u", "a", torch.from_numpy(k), torch.from_numpy(v))
    assert seen == [("u", "a")]
    assert not lib.disk.contains(old.meta.key)       # no orphaned file
    assert old_path is not None
    assert torch.equal(lib.get("u", "a").k, torch.from_numpy(k))


def test_concurrent_hammer(tmp_path):
    """16 threads (more than the cores) get with and without pins, spool
    and read back six entries under a budget of two, with a short switch
    interval.  Every entry handed out holds its own bytes, every get is
    counted exactly once, and every pin is returned."""
    nbytes = _put(KVLibrary(spool_dir=str(tmp_path / "p")), "a").nbytes
    lib = KVLibrary(spool_dir=str(tmp_path / "lib"), hbm_capacity=nbytes,
                    host_capacity=2 * nbytes)
    mids = MEDIA + ["x"]
    want = {m: torch.from_numpy(_kv(MEDIA.index(m) if m in MEDIA else 99)[0])
            for m in mids}
    for m in mids:
        _put(lib, m)
    errors, gets = [], []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                m = mids[rng.integers(len(mids))]
                op = rng.integers(3)
                if op == 2:
                    lib.spool_now("u", m)
                    continue
                e = lib.get("u", m, pin=bool(op))
                gets.append(e is not None)
                if e is not None and op:
                    if not torch.equal(e.k, want[m]):
                        errors.append(f"{m}: wrong bytes")
                    lib.unpin(e)
        except Exception as exc:             # reported below, with the rest
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    st = lib.stats()
    hits = sum(st["tiers"][t]["hits"] for t in ("hbm", "host", "disk"))
    assert hits == sum(gets) and st["misses"] == len(gets) - sum(gets)
    assert all(e.pins == 0 for e in lib._entries.values())
    assert st["tiers"]["disk"]["corrupt"] == 0
