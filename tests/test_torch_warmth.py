"""Per-replica warmth in the port's library and loader against the JAX
package's: the same seeded sequence of ``get(replica=)``, ``touch``,
``spool_now`` and ``put`` on both libraries gives, after every call, the
same ``peek_tier`` from every replica's view, the same ``warmth`` and
``ident_tiers``, and at the end the same counters and per-replica bytes,
fp32 and int8, with an HBM budget of two blocks that
``demote_replicas`` enforces per replica; the reference's own
per-replica test sequence; and a fetch deduplicated onto another
replica's in-flight load marks the consuming replica warm.  The clock is
a counter, so that both libraries see the same LRU order.
"""
import itertools
import time

import numpy as np
import pytest
import torch

from repro.cache import FaultPlan as JaxFaultPlan
from repro.cache import KVLibrary as JaxLibrary
from repro.cache import ParallelLoader as JaxLoader
from repro_torch.cache import FaultPlan, KVLibrary, ParallelLoader

MEDIA = ["a", "b", "c", "d"]
REPLICAS = (None, 0, 1, 2)


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` as a counter: every call a later, distinct stamp."""
    tick = itertools.count(1_000_000)
    monkeypatch.setattr(time, "time", lambda: float(next(tick)))


def _kv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
                 for _ in range(2))


def _put(lib, mid, seed=None):
    k, v = _kv(MEDIA.index(mid) if seed is None else seed)
    if isinstance(lib, KVLibrary):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    return lib.put("u", mid, k, v)


def _view(lib):
    return ([lib.peek_tier("u", m, replica=r)
             for m in MEDIA + ["ghost"] for r in REPLICAS],
            [lib.warmth("u", MEDIA + ["ghost"], r) for r in (0, 1, 2)],
            lib.ident_tiers())


def _counters(lib):
    st = lib.stats()
    return ({t: {c: st["tiers"][t][c] for c in ("hits", "promotes",
                                                "demotes")}
             for t in ("hbm", "host", "disk")},
            st["misses"], st["bytes_by_tier"],
            st.get("hbm_bytes_by_replica"))


def _ops(seed, n=40):
    rng = np.random.default_rng(seed)
    kinds = ["get"] * 5 + ["touch"] * 2 + ["spool", "put", "get_plain"]
    for i in range(n):
        yield (kinds[int(rng.integers(len(kinds)))],
               MEDIA[int(rng.integers(len(MEDIA)))],
               int(rng.integers(3)), i)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_replica_sequence_matches_reference(quantize, seed, clock, tmp_path):
    probe = _put(JaxLibrary(spool_dir=str(tmp_path / "probe"),
                            quantize=quantize), "a").nbytes
    kw = dict(hbm_capacity=2 * probe, host_capacity=6 * probe,
              quantize=quantize)
    jlib = JaxLibrary(spool_dir=str(tmp_path / "jax"), **kw)
    tlib = KVLibrary(spool_dir=str(tmp_path / "torch"), device="cpu", **kw)
    for lib in (jlib, tlib):
        for m in MEDIA:
            _put(lib, m)
    assert _view(tlib) == _view(jlib)
    for kind, mid, replica, i in _ops(seed):
        for lib in (jlib, tlib):
            if kind == "get":
                assert lib.get("u", mid, replica=replica) is not None
            elif kind == "get_plain":
                assert lib.get("u", mid) is not None
            elif kind == "touch":
                lib.touch("u", mid, replica)
            elif kind == "spool":
                lib.spool_now("u", mid)
            else:
                _put(lib, mid, seed=100 + i)
        assert _view(tlib) == _view(jlib), (kind, mid, replica, i)
    assert _counters(tlib) == _counters(jlib)


def test_reference_per_replica_sequence(clock, tmp_path):
    """``tests/test_library.py``'s per-replica test on both libraries:
    replica 0 over its budget drops its own oldest hold, never replica
    1's."""
    nbytes = _put(JaxLibrary(spool_dir=str(tmp_path / "probe")), "a").nbytes
    views = []
    for cls, d in ((JaxLibrary, {}), (KVLibrary, {"device": "cpu"})):
        lib = cls(hbm_capacity=2 * nbytes, host_capacity=64 << 20,
                  spool_dir=str(tmp_path / cls.__module__), **d)
        for m in ("a", "b", "c"):
            _put(lib, m)
        seen = []
        for mid, r in (("a", 0), ("b", 1), ("b", 0), ("c", 0)):
            assert lib.get("u", mid, replica=r) is not None
            seen.append(_view(lib))
        views.append((seen, _counters(lib)))
    assert views[1] == views[0]
    tiers = views[1][0][-1][0]
    # ("a", replica 0) demoted to host; ("b", replica 1) still warm
    assert tiers[0 * 4 + 1] == "host" and tiers[1 * 4 + 2] == "hbm"
    assert views[1][0][-1][1][0] == {"hbm": 2, "host": 1, "disk": 0,
                                     "miss": 2}


def test_deduplicated_fetch_marks_the_consuming_replica(tmp_path):
    """Replica 1's prefetch rides replica 0's in-flight fetch (held back
    by a stall): one fetch, one dedup hit, and the gather marks the entry
    warm on replica 1 too, in both packages."""
    out = []
    for lib_cls, loader_cls, plan_cls, d in (
            (JaxLibrary, JaxLoader, JaxFaultPlan, {}),
            (KVLibrary, ParallelLoader, FaultPlan, {"device": "cpu"})):
        lib = lib_cls(spool_dir=str(tmp_path / lib_cls.__module__),
                      faults=plan_cls.parse("loader.fetch:stall:delay=0.3"),
                      **d)
        _put(lib, "shared", seed=7)
        loader = loader_cls(lib, max_workers=2)
        try:
            h0 = loader.prefetch_handle("u", ["shared"], replica=0)
            h1 = loader.prefetch_handle("u", ["shared"], replica=1)
            assert h1.records["shared"] is h0.records["shared"]
            warm_before = lib.warmth("u", ["shared"], 1)
            assert h1.get("shared") is not None
            assert h0.get("shared") is not None
            out.append((loader.dedup_hits, warm_before,
                        [lib.warmth("u", ["shared"], r) for r in (0, 1, 2)],
                        lib.stats().get("hbm_bytes_by_replica")))
            h0.release()
            h1.release()
        finally:
            loader.close()
    assert out[1] == out[0]
    assert out[1][0] == 1 and out[1][1]["hbm"] == 0
    assert [w["hbm"] for w in out[1][2]] == [1, 1, 0]
