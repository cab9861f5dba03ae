"""The port's parallel loader and pipelined scheduler
(``repro_torch.cache.transfer``, ``repro_torch.serving.scheduler``).

The loader shares a fetch already in flight (dedup), forgets it when a
``put`` replaces the entry (the handle then hands out the new entry), and
counts a failed fetch as a miss; a ``RuntimeError`` (a failed copy to the
card) reaches the consumer instead.  The scheduler, fed the same queue as
the JAX package's ``PipelinedScheduler`` (priorities, media on disk, in
memory and missing, a request without media), pipelined or sequential,
pops in the same order and keeps the same requests' loads in flight,
issued in the same order, after every call.  Fetches are held open with events, so no test depends on
timing; every wait has a timeout.
"""
import threading

import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache.transfer import ParallelLoader as JaxLoader
from repro.core import Prompt as JaxPrompt
from repro.core import media_segment as jax_media
from repro.core import text_segment as jax_text
from repro.serving.request import Request as JaxRequest
from repro.serving.scheduler import PipelinedScheduler as JaxScheduler
from repro_torch.cache import KVLibrary, ParallelLoader
from repro_torch.core import Prompt, media_segment, text_segment
from repro_torch.serving import PipelinedScheduler, Request, State

TIMEOUT = 30.0


def _kv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((2, 4, 2, 4))
                                  .astype(np.float32)) for _ in range(2))


class _Gate:
    """Wraps ``library.get`` so that fetches of one media id wait for
    ``open`` (and count how often they ran)."""

    def __init__(self, lib, media_id):
        self.real, self.media_id = lib.get, media_id
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0
        lib.get = self

    def __call__(self, user, mid, **kw):
        if mid == self.media_id:
            self.calls += 1
            self.entered.set()
            assert self.release.wait(TIMEOUT)
        return self.real(user, mid, **kw)


def test_inflight_fetches_are_shared(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    lib.put("u", "a", *_kv())
    lib.spool_now("u", "a")
    gate = _Gate(lib, "a")
    loader = ParallelLoader(lib)
    try:
        h1 = loader.prefetch_handle("u", ["a"])
        assert gate.entered.wait(TIMEOUT)
        h2 = loader.prefetch_handle("u", ["a"])
        assert loader.dedup_hits == 1
        assert h1.records["a"] is h2.records["a"]
        gate.release.set()
        e1, e2 = h1.get("a"), h2.get("a")
        assert e1 is e2 and e1.pins == 2 and gate.calls == 1
        assert lib.stats()["tiers"]["disk"]["hits"] == 1
        assert h1.blocked_s >= 0.0 and h1.load_busy_s > 0.0
        h1.release()
        h1.release()                          # idempotent
        assert e1.pins == 1
        h2.release()
        assert e1.pins == 0
    finally:
        gate.release.set()
        loader.close()


def test_put_during_a_fetch_invalidates_it(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    lib.put("u", "a", *_kv(0))
    lib.spool_now("u", "a")
    gate = _Gate(lib, "a")
    loader = ParallelLoader(lib)
    try:
        old = loader.prefetch_handle("u", ["a"])
        assert gate.entered.wait(TIMEOUT)
        new_k, new_v = _kv(1)
        lib.put("u", "a", new_k, new_v)       # replaces the entry mid-fetch
        assert loader.invalidations == 1
        gate.release.set()
        # the stale fetch's result fails the identity check: the handle
        # hands out the library's current entry
        e = old.get("a")
        assert e is lib._entries[("u", "a")] and torch.equal(e.k, new_k)
        fresh = loader.prefetch_handle("u", ["a"])
        assert loader.dedup_hits == 0
        assert fresh.get("a") is e
        old.release()
        fresh.release()
    finally:
        gate.release.set()
        loader.close()


def test_a_failed_fetch_is_a_counted_miss(tmp_path, monkeypatch):
    lib = KVLibrary(spool_dir=str(tmp_path))
    lib.put("u", "a", *_kv())
    loader = ParallelLoader(lib)

    def broken(user, mid, **kw):
        raise ValueError("unreadable")

    monkeypatch.setattr(lib, "get", broken)
    try:
        h = loader.prefetch_handle("u", ["a"])
        assert h.records["a"].future.result(timeout=TIMEOUT) is None
        assert loader.load_failures == 1
        assert len(h.intervals()) == 1
    finally:
        loader.close()


def test_a_failed_copy_to_the_card_raises(tmp_path, monkeypatch):
    lib = KVLibrary(spool_dir=str(tmp_path))
    lib.put("u", "a", *_kv())
    loader = ParallelLoader(lib)

    def broken(user, mid, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(lib, "get", broken)
    try:
        h = loader.prefetch_handle("u", ["a"])
        with pytest.raises(RuntimeError, match="CUDA error"):
            h.get("a", timeout=TIMEOUT)
        assert loader.load_failures == 0
    finally:
        loader.close()


def test_handle_wait(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path))
    for i, mid in enumerate("ab"):
        lib.put("u", mid, *_kv(i))
        lib.spool_now("u", mid)
    loader = ParallelLoader(lib)
    try:
        h = loader.prefetch_handle("u", ["a", "b", "gone"])
        entries = h.wait(timeout=TIMEOUT)
        assert set(entries) == {"a", "b", "gone"}
        for i, mid in enumerate("ab"):
            assert torch.equal(entries[mid].k, _kv(i)[0])
        assert entries["a"].pins == 1 and entries["gone"] is None
        # a media id never prefetched: one synchronous, pinned lookup
        lib.put("u", "c", *_kv(2))
        assert h.get("c").pins == 1
        h.release()
        assert all(e.pins == 0 for e in (entries["a"], entries["b"]))
    finally:
        loader.close()


# -- the scheduler against the reference ------------------------------------

# (user, media ids, priority) of the queued requests; media "d*" are on
# disk, "m*" in memory, "x*" in no library
TRAFFIC = [("u", ["m0"], 0), ("u", ["d0", "m1"], 0), ("u", [], 5),
           ("v", ["x0"], 1), ("u", ["d1"], 2), ("u", ["m0", "d0"], 0),
           ("v", ["d2"], 0)]


def _requests(pkg, traffic):
    prompt, media, text, req = (
        (JaxPrompt, jax_media, jax_text, JaxRequest) if pkg == "jax"
        else (Prompt, media_segment, text_segment, Request))
    out = []
    for user, mids, pri in traffic:
        segs = [text([1, 2, 3])] + [media(m, np.zeros((4, 8), np.float32))
                                    for m in mids]
        out.append(req(prompt=prompt(segs, user_id=user), priority=pri))
    return out


def _library(pkg, path):
    lib = (JaxLibrary if pkg == "jax" else KVLibrary)(spool_dir=str(path))
    k, v = _kv()
    for user, mids, _ in TRAFFIC:
        for m in mids:
            if m[0] in "dm" and lib.peek_tier(user, m) is None:
                if pkg == "jax":
                    lib.put(user, m, k.numpy(), v.numpy())
                else:
                    lib.put(user, m, k, v)
                if m[0] == "d":
                    lib.spool_now(user, m)
    return lib


@pytest.mark.parametrize("order", ["given", "reversed"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_scheduler_matches_reference(pipelined, order, tmp_path):
    traffic = TRAFFIC if order == "given" else TRAFFIC[::-1]
    scheds = []
    for pkg, loader_cls, sched_cls in (("jax", JaxLoader, JaxScheduler),
                                       ("torch", ParallelLoader,
                                        PipelinedScheduler)):
        lib = _library(pkg, tmp_path / pkg)
        # the reference at its default depth, the port's only one
        scheds.append((sched_cls(loader_cls(lib), pipelined=pipelined),
                       _requests(pkg, traffic)))
    ids = [{r.req_id: i for i, r in enumerate(reqs)} for _, reqs in scheds]

    def window(k):
        sched, _ = scheds[k]
        return [ids[k][rid] for rid in sched._handles]

    def issued(k):
        sched, _ = scheds[k]
        return [[rec.media_id for rec in h.records.values()]
                for h in sched._recent_handles]

    try:
        for i in range(len(traffic)):
            for sched, reqs in scheds:
                sched.enqueue(reqs[i])
                assert reqs[i].state.value == "waiting"
            assert window(0) == window(1)
            assert issued(0) == issued(1)
        order = [[], []]
        while scheds[0][0].queue:
            for k, (sched, _) in enumerate(scheds):
                req, handle = sched.pop()
                order[k].append(ids[k][req.req_id])
                assert req.t_admitted > 0
                if handle is not None:
                    handle.wait(timeout=TIMEOUT)
                    handle.release()
            assert order[0] == order[1]
            assert window(0) == window(1)
            assert issued(0) == issued(1)
        assert not scheds[1][0].queue and len(order[1]) == len(traffic)
        assert scheds[1][0].admitted == len(traffic)
    finally:
        for sched, _ in scheds:
            sched.loader.close()


def test_waiting_queue_order_and_removal():
    from repro_torch.serving import WaitingQueue
    reqs = [Request(prompt=Prompt([text_segment([1])]), priority=p)
            for p in (0, 3, 1, 3)]
    q = WaitingQueue()
    for r in reqs:
        q.push(r)
    # higher priority first, FIFO among ties
    assert q.peek(3) == [reqs[1], reqs[3], reqs[2]]
    assert list(q) == [reqs[1], reqs[3], reqs[2], reqs[0]] and len(q) == 4
    assert q.remove(reqs[2]) and not q.remove(reqs[2])
    assert [q.pop(), q.pop(), q.pop()] == [reqs[1], reqs[3], reqs[0]]
    assert not q and reqs[0].state is State.WAITING
