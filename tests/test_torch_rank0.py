"""Rank 0 decides under a mesh: the port's libraries, loader and queue
with a planted rank-local outcome, and no process group.

:class:`StubMesh` is one rank of a two-rank mesh whose
``broadcast_object`` hands rank 1 what rank 0 sent: each case runs rank
0's library first, then rank 1's, which receives rank 0's broadcasts in
order.  Rank 1 is given an outcome of its own that differs from rank 0's
(a clock past a block's TTL, a disk that fails its writes or its reads, a
peer that answers it alone, a queue aged by another clock) and must follow
rank 0, or raise where it cannot.  Last, an engine over a 1 x 1 mesh
serves with every block spooled and its loader's threads fetching: every
collective and broadcast runs on the engine's thread.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro_torch.cache.library as library_mod
from repro_torch.cache import FaultPlan, KVLibrary, KVPeerServer
from repro_torch.cache.library import RankDivergence
from repro_torch.configs import get_smoke_config
from repro_torch.core import Prompt, text_segment
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serving import EngineConfig, MPICEngine, Request
from repro_torch.serving.scheduler import WaitingQueue

from _torch_sharded import SETUPS, _spooled, _torch_pkg, run_traffic


class StubMesh(ServingMesh):
    """Rank ``rank`` of a two-rank mesh on the CPU with no process group:
    rank 0's broadcasts go into ``sent``, rank 1's return them in order;
    ``any_rank`` reads this rank's flag alone."""

    def __init__(self, rank: int, sent: list):
        super().__init__(data=1, model=2, rank=rank, backend="gloo",
                         device=torch.device("cpu"))
        self.sent = sent

    def broadcast_object(self, obj):
        if self.rank == 0:
            self.sent.append(obj)
            return obj
        return self.sent.pop(0)

    def any_rank(self, flag: bool) -> bool:
        return bool(flag)


def _pair(**kw):
    """Rank 0's and rank 1's libraries over one stub mesh; ``kw`` per rank
    as ``{name: (rank 0's value, rank 1's value)}``."""
    sent = []
    libs = []
    for rank in (0, 1):
        lib = KVLibrary(device="cpu", **{k: v[rank] for k, v in kw.items()})
        lib.attach_mesh(StubMesh(rank, sent))
        libs.append(lib)
    return libs


def _block(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 8, 2, 4, generator=g),
            torch.randn(2, 8, 2, 4, generator=g))


def _put_both(libs, **kw):
    k, v = _block()
    for lib in libs:
        lib.put("u", "img", k, v, **kw)
        lib.sync()
    return k


def test_rank_0s_clock_decides_a_blocks_expiry(monkeypatch):
    """A TTL past on rank 1's clock alone: rank 1 keeps serving the block
    (a lookup hits, ``expire_now`` drops nothing, a sync keeps it).  Past
    on rank 0's clock alone: rank 0 drops it, and rank 1 drops it too at
    the lookup's agreement, though its own clock says it lives."""
    clock = library_mod.time.time
    lib0, lib1 = _pair()
    _put_both((lib0, lib1), ttl=60.0)
    late = clock() + 120.0
    monkeypatch.setattr(library_mod.time, "time", lambda: late)
    assert lib1.get("u", "img") is not None
    assert lib1.expire_now() == 0
    monkeypatch.setattr(library_mod.time, "time", clock)
    lib0.sync()
    monkeypatch.setattr(library_mod.time, "time", lambda: late)
    lib1.sync()
    assert ("u", "img") in lib1._entries
    # now rank 0's clock is the late one, rank 1's is not
    got0 = lib0.get_agreed("u", "img")
    monkeypatch.setattr(library_mod.time, "time", clock)
    assert lib1.get("u", "img") is not None     # its own clock: alive
    got1 = lib1.get_agreed("u", "img")
    assert got0 is None and got1 is None
    assert ("u", "img") not in lib0._entries
    assert ("u", "img") not in lib1._entries


def test_a_spool_write_is_rank_0s_outcome(tmp_path):
    """Every block over a host budget of 0 into one directory.  Rank 0's
    write succeeds and rank 1's disk would fail its writes: rank 1 writes
    nothing, records the same demotion under rank 0's content key and
    reads rank 0's file.  Rank 0's write fails: rank 1 keeps the block
    resident, whatever its own disk would do."""
    for fails in (1, 0):
        d = tmp_path / f"spool{fails}"
        plans = [None, None]
        plans[fails] = FaultPlan.parse("disk.write:io_error")
        libs = _pair(spool_dir=(str(d), str(d)), hbm_capacity=(0, 0),
                     host_capacity=(0, 0), faults=tuple(plans))
        k = _put_both(libs)
        e0, e1 = (lib._entries[("u", "img")] for lib in libs)
        assert libs[1].stats()["tiers"]["disk"]["bytes_written"] == 0
        if fails == 1:
            assert e0.tier == e1.tier == "disk" and e1.payload.k is None
            assert e1.meta.key == e0.meta.key
            assert sorted(p.name for p in d.iterdir()) == \
                [f"{e0.meta.key}.npz"]
            assert libs[0].get_agreed("u", "img") is not None
            got = libs[1].get_agreed("u", "img")
            assert torch.equal(got.k, k)
            assert libs[1].stats()["tiers"]["disk"]["fetches"] == 1
        else:
            assert e0.payload.k is not None and e1.payload.k is not None
            assert e1.tier != "disk" and not any(d.iterdir())


def test_a_peer_answer_is_rank_0s(tmp_path):
    """A peer that answers rank 0 alone: rank 0 pulls the block and writes
    it into the shared spool, rank 1 (whose peer is dead, and which asks
    none) reads it from there.  A peer that answers rank 1 alone: rank 0
    misses, so rank 1 misses too, without asking."""
    src = KVLibrary(device="cpu")
    k, v = _block()
    src.put("u", "img", k, v)
    srv = KVPeerServer(src)
    dead = "127.0.0.1:1"
    try:
        for live in (0, 1):
            peers = [[dead], [dead]]
            peers[live] = [srv.address]
            d = str(tmp_path / f"spool{live}")
            lib0, lib1 = _pair(peers=tuple(peers), spool_dir=(d, d))
            got0 = lib0.get_agreed("u", "img")
            got1 = lib1.get_agreed("u", "img")
            assert lib1.stats()["tiers"]["network"]["fetches"] == 0
            if live == 0:
                assert torch.equal(got0.k, k) and torch.equal(got1.k, k)
                assert lib1.stats()["tiers"]["disk"]["fetches"] == 1
                assert got1.meta.key == got0.meta.key
            else:
                assert got0 is None and got1 is None
    finally:
        srv.close()


def test_a_sync_carries_only_what_rank_0_changed(tmp_path):
    """The first sync carries every entry; later ones only the entries
    that rank 0 changed since: none after a step that changed nothing,
    however many entries the library holds, and the one entry that
    ``spool_now`` demoted, which rank 1 then drops under rank 0's key."""
    d = str(tmp_path)
    lib0, lib1 = _pair(spool_dir=(d, d))
    sent = lib0.mesh.sent
    k, v = _block()
    for i in range(50):
        for lib in (lib0, lib1):
            lib.put("u", f"img{i}", k, v)
        lib0.sync()
        assert list(sent[-1]["entries"]) == [("u", f"img{i}")]
        lib1.sync()
    lib0.sync()
    quiet = sent[-1]
    lib1.sync()
    assert quiet["entries"] == {} and not quiet["full"]
    assert lib0.spool_now("u", "img7")
    assert list(sent[-1]["entries"]) == [("u", "img7")]
    assert lib1.spool_now("u", "img7")
    e0, e1 = lib0._entries[("u", "img7")], lib1._entries[("u", "img7")]
    assert e1.tier == "disk" and e1.payload.k is None
    assert e1.meta.key == e0.meta.key
    assert lib1.stats()["tiers"]["disk"]["bytes_written"] == 0
    assert len(lib1._entries) == len(lib0._entries) == 50


def test_a_followers_own_read_goes_back_to_disk_at_the_next_sync(tmp_path):
    """Rank 1 reads a block that rank 0 holds on disk (a loader's fetch on
    its side alone): the next sync, which carries no change of rank 0's,
    puts it back on disk, unless a link still pins it."""
    d = str(tmp_path)
    lib0, lib1 = _pair(spool_dir=(d, d), hbm_capacity=(0, 0),
                       host_capacity=(0, 0))
    _put_both((lib0, lib1))
    e1 = lib1._entries[("u", "img")]
    assert e1.payload.k is None
    for pin in (True, False):
        got = lib1.get("u", "img", pin=pin)
        assert got is e1 and e1.payload.k is not None
        lib0.sync()
        lib1.sync()
        assert (e1.payload.k is not None) == pin
        if pin:
            lib1.unpin(e1)
            lib0.sync()
            lib1.sync()
            assert e1.payload.k is None and e1.tier == "disk"
    assert lib0._entries[("u", "img")].payload.k is None


def test_a_follower_built_over_a_spool_leaves_its_files(tmp_path):
    """A rank other than 0, built with ``mesh=`` and ``rehydrate=True`` over
    a spool that holds an expired block and an orphaned ``.tmp``, unlinks
    and sweeps neither and indexes nothing of its own: rank 0 does both,
    by its own clock, and the first sync gives rank 1 rank 0's index."""
    d = str(tmp_path)
    k, v = _block()
    writer = KVLibrary(spool_dir=d, hbm_capacity=0, host_capacity=0,
                       device="cpu")
    writer.put("u", "old", k, v, ttl=0.0)
    writer.put("u", "live", k, v)
    tmp = tmp_path / "orphan.npz.tmp"
    tmp.write_bytes(b"half a block")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 3
    sent = []
    lib1 = KVLibrary(spool_dir=d, rehydrate=True, device="cpu",
                     mesh=StubMesh(1, sent))
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    assert lib1.rehydrate_stats == {} and not lib1._entries
    assert lib1.disk.reader
    lib0 = KVLibrary(spool_dir=d, rehydrate=True, device="cpu",
                     mesh=StubMesh(0, sent))
    assert lib0.rehydrate_stats["expired"] == 1
    assert lib0.disk.counters["tmp_swept"] == 1
    assert not tmp.exists() and len(list(tmp_path.iterdir())) == 1
    lib0.attach_mesh(lib0.mesh)
    lib1.attach_mesh(lib1.mesh)
    assert list(lib1._entries) == list(lib0._entries) == [("u", "live")]
    assert torch.equal(lib1.get("u", "live").k, k)


def test_a_failed_read_of_rank_0s_file_raises(tmp_path):
    """Rank 1's disk fails its reads where rank 0's succeeds: rank 1 does
    not recompute alone, it raises (every rank would, after the flag's
    all-reduce)."""
    d = str(tmp_path)
    lib0, lib1 = _pair(spool_dir=(d, d), hbm_capacity=(0, 0),
                       host_capacity=(0, 0),
                       faults=(None, FaultPlan.parse("disk.read:io_error")))
    _put_both((lib0, lib1))
    assert lib0.get_agreed("u", "img") is not None
    with pytest.raises(RankDivergence, match="rank 1: its read"):
        lib1.get_agreed("u", "img")


def _request(priority):
    return Request(prompt=Prompt([text_segment([1, 2, 3])], user_id="u"),
                   priority=priority)


def test_the_aged_queue_order_is_rank_0s():
    """Rank 1's clock has aged its first request by 100 levels, so its own
    order would admit it first; it admits rank 0's choice, at every pop
    and peek."""
    sent = []
    queues = [WaitingQueue(aging_s=1.0, mesh=StubMesh(r, sent))
              for r in (0, 1)]
    reqs = [[_request(p) for p in (0, 2, 1)] for _ in queues]
    for q, rs in zip(queues, reqs):
        for r in rs:
            q.push(r)
    neg, seq, t_enq, r = queues[1]._heap[0]
    queues[1]._heap[0] = (neg, seq, t_enq - 100.0, r)
    mine = WaitingQueue(aging_s=1.0)
    mine._heap = list(queues[1]._heap)
    assert mine.peek(1)[0] is reqs[1][0]          # rank 1's own order
    order = [[], []]
    for _ in range(3):
        for i, q in enumerate(queues):
            order[i].append(reqs[i].index(q.peek(2)[0]))
            assert reqs[i].index(q.pop()) == order[i][-1]
    assert order[0] == order[1] == [1, 2, 0]


def test_no_collective_runs_on_a_loader_thread(monkeypatch, tmp_path):
    """A 1 x 1 mesh engine over fully spooled libraries, pipelined: the
    loader's threads read the disk, and every all-reduce, all-gather,
    broadcast and flag sum runs on the engine's thread."""
    cfg = dataclasses.replace(get_smoke_config("internvl2-76b"),
                              param_dtype="float32",
                              compute_dtype="float32")
    mesh = make_serving_mesh(1, 1, device="cpu")
    threads = {"collective": [], "get": []}
    for name in ("all_reduce", "all_gather", "broadcast_object",
                 "any_rank"):
        def wrapped(*a, _f=getattr(mesh, name), **kw):
            threads["collective"].append(threading.current_thread())
            return _f(*a, **kw)
        monkeypatch.setattr(mesh, name, wrapped)
    get = KVLibrary.get

    def recorded_get(self, *a, **kw):
        threads["get"].append(threading.current_thread().name)
        return get(self, *a, **kw)

    monkeypatch.setattr(KVLibrary, "get", recorded_get)
    static, dynamic = _spooled(str(tmp_path))
    over, policies = SETUPS["paged"]
    eng = MPICEngine(build_model(cfg), init_params(cfg, device="cpu"),
                     EngineConfig(**over), mesh=mesh, device="cpu",
                     static_library=static, dynamic_library=dynamic)
    try:
        out = run_traffic(eng, _torch_pkg(), cfg.d_model,
                          cfg.media_token_len, policies)
    finally:
        eng.close()
    assert all(r["done"] == "done" for r in out)
    main = threading.main_thread()
    assert threads["collective"] and all(t is main
                                         for t in threads["collective"])
    assert any(n.startswith("kv-loader") for n in threads["get"])
    assert static.stats()["tiers"]["disk"]["fetches"] > 0
    assert np.isfinite(out[0]["first"]).all()
