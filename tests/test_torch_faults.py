"""The port's fault plan (``repro_torch.cache.faults``) and the failure
paths that consult it, against the JAX package's.

The same plan string and seed fire on the same events in both packages,
event for event; the peer breaker walks the same states under the same
calls; a blackholed peer trips both packages' breakers after the same
number of timeouts; consecutive injected disk read errors quarantine both
libraries' disk tier, and an injected ENOSPC is counted without
quarantine; a loader ``error`` is a counted miss and a ``stall`` still
delivers; ``engine.step:crash`` raises ``ReplicaCrash`` before the step
touches the engine.  Every fault is injected through the seeded plan and
every window counts events: no test waits on a race.
"""
import time

import numpy as np
import pytest
import torch

from repro.cache import DictBlockStore as JaxDictBlockStore
from repro.cache import FaultPlan as JaxFaultPlan
from repro.cache import FaultRule as JaxFaultRule
from repro.cache import KVLibrary as JaxLibrary
from repro.cache import KVPeerServer as JaxPeerServer
from repro.cache import PeerBreaker as JaxPeerBreaker
from repro.cache import PeerTransport as JaxTransport
from repro.cache.backends import NetworkBackend as JaxNetworkBackend
from repro_torch.cache import (
    TIER_DISK,
    DictBlockStore,
    FaultPlan,
    FaultRule,
    KVLibrary,
    KVPeerServer,
    NetworkBackend,
    ParallelLoader,
    PeerBreaker,
    PeerTransport,
    ReplicaCrash,
)
from repro_torch.core import Prompt, media_segment, text_segment
from repro_torch.data import image_embeds
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

SITES = ["peer.request", "peer.body", "disk.read", "disk.write",
         "loader.fetch", "engine.step"]
TARGETS = ["127.0.0.1:9", "spool/abc.npz", "img-0-1", "replica0",
           "replicaNone"]
SPECS = [
    "disk.read:io_error:prob=0.4;peer.request:blackhole:start=2",
    "engine.step:crash:target=replica0,start=2,stop=4;"
    "loader.fetch:stall:delay=0.25,prob=0.5",
    "peer.body:corrupt:stop=3;peer.body:corrupt:start=1,prob=0.7;"
    "disk.write:enospc:target=spool,start=1",
]


def _events(seed, n=200):
    rng = np.random.default_rng(seed)
    return [(SITES[rng.integers(len(SITES))],
             TARGETS[rng.integers(len(TARGETS))]) for _ in range(n)]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_fires_on_the_reference_events(spec):
    """One spec and seed, one seeded event sequence: the same rule fires
    (or none) on every event, and the counters end equal."""
    events = _events(len(spec))
    fired = []
    for plan in (FaultPlan.parse(spec, seed=7),
                 JaxFaultPlan.parse(spec, seed=7)):
        hits = [plan.check(site, target) for site, target in events]
        fired.append([None if h is None else h.describe() for h in hits])
        fired.append(plan.stats())
        fired.append(repr(plan))
    assert fired[:3] == fired[3:]
    assert any(fired[0]) and not all(fired[0])


def test_plan_window_target_and_parse_errors():
    rules = dict(site="engine.step", kind="crash", target="replica1",
                 start=2, stop=3)
    for plan in (FaultPlan([FaultRule(**rules)]),
                 JaxFaultPlan([JaxFaultRule(**rules)])):
        assert plan.check("engine.step", "replica0") is None
        assert plan.check("disk.read", "replica1") is None
        hits = [plan.check("engine.step", "replica1") for _ in range(4)]
        assert [h is not None for h in hits] == [False, False, True, False]
        assert plan.stats() == [{"rule": "engine.step:crash:target=replica1,"
                                 "start=2,stop=3", "matched": 4, "fired": 1}]
    for bad in ("justasite", "disk.read:io_error:notakv",
                "disk.read:io_error:bogus=1", "disk.read:io_error:start=x"):
        for parse in (FaultPlan.parse, JaxFaultPlan.parse):
            with pytest.raises(ValueError):
                parse(bad)
    # delay= is the CLI's alias of delay_s=
    assert FaultPlan.parse("peer.request:latency:delay=0.25").rules[0] \
        .delay_s == 0.25
    assert not FaultPlan.parse(" ; ") and FaultPlan.parse("a:b")


def test_peer_breaker_walks_the_reference_states():
    """closed -> open after the threshold -> half-open with one probe ->
    open again on a failed probe -> closed on a good one, with the same
    snapshot after every call in both packages."""
    calls = ["allow", "fail", "allow", "fail", "ok", "fail", "fail", "fail",
             "allow", "tick", "allow", "allow", "fail", "allow", "tick",
             "allow", "ok", "allow", "fail"]
    trails = []
    for cls in (PeerBreaker, JaxPeerBreaker):
        now = [0.0]
        br = cls(threshold=3, cooldown_s=10.0, clock=lambda: now[0])
        trail = []
        for c in calls:
            out = None
            if c == "allow":
                out = br.allow()
            elif c == "fail":
                br.record_failure()
            elif c == "ok":
                br.record_success()
            else:
                now[0] += 11.0
            trail.append((c, out, br.snapshot()))
        trails.append(trail)
    assert trails[0] == trails[1]
    states = [s["state"] for _, _, s in trails[0]]
    assert {"closed", "open", "half_open"} <= set(states)
    # the half-open state admits exactly one probe
    assert [out for c, out, _ in trails[0][9:12]] == [None, True, False]


def test_blackholed_peer_trips_the_breaker_after_its_threshold():
    """Every pull from a blackholed peer is a counted miss; the first
    ``threshold`` pay a (short) wait, the rest are breaker skips."""
    got = []
    for server_cls, store, transport, backend, plan in (
            (KVPeerServer, DictBlockStore, PeerTransport, NetworkBackend,
             FaultPlan),
            (JaxPeerServer, JaxDictBlockStore, JaxTransport,
             JaxNetworkBackend, JaxFaultPlan)):
        srv = server_cls(store())
        try:
            t = transport(srv.address, timeout_s=0.5, retries=1)
            nb = backend([t], faults=plan.parse(
                "peer.request:blackhole:delay=0.01"), breaker_threshold=3,
                breaker_cooldown_s=60.0)
            assert all(nb.get(f"ident{i}") is None for i in range(6))
            s = nb.stats()
            got.append((s["hits"], s["misses"], s["timeouts"], s["retries"],
                        s["breaker_skips"], s["breakers"][t.address]))
        finally:
            srv.close()
    assert got[0] == got[1]
    assert got[0][:5] == (0, 6, 6, 3, 3)
    assert got[0][5]["state"] == "open" and got[0][5]["opened"] == 1


def _kv(seed, n=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, n, 2, 8)).astype(np.float32)
                 for _ in range(2))


def _libs(tmp_path, spec, **kw):
    return [KVLibrary(spool_dir=str(tmp_path / "torch"),
                      faults=FaultPlan.parse(spec), **kw),
            JaxLibrary(spool_dir=str(tmp_path / "jax"),
                       faults=JaxFaultPlan.parse(spec), **kw)]


def _put(lib, mid, seed=0):
    k, v = _kv(seed)
    if isinstance(lib, KVLibrary):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    return lib.put("u", mid, k, v)


def _degraded(lib):
    st = lib.stats()
    disk = st["tiers"][TIER_DISK]
    return st["degraded"], disk["quarantined"], disk["fetch_misses"], \
        [lib.peek_tier("u", m) for m in "abcdef"]


def test_disk_quarantine_after_consecutive_read_failures(tmp_path):
    per = sum(a.nbytes for a in _kv(0))
    trails = []
    for lib in _libs(tmp_path, "disk.read:io_error", hbm_capacity=per,
                     host_capacity=1):
        trail = []
        for m in "abcd":                # each put spools the one before
            _put(lib, m)
        assert [lib.peek_tier("u", m) for m in "abc"] == [TIER_DISK] * 3
        for m in "abc":                 # three injected read errors: misses
            assert lib.get("u", m) is None
            trail.append(_degraded(lib))
        assert lib.get("u", "d") is not None    # memory keeps serving
        for m in "ef":                  # no spool while quarantined
            _put(lib, m)
        trail.append(_degraded(lib))
        lib.reinstate_disk()
        trail.append(_degraded(lib))
        trails.append(trail)
    assert trails[0] == trails[1]
    deg, quarantined, fetch_misses, tiers = trails[0][-2]
    assert deg["disk_quarantined"] and quarantined and fetch_misses == 3
    assert TIER_DISK not in tiers[3:]
    assert not trails[0][-1][0]["disk_quarantined"]


def test_enospc_is_counted_and_never_quarantines(tmp_path):
    per = sum(a.nbytes for a in _kv(0))
    out = []
    for lib in _libs(tmp_path, "disk.write:enospc", hbm_capacity=per,
                     host_capacity=1):
        a = _put(lib, "a")
        _put(lib, "b")                  # pressure: spool a -> ENOSPC
        assert a.payload.k is not None  # the failed demotion kept it
        assert lib.get("u", "a") is not None
        out.append(_degraded(lib))
    assert out[0] == out[1]
    deg = out[0][0]
    assert deg["enospc"] >= 1 and deg["spool_failures"] >= 1
    assert not deg["disk_quarantined"] and deg["disk_failure_streak"] == 0


def test_loader_error_is_a_counted_miss(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path),
                    faults=FaultPlan.parse("loader.fetch:error:target=bad"))
    _put(lib, "bad")
    _put(lib, "good")
    loader = ParallelLoader(lib, 2)
    try:
        h = loader.prefetch_handle("u", ["bad", "good"])
        assert h.get("bad") is None
        assert h.get("good") is not None
        assert loader.load_failures == 1
        assert h.get("bad") is None     # a re-gather: still a calm miss
        h.release()
    finally:
        loader.close()


def test_loader_stall_still_delivers(tmp_path):
    lib = KVLibrary(spool_dir=str(tmp_path), faults=FaultPlan.parse(
        "loader.fetch:stall:delay=0.1,stop=1"))
    _put(lib, "m")
    loader = ParallelLoader(lib, 2)
    try:
        t0 = time.perf_counter()
        h = loader.prefetch_handle("u", ["m"])
        assert h.get("m") is not None
        assert time.perf_counter() - t0 >= 0.1
        assert loader.load_failures == 0
        h.release()
        assert lib.faults.stats()[0]["fired"] == 1
    finally:
        loader.close()


def _snapshot(eng):
    return ([None if r is None else (r.req_id, r.state, len(r.output_tokens),
                                     r.cur_len) for r in eng.running],
            len(eng.queue), len(eng.finished), eng.pool.free_pages,
            eng._page_tables.copy().tolist())


def test_engine_step_crash_leaves_the_engine_as_it_was():
    """``engine.step:crash`` on the second step (the JAX engine's target
    outside a cluster, ``replicaNone``) raises before any work: the engine
    is as the first step left it, and the next step goes on."""
    *_, model, params = build_pair()
    cfg = model.cfg
    eng = MPICEngine(model, params, EngineConfig(max_seq_len=128,
                                                 decode_slots=2),
                     device="cpu", faults=FaultPlan.parse(
                         "engine.step:crash:target=replicaNone,start=1,"
                         "stop=2"))
    try:
        r = np.random.default_rng(0)
        for mid in "AB":
            eng.upload("u1", mid, image_embeds(mid, 16, cfg.d_model))
        for seed in range(2):
            segs = [text_segment(r.integers(8, 200, 5))]
            for mid in "AB":
                segs += [media_segment(mid, image_embeds(mid, 16,
                                                         cfg.d_model)),
                         text_segment(r.integers(8, 200, 4))]
            eng.submit(Request(prompt=Prompt(segs, user_id="u1"),
                               max_new_tokens=3, policy_kwargs={"k": 4}))
        eng.step()
        before = _snapshot(eng)
        with pytest.raises(ReplicaCrash):
            eng.step()
        assert _snapshot(eng) == before
        eng.run()
        assert [len(q.output_tokens) for q in eng.finished] == [3, 3]
    finally:
        eng.close()
