"""The port's session store (``repro_torch.serving.sessions``: freeze, thaw
and fork on the copy-on-write page pool) against the JAX package's, on the
fp32 smoke llava with the JAX weights, on an fp32 and an int8 pool.

Each case of the reference's ``tests/test_sessions.py`` runs in both
packages and the port must give the JAX engine's tokens:

* resume parity: ``frozen[:-1] + thawed == uninterrupted``, bit for bit on
  both pools (on int8 the adopted pages and scale rows equal the pool at
  freeze time, byte for byte);
* a thaw with the next turn's suffix gives a cold recompute's tokens;
* a fork of n children allocates no page before the first divergent write
  and copies n - 1 pages there; sampled children diverge;
* the error paths, the idle sweep and the ``sessions`` counters.

The reference's cluster case becomes two engines sharing one library.  A
session crosses between the packages both ways, through a spool directory
(``rehydrate=True``) and through a peer's ``KVPeerServer``, and a handle's
``to_json`` is read by the other package.  A salted block spooled by
either package rehydrates in both under its salted ident only.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache import TIER_DISK as JAX_TIER_DISK
from repro.cache.net import KVPeerServer as JaxPeerServer
from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.sessions import SessionHandle as JaxHandle
from repro_torch.cache import TIER_DISK, KVLibrary, KVPeerServer
from repro_torch.core import Prompt, text_segment
from repro_torch.serving import EngineConfig, MPICEngine, Request, State
from repro_torch.serving.sessions import SESSION_MEDIA_PREFIX, SessionHandle

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

POOLS = pytest.mark.parametrize("pool_dtype", ["", "int8"],
                                ids=["fp32", "int8"])
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _toks(seed, n=12):
    return np.random.default_rng(seed).integers(8, 200, n)


def _lib(pkg, spool=None, **kw):
    if pkg == "jax":
        return JaxLibrary(spool_dir=spool and str(spool), **kw)
    return KVLibrary(spool_dir=spool and str(spool), device="cpu", **kw)


def _eng(pkg, pair, lib=None, *, slots=2, dtype="", idle=0.0, **kw):
    jmodel, jparams, tmodel, tparams = pair
    if pkg == "jax":
        return JaxEngine(jmodel, jparams, JaxEngineConfig(
            max_seq_len=128, decode_slots=slots, pool_dtype=dtype,
            freeze_idle_s=idle, paged_backend="ref", pipelined=False, **kw),
            static_library=lib)
    return MPICEngine(tmodel, tparams, EngineConfig(
        max_seq_len=128, decode_slots=slots, pool_dtype=dtype,
        freeze_idle_s=idle, **kw), static_library=lib, device="cpu")


def _req(pkg, toks, *, max_new=8, freeze_after=None, seed=0, user="u"):
    if pkg == "jax":
        return JaxRequest(prompt=JaxPrompt([jax_text(toks)], user_id=user),
                          max_new_tokens=max_new, policy="full_recompute",
                          seed=seed, freeze_after=freeze_after)
    return Request(prompt=Prompt([text_segment(toks)], user_id=user),
                   max_new_tokens=max_new, policy="full_recompute",
                   seed=seed, freeze_after=freeze_after)


def _frozen(pkg, pair, toks, *, lib=None, dtype="", after=4, **kw):
    """A request frozen (and spooled) at ``after`` output tokens: (engine,
    request, handle)."""
    e = _eng(pkg, pair, lib, dtype=dtype, **kw)
    fz = _req(pkg, toks, freeze_after=after)
    e.submit(fz)
    e.run()
    return e, fz, e.sessions.handles[fz.session_id]


def _handle_for(pkg, handle):
    """A handle read by ``pkg`` from the other package's ``to_json``,
    through JSON text."""
    d = json.loads(json.dumps(handle.to_json()))
    return (JaxHandle if pkg == "jax" else SessionHandle).from_json(d)


# ---------------------------------------------------------------------------
# resume parity
# ---------------------------------------------------------------------------

def _resume(pkg, pair, dtype, toks):
    e1 = _eng(pkg, pair, dtype=dtype)
    base = _req(pkg, toks)
    e1.submit(base)
    e1.run()
    e2, fz, h = _frozen(pkg, pair, toks, dtype=dtype)
    assert fz.state.value == "frozen" and fz in e2.frozen and fz.slot == -1
    assert e2.pool.owned_pages(fz.req_id) == 0
    assert h.n_ctx == len(toks) + 3 and h.next_token == fz.output_tokens[-1]
    e3 = _eng(pkg, pair, e2.static_lib, dtype=dtype)
    return base, fz, h, e3


@POOLS
def test_thaw_resumes_token_identical(pair, pool_dtype):
    """Frozen at 4 tokens, thawed on another engine sharing only the
    library: the composed output is the never-frozen one, in both packages
    and equal between them.  On int8 the adopted pages' bytes and scale
    rows are those of the pool at freeze time."""
    toks = _toks(3)
    outs = {}
    for pkg in ("jax", "torch"):
        base, fz, h, e3 = _resume(pkg, pair, pool_dtype, toks)
        th = e3.thaw(h)
        if pkg == "torch" and pool_dtype == "int8":
            pool = e3.pool
            snap = e3.static_lib.get(h.user_id, h.media_id,
                                     salt=h.cache_salt).payload
            pages = torch.as_tensor(
                e3._page_tables[th.slot][:pool.pages_for(h.n_ctx)]).long()
            ps = pool.cfg.page_size
            for buf, q in ((pool.k, snap.qk), (pool.v, snap.qv)):
                got = buf[:, pages].flatten(1, 2)[:, :h.n_ctx]
                assert torch.equal(got, q.q[:, :h.n_ctx])
            assert torch.equal(pool.k_scale[:, pages], snap.qk.scale[..., 0])
            assert torch.equal(pool.v_scale[:, pages], snap.qv.scale[..., 0])
            assert snap.qk.block_tokens == ps
        e3.run()
        assert th.prefill_stats["thawed"] and th.state.value == "done"
        assert fz.output_tokens[:-1] + th.output_tokens == base.output_tokens
        outs[pkg] = (base.output_tokens, fz.output_tokens, th.output_tokens)
    assert outs["torch"] == outs["jax"]


def test_frozen_int8_snapshot_is_the_pool_at_freeze(pair):
    """The int8 snapshot ships the pool's raw page bytes, zeroed past
    ``n_ctx``, and its scale rows: what the pool held when it froze."""
    e = _eng("torch", pair, dtype="int8")
    fz = _req("torch", _toks(4))
    e.submit(fz)
    while len(fz.output_tokens) < 3:
        e.step()
    pool, row = e.pool, e._page_tables[fz.slot]
    npages = pool.pages_for(fz.cur_len)
    pages = torch.as_tensor(row[:npages]).long()
    k_at, ks_at = pool.k[:, pages].clone(), pool.k_scale[:, pages].clone()
    n = fz.cur_len
    h = e.freeze(fz.req_id)
    snap = e.static_lib.get(h.user_id, h.media_id, salt=h.cache_salt).payload
    q = snap.qk.q.reshape(k_at.shape)
    assert torch.equal(q.flatten(1, 2)[:, :n], k_at.flatten(1, 2)[:, :n])
    assert not q.flatten(1, 2)[:, n:].any()
    assert torch.equal(snap.qk.scale[..., 0], ks_at)
    assert fz.state is State.FROZEN and e.pool.owned_pages(fz.req_id) == 0


@POOLS
def test_suffix_thaw_matches_cold_recompute(pair, pool_dtype):
    """A thaw with the next turn's suffix (adopted pages, then a prefill of
    the suffix alone) against a cold prefill of the whole history: equal
    greedy tokens on fp32, first-token logits within 1e-3; the port's
    thaw gives the JAX thaw's tokens on both pools."""
    toks, suffix = _toks(5), [int(t) for t in _toks(6, 5)]
    outs = {}
    for pkg in ("jax", "torch"):
        e1, fz, h = _frozen(pkg, pair, toks, dtype=pool_dtype)
        e2 = _eng(pkg, pair, e1.static_lib, dtype=pool_dtype)
        firsts = []
        if pkg == "torch":
            prefill = e2._prefiller.prefill

            def recording(*args):
                firsts.append(prefill(*args))
                return firsts[-1]
            e2._prefiller.prefill = recording
        th = e2.thaw(h, suffix, max_new_tokens=4)
        assert th.prefill_stats == {"thawed": True, "n_reused": h.n_ctx,
                                    "n_recomputed": len(suffix) + 1}
        e2.run()
        e3 = _eng(pkg, pair, dtype=pool_dtype)
        full = list(toks) + fz.output_tokens[:-1] + [h.next_token] + suffix
        cold = _req(pkg, np.asarray(full, np.int32), max_new=4)
        if pkg == "torch":
            finalize = e3._finalize_prefill

            def record(req, result, *rest):
                firsts.append(np.asarray(result.first_logits, np.float32))
                return finalize(req, result, *rest)
            e3._finalize_prefill = record
        e3.submit(cold)
        e3.run()
        if pool_dtype == "":
            assert th.output_tokens == cold.output_tokens
            if pkg == "torch":
                np.testing.assert_allclose(firsts[0], firsts[1], atol=1e-3,
                                           rtol=0)
        outs[pkg] = th.output_tokens
    assert outs["torch"] == outs["jax"]


# ---------------------------------------------------------------------------
# fork: copy-on-write sharing
# ---------------------------------------------------------------------------

@POOLS
def test_fork_allocates_nothing_until_divergence(pair, pool_dtype):
    """Three children share every page of the snapshot: no page beyond
    the one footprint at the fork, and the first decode step (each child
    writes the same last page) copies n - 1 = 2 pages; the last holder
    writes in place.  Greedy children decode alike, as in JAX."""
    outs = {}
    for pkg in ("jax", "torch"):
        e1, fz, h = _frozen(pkg, pair, _toks(7), dtype=pool_dtype)
        e = _eng(pkg, pair, e1.static_lib, slots=4, dtype=pool_dtype)
        free0 = e.pool.free_pages
        kids = e.fork(h, 3, max_new_tokens=3)
        parent_pages = e.pool.pages_for(h.n_ctx + 1)
        assert e.pool.cow_copies == 0
        assert e.pool.free_pages == free0 - parent_pages
        assert e.pool.pages_shared == parent_pages * 3
        assert all(k.output_tokens == [h.next_token] for k in kids)
        e.step()
        assert e.pool.cow_copies == 2
        e.run()
        assert e.pool.cow_copies == 2
        assert kids[0].output_tokens == kids[1].output_tokens \
            == kids[2].output_tokens
        sess = e.static_lib.stats()["sessions"]
        assert sess["forks"] == 3 and sess["cow_copies"] == 2
        assert sess["pages_shared"] == parent_pages * 3
        assert e.pool.free_pages == e.pool.cfg.num_pages - 1
        outs[pkg] = ([k.output_tokens for k in kids], sess)
    assert outs["torch"] == outs["jax"]


def test_sampled_fork_children_diverge(pair):
    """Children sample with seeds ``seed + i``: their tokens differ, and
    equal the JAX children's draw for draw."""
    outs = {}
    for pkg in ("jax", "torch"):
        e1, fz, h = _frozen(pkg, pair, _toks(8), **SAMPLED)
        e = _eng(pkg, pair, e1.static_lib, slots=4, **SAMPLED)
        kids = e.fork(h, 3, max_new_tokens=8)
        e.run()
        toks = [k.output_tokens for k in kids]
        assert [k.seed for k in kids] == [h.seed, h.seed + 1, h.seed + 2]
        assert len({tuple(t) for t in toks}) > 1
        outs[pkg] = toks
    assert outs["torch"] == outs["jax"]


# ---------------------------------------------------------------------------
# errors, idle sweep, counters, two engines on one library
# ---------------------------------------------------------------------------

def test_freeze_thaw_error_paths(pair):
    e = _eng("torch", pair)
    with pytest.raises(KeyError):
        e.freeze("no-such-req")
    e, fz, h = _frozen("torch", pair, _toks(9), after=3)
    with pytest.raises(ValueError, match="pool"):
        _eng("torch", pair, e.static_lib, dtype="int8").thaw(h)
    with pytest.raises(ValueError):
        e.fork(h, 0)
    with pytest.raises(RuntimeError, match="free slots"):
        e.fork(h, 3)
    wrong = SessionHandle.from_json({**h.to_json(), "cache_salt": "0" * 16})
    with pytest.raises(LookupError):
        _eng("torch", pair, e.static_lib).thaw(wrong)
    e.static_lib.delete(h.user_id, h.media_id)
    with pytest.raises(LookupError):
        _eng("torch", pair, e.static_lib).thaw(h)
    dense = _eng("torch", pair, paged=False)
    r = _req("torch", _toks(9))
    dense.submit(r)
    dense.step()
    with pytest.raises(RuntimeError, match="paged KV pool"):
        dense.freeze(r.req_id)


def test_idle_sweep_spools_frozen_sessions(pair, tmp_path):
    """With ``freeze_idle_s`` set, a snapshot frozen longer ago than that
    is spooled by the engine's step; its thaw reads the file back.  The
    JAX engine does the same and thaws to the same tokens."""
    outs = {}
    for pkg, tier in (("jax", JAX_TIER_DISK), ("torch", TIER_DISK)):
        lib = _lib(pkg, tmp_path / pkg)
        e = _eng(pkg, pair, lib, idle=30.0)
        fz = _req(pkg, _toks(11))
        e.submit(fz)
        while len(fz.output_tokens) < 3:
            e.step()
        h = e.freeze(fz.req_id)
        assert lib.peek_tier(h.user_id, h.media_id,
                             salt=h.cache_salt) != tier
        assert lib.peek_tier(h.user_id, h.media_id) is None
        assert e.sessions.sweep_idle(30.0) == 0
        h.frozen_at -= 60.0
        e.step()
        assert lib.peek_tier(h.user_id, h.media_id,
                             salt=h.cache_salt) == tier
        assert e.sessions.stats() == {"frozen_handles": 1,
                                      "spooled_handles": 1}
        e2 = _eng(pkg, pair, lib)
        th = e2.thaw(h)
        e2.run()
        assert th.output_tokens[0] == h.next_token
        if pkg == "torch":
            assert lib.stats()["tiers"]["disk"]["fetches"] == 1
        outs[pkg] = th.output_tokens
    assert outs["torch"] == outs["jax"]


def test_counters_and_two_engines_on_one_library(pair):
    """Frozen on one engine, thawed on another that shares its library,
    forked back on the first: the library counts every event and sums the
    two pools' gauges, as the JAX library does."""
    outs = {}
    for pkg in ("jax", "torch"):
        lib = _lib(pkg)
        e1, fz, h = _frozen(pkg, pair, _toks(13), lib=lib, after=3)
        e2 = _eng(pkg, pair, lib)
        th = e2.thaw(h)
        e2.run()
        kids = e1.fork(h, 2)
        e1.run()
        sess = lib.stats()["sessions"]
        assert (sess["freezes"], sess["thaws"], sess["forks"]) == (1, 1, 2)
        assert sess["pages_shared"] == e1.pool.pages_for(h.n_ctx + 1) * 2
        assert th.output_tokens[0] == h.next_token
        outs[pkg] = (th.output_tokens, [k.output_tokens for k in kids], sess)
    assert outs["torch"] == outs["jax"]


def test_handle_json_crosses_packages(pair):
    """Each package reads the other's ``to_json`` (through JSON text)
    into an equal handle; the session media id and the budget rule are
    the same."""
    _, fz, jh = _frozen("jax", pair, _toks(14))
    _, _, th = _frozen("torch", pair, _toks(14))
    for h, other in ((jh, "torch"), (th, "jax")):
        back = _handle_for(other, h)
        assert back.to_json() == h.to_json()
        assert back.remaining_tokens == h.remaining_tokens \
            == 8 - len(h.output_tokens) + 1
        assert back.media_id.startswith(SESSION_MEDIA_PREFIX)
    for key in ("n_ctx", "output_tokens", "next_token", "pool_dtype",
                "page_size", "max_new_tokens", "seed"):
        assert th.to_json()[key] == jh.to_json()[key], key


# ---------------------------------------------------------------------------
# across the packages: spool and peer, both ways
# ---------------------------------------------------------------------------

ROUTES = pytest.mark.parametrize("route", ["spool", "peer"])


def _reader_lib(pkg, route, frozen_lib, spool, servers):
    """The thawing host's library: a cold one over the freezer's spool
    directory, or an empty one peered with a server over the freezer's
    library."""
    if route == "spool":
        copy = spool.parent / f"{spool.name}-copy"
        shutil.copytree(spool, copy)
        return _lib(pkg, copy, rehydrate=True)
    srv = (JaxPeerServer if pkg == "torch" else KVPeerServer)(frozen_lib)
    servers.append(srv)
    return _lib(pkg, peers=[srv.address])


@POOLS
@ROUTES
def test_session_crosses_between_the_packages(pair, pool_dtype, route,
                                              tmp_path):
    """A session frozen and spooled by one package thaws in the other from
    the spool (rehydrated) or a peer, and gives the tokens of the freezing
    package's own thaw; both directions."""
    toks = _toks(15)
    servers = []
    try:
        for src, dst in (("jax", "torch"), ("torch", "jax")):
            spool = tmp_path / src
            e1, fz, h = _frozen(src, pair, toks, lib=_lib(src, spool),
                                dtype=pool_dtype)
            own = _eng(src, pair, e1.static_lib, dtype=pool_dtype)
            mine = own.thaw(h)
            own.run()
            lib = _reader_lib(dst, route, e1.static_lib, spool, servers)
            e2 = _eng(dst, pair, lib, dtype=pool_dtype)
            theirs = e2.thaw(_handle_for(dst, h))
            e2.run()
            assert theirs.output_tokens == mine.output_tokens, (src, dst)
            assert fz.output_tokens[:-1] + theirs.output_tokens[:1] == \
                fz.output_tokens
    finally:
        for srv in servers:
            srv.close()


def test_wrong_salt_misses_on_every_peer(pair):
    """A handle with another salt asks each peer at an address no block
    has: every peer answers 404, the thaw raises LookupError and the
    library counts one miss; the right salt then pulls the block."""
    e1, fz, h = _frozen("torch", pair, _toks(16), lib=_lib("torch"))
    servers = [KVPeerServer(e1.static_lib), JaxPeerServer(JaxLibrary())]
    try:
        lib = _lib("torch", peers=[s.address for s in servers])
        e2 = _eng("torch", pair, lib)
        wrong = SessionHandle.from_json({**h.to_json(),
                                         "cache_salt": "f" * 16})
        with pytest.raises(LookupError):
            e2.thaw(wrong)
        st = lib.stats()
        assert st["misses"] == 1
        assert st["tiers"]["network"]["fetch_misses"] == 1
        assert [t.last_status for t in lib.network.transports] == [404, 404]
        assert servers[0].stats()["served_blocks"] == 0
        th = e2.thaw(h)
        e2.run()
        assert th.output_tokens[0] == h.next_token
        assert lib.stats()["tiers"]["network"]["fetches"] == 1
    finally:
        for srv in servers:
            srv.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_salted_spool_rehydrates_under_its_salt(writer, reader, tmp_path):
    """A salted block spooled by either package rehydrates in either: found
    with its salt, a miss without it or with another (the sidecar carries
    the salt)."""
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((2, 9, 2, 4)).astype(np.float32)
            for _ in range(2))
    lib = _lib(writer, tmp_path / "w")
    if writer == "torch":
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    lib.put("u", "m", k, v, salt="s1", raw=True)
    assert lib.spool_now("u", "m")
    cold = _lib(reader, tmp_path / "w", rehydrate=True)
    assert cold.get("u", "m") is None
    assert cold.get("u", "m", salt="s2") is None
    e = cold.get("u", "m", salt="s1")
    assert e is not None
    np.testing.assert_array_equal(np.asarray(e.payload.k), np.asarray(k))
