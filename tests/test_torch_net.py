"""The port's network KV tier (``repro_torch.cache.net``, ``NetworkBackend``
and the library's peer surface) against the JAX package's.

A library that misses locally pulls a peer's block bit-exactly and counts
it as the JAX library counts it; ``register_remote`` plants an entry the
loader pulls; a pushed block is served back; a peer slower than the
client's timeout reads as a miss, releases the loader's dedup slot, and
serves again once it recovers; a call on one thread leaves another
thread's status alone (the JAX transport's shared status does not).  Over
loopback the two packages talk to each other both ways, bf16 and int8,
under equal keys.  Then the port's
engine with an empty library, pulling every image from a JAX serving
host, gives the greedy tokens of the JAX receiving engine under ``mpic``
on both pools.  The only waits on a clock are short transport timeouts
against a server delay five times longer.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache import KVPeerServer as JaxPeerServer
from repro.cache import PeerTransport as JaxTransport
from repro.data import make_dialogues as jax_dialogues
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.cache import (
    TIER_NETWORK,
    BlockMetadata,
    KVLibrary,
    KVPeerServer,
    NetworkBackend,
    ParallelLoader,
    PeerTransport,
    content_key,
    payload_from_bytes,
    payload_to_bytes,
)
from repro_torch.cache.backends import KVPayload
from repro_torch.data import make_dialogues
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401


def _arrays(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    return k.astype(dtype), v.astype(dtype)


def _lib(pkg, path, **kw):
    if pkg == "jax":
        return JaxLibrary(spool_dir=str(path), **kw)
    return KVLibrary(spool_dir=str(path), device="cpu", **kw)


def _host(x):
    """A library tensor or array as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _put(lib, mid, k, v, **kw):
    if isinstance(lib, KVLibrary):
        k, v = (torch.from_numpy(np.asarray(a, np.float32)) for a in (k, v))
        if kw.pop("bf16", False):
            k, v = k.bfloat16(), v.bfloat16()
    else:
        kw.pop("bf16", None)
    return lib.put("u", mid, k, v, **kw)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_pull_and_tier_accounting_match_the_reference(pkg, tmp_path):
    """A pull from a peer whose block lives on its disk: bit-exact, the
    peer's TTL honoured, counted once on the network tier, local from then
    on, and a second user cannot pull the first one's block; the port's
    counters equal the JAX package's on the same calls."""
    k, v = _arrays(3)
    counts = {}
    for side in ("torch", "jax"):
        src = _lib(pkg, tmp_path / side / "src", hbm_capacity=1,
                   host_capacity=1)
        _put(src, "m", k, v, ttl=60.0)
        server = (KVPeerServer if pkg == "torch" else JaxPeerServer)(src)
        try:
            lib = _lib(side, tmp_path / side / "dst", peers=[server.address])
            got = lib.get("u", "m")
            np.testing.assert_array_equal(_host(got.k), k)
            np.testing.assert_array_equal(_host(got.v), v)
            assert 0 < got.expires - time.time() < 61
            assert lib.get("u", "m") is got       # local now: no second pull
            assert lib.get("bob", "m") is None    # scope isolation
            if pkg == "torch":
                # the JAX server counts a block after writing it, which
                # the client can outrun; the port's counts it before
                assert server.stats()["served_blocks"] == 1
            st = lib.stats()
            net = st["tiers"][TIER_NETWORK]
            assert net["fetch_s"] > 0
            counts[side] = ({t: {c: st["tiers"][t][c] for c in
                                 ("hits", "promotes", "demotes")}
                             for t in ("hbm", "host", "disk", "network")},
                            st["misses"], net["fetches"], net["fetch_misses"],
                            net["timeouts"], net["retries"],
                            net["breaker_skips"])
        finally:
            server.close()
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][0]["network"] == {"hits": 1, "promotes": 1,
                                             "demotes": 0}


def test_register_remote_is_pulled_by_the_loader(tmp_path):
    k, v = _arrays(4)
    src = _lib("torch", tmp_path / "src")
    _put(src, "m", k, v)
    server = KVPeerServer(src)
    try:
        lib = _lib("torch", tmp_path / "dst", peers=[server.address])
        e = lib.register_remote("u", "m", nbytes=k.nbytes * 2)
        assert e is not None and lib.peek_tier("u", "m") == TIER_NETWORK
        assert lib.register_remote("u", "m") is None    # the entry wins
        loader = ParallelLoader(lib)
        try:
            h = loader.prefetch_handle("u", ["m"])
            got = h.get("m", timeout=10)
            assert got is e and got.tier != TIER_NETWORK
            np.testing.assert_array_equal(got.k.numpy(), k)
            h.release()
        finally:
            loader.close()
        assert lib.stats()["tiers"][TIER_NETWORK]["promotes"] == 1
    finally:
        server.close()


def test_pushed_block_is_served_back(tmp_path):
    """A PUT to a library's server is fetchable through it at once, HEAD
    sees it, DELETE drops it; the wire helpers round-trip the payload."""
    store = _lib("torch", tmp_path)
    server = KVPeerServer(store)
    try:
        k, v = (torch.from_numpy(a) for a in _arrays(11))
        p = KVPayload(k=k, v=v)
        assert torch.equal(payload_from_bytes(payload_to_bytes(p)).k, k)
        key = content_key(p, ("u", "m"))
        be = NetworkBackend([server.address])
        be.put(key, p, BlockMetadata(media_id="m",
                                     expires=time.time() + 60))
        assert be.contains(key) and store.has_block(key)
        got = be.get(key)
        assert torch.equal(got.k, k) and torch.equal(got.v, v)
        be.delete(key)
        assert not be.contains(key)
        assert be.stats()["hits"] == 1
    finally:
        server.close()


def test_timeout_falls_back_without_leaking_the_dedup_slot(tmp_path):
    """A peer five times slower than the client's timeout: two timed-out
    attempts, a miss (the caller recomputes), the loader's in-flight slot
    retired; once the peer answers in time the same block pulls."""
    k, v = _arrays(5)
    src = _lib("torch", tmp_path / "src")
    _put(src, "m", k, v)
    server = KVPeerServer(src, delay_s=0.5)
    try:
        lib = _lib("torch", tmp_path / "dst",
                   peers=[PeerTransport(server.address, timeout_s=0.1)])
        loader = ParallelLoader(lib)
        h = loader.prefetch_handle("u", ["m"])
        assert h.get("m", timeout=10) is None
        h.release()
        loader.pool.shutdown(wait=True)     # every done-callback has run
        assert not loader._inflight and loader.load_failures == 0
        net = lib.stats()["tiers"][TIER_NETWORK]
        assert (net["timeouts"], net["retries"], net["fetch_misses"]) \
            == (2, 1, 1)
        server.delay_s = 0.0
        got = lib.get("u", "m")
        np.testing.assert_array_equal(got.k.numpy(), k)
    finally:
        server.close()


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_packages_pull_each_others_blocks(server_pkg, quantize, tmp_path):
    """One package serves, the other pulls and verifies, over loopback:
    bf16 blocks as bf16, int8 blocks as their int8 bytes and scales, under
    the key the serving package's own content hash gives."""
    k, v = _arrays(7)
    bf16 = not quantize
    if bf16:
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    client_pkg = "torch" if server_pkg == "jax" else "jax"
    src = _lib(server_pkg, tmp_path / "src", quantize=quantize)
    e_src = _put(src, "m", k, v, bf16=bf16)
    server = (JaxPeerServer if server_pkg == "jax" else KVPeerServer)(src)
    try:
        lib = _lib(client_pkg, tmp_path / "dst", peers=[server.address])
        got = lib.get("u", "m")
        assert got is not None
        assert lib.stats()["tiers"][TIER_NETWORK]["promotes"] == 1
        # the port hashes a block at its first export
        assert got.meta.key == e_src.meta.key
        if quantize:
            for name in ("qk", "qv"):
                a, b = getattr(got, name), getattr(e_src, name)
                np.testing.assert_array_equal(_host(a.q), _host(b.q))
                np.testing.assert_array_equal(_host(a.scale), _host(b.scale))
        else:
            assert _host(got.k).dtype == np.uint16      # still bf16
            np.testing.assert_array_equal(_host(got.k), _host(k))
            np.testing.assert_array_equal(_host(got.v), _host(v))
    finally:
        server.close()


class _Held:
    """A block source that holds every GET of ``"held"`` inside the server
    until ``release`` is set (and then misses)."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def export_block(self, ident):
        if ident == "held":
            self.entered.set()
            self.release.wait(10)
        return None

    def has_block(self, ident):
        return False

    def admit_block(self, ident, data, headers):
        pass

    def delete_block(self, ident):
        pass


def test_a_call_on_another_thread_keeps_this_threads_status():
    """The loader's threads share one transport.  A HEAD answered 404 on
    this thread, then a GET begun on another thread: the port's transport
    still reads 404 here, the status the breaker is fed; the JAX
    transport's shared status reads None, a failure of a live peer."""
    seen = {}
    for name, server_cls, transport_cls in (
            ("torch", KVPeerServer, PeerTransport),
            ("jax", JaxPeerServer, JaxTransport)):
        source = _Held()
        server = server_cls(source)
        t = transport_cls(server.address, timeout_s=20, retries=0)
        other = threading.Thread(target=t.fetch, args=("held",))
        try:
            assert not t.probe("absent")
            other.start()
            assert source.entered.wait(10)
            seen[name] = t.last_status
        finally:
            source.release.set()
            other.join(10)
            server.close()
        assert not other.is_alive()
    assert seen == {"torch": 404, "jax": None}


def _serve(pkg, model, params, lib, pool_dtype):
    """Three two-image dialogues under mpic k=8 through one package's
    engine over ``lib``, which holds none of their images."""
    cfg = model.cfg
    if pkg == "jax":
        eng = JaxEngine(model, params, JaxEngineConfig(
            max_seq_len=256, decode_slots=2, paged_backend="ref",
            pool_dtype=pool_dtype, pipelined=False), static_library=lib)
        samples, mk = jax_dialogues, JaxRequest
    else:
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype),
            static_library=lib, device="cpu")
        samples, mk = make_dialogues, Request
    reqs = [mk(prompt=s.prompt, max_new_tokens=4, policy="mpic",
               policy_kwargs={"k": 8})
            for s in samples(n=3, n_images=2, d_model=cfg.d_model,
                             media_len=cfg.media_token_len)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    if pkg == "torch":
        eng.close()
    assert all(r.done and len(r.output_tokens) == 4 for r in reqs)
    return [r.output_tokens for r in reqs]


def test_port_engine_pulls_from_a_jax_host(tmp_path):
    """A JAX serving host uploads the images (an fp32 and an int8
    library); the port's engine and the JAX engine, each with an empty
    library peered with it, serve the same traffic: every image is a
    network pull, and the greedy tokens are equal, on the fp32 pool from
    the fp32 host and on the int8 pool from the int8 host."""
    jmodel, jparams, tmodel, tparams = build_pair()
    cfg = jmodel.cfg
    host = JaxEngine(jmodel, jparams, JaxEngineConfig(
        max_seq_len=256, decode_slots=2, paged_backend="ref"),
        static_library=JaxLibrary(spool_dir=str(tmp_path / "host")))
    q8 = JaxLibrary(spool_dir=str(tmp_path / "host8"), quantize=True)
    placed = set()
    for s in jax_dialogues(n=3, n_images=2, d_model=cfg.d_model,
                           media_len=cfg.media_token_len):
        for _, seg in s.prompt.media_segments():
            host.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            e = host.static_lib.get(s.prompt.user_id, seg.media_id)
            q8.put(s.prompt.user_id, seg.media_id, e.k, e.v)
            placed.add(seg.media_id)
    servers = {"": JaxPeerServer(host.static_lib), "int8": JaxPeerServer(q8)}
    try:
        for pool_dtype, server in servers.items():
            tokens = {}
            for pkg, params in (("jax", jparams), ("torch", tparams)):
                lib = _lib(pkg, tmp_path / f"{pkg}{pool_dtype}",
                           peers=[server.address])
                model = jmodel if pkg == "jax" else tmodel
                tokens[pkg] = _serve(pkg, model, params, lib, pool_dtype)
                st = lib.stats()
                assert st["tiers"][TIER_NETWORK]["promotes"] == len(placed)
                assert st["misses"] == 0
            assert tokens["torch"] == tokens["jax"], pool_dtype
    finally:
        for server in servers.values():
            server.close()
