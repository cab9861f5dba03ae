"""Tensor-parallel ranks for the port's sharded-serving tests, and the
traffic both packages' engines serve.

No JAX here: the ranks are processes started with ``torch.multiprocessing``
(spawn), which import this module and the port only.  :class:`Ranks`
starts ``world`` ranks on the CPU over gloo (a free port from
``bind(0)``, an init timeout that bounds every collective), each building
the port's model from the same numpy weight tree, sharding it over its
mesh and running a list of cases; every rank's results come back through
a queue.  ``Ranks.results`` waits at most ``JOIN_TIMEOUT_S`` and kills
the ranks past it, so a hang fails the test instead of running into the
suite's clock.

:func:`run_traffic` serves the same stream through either package's
engine (or a cluster), given that package's constructors: three two-image
dialogues under a trace of policies and one MRAG request (retrieved
12-token image, ``mpic``).  The parity cases mirror the JAX package's
sharded worker (``tests/_sharded_worker.py``): kernel, decode, prefill,
mrag, cacheblend, dense, int8, nondiv.  The system half's cases serve the
stream with every block spooled to a directory the ranks share (disk),
with every dialogue image pulled from a peer (peer), through two
replicas (replicas), a session's freeze, thaw and fork (sessions), and an
aging queue whose order each rank's clock would decide otherwise (aging).
The families whose experts or SSD heads the mesh cuts run, through the
call case, the traffic of their own parity modules (``target`` names a
``module:function`` that takes the model, its weights and the mesh), so
that each module holds its ranks to the JAX results it computes anyway;
:class:`counting_drops` counts a MoE's dropped pairs pass by pass.
"""
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 300.0      # the whole run of one set of ranks
INIT_TIMEOUT_S = 60.0       # the process group and each collective
MAX_NEW = 5
REL = 1e-4              # first-token logits, relative (see check_requests)
POLICY_KW = {"mpic": {"k": 8}, "cacheblend": {"r": 0.25}}
# setup name -> (EngineConfig overrides, the three dialogues' policies)
SETUPS = {
    "paged": (dict(max_seq_len=256, decode_slots=2),
              ("mpic", "cacheblend", "full_recompute")),
    "dense": (dict(max_seq_len=256, decode_slots=2, paged=False),
              ("mpic", "full_recompute", "cacheblend")),
    "int8": (dict(max_seq_len=256, decode_slots=2, pool_dtype="int8"),
             ("mpic", "cacheblend", "full_recompute")),
}


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def check_requests(got, want, *, tol=REL, atol=None):
    """A rank's requests against the unsharded engine's: done, the same
    tokens, linked media and counts; first-token logits within ``tol``
    relative (or ``atol`` absolute)."""
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["done"] == "done"
        assert g["tokens"] == w["tokens"]
        assert len(g["tokens"]) == MAX_NEW
        assert g["linked"] == w["linked"]
        assert g["n_reused"] == w["n_reused"]
        assert g["n_recomputed"] == w["n_recomputed"]
        if atol is None:
            assert rel(g["first"], w["first"]) <= tol
        else:
            np.testing.assert_allclose(g["first"], w["first"], atol=atol,
                                       rtol=0)
    assert "RAG1" in got[-1]["linked"]


def upload_dialogues(eng, pkg, d_model: int, media_len: int):
    """Upload the stream's dialogue images; returns the dialogues."""
    samples = pkg["make_dialogues"](n=3, n_images=2, d_model=d_model,
                                    media_len=media_len)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    return samples


def run_traffic(eng, pkg, d_model: int, media_len: int, policies, *,
                upload: bool = True):
    """Serve the stream through ``eng``, an engine or a cluster (``pkg``:
    a dict of the package's ``make_dialogues``, ``image_embeds``,
    ``text_segment``, ``Prompt`` and ``Request``); ``upload=False`` leaves
    the dialogue images to the library's peers.  Returns one dict per
    request: its tokens, first-token logits, ``n_reused``,
    ``n_recomputed`` and linked media."""
    firsts = {}
    engines = getattr(eng, "engines", [eng])
    for e in engines:
        def record(req, result, *rest, finalize=e._finalize_prefill):
            firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
            return finalize(req, result, *rest)
        e._finalize_prefill = record
    if upload:
        samples = upload_dialogues(eng, pkg, d_model, media_len)
    else:
        samples = pkg["make_dialogues"](n=3, n_images=2, d_model=d_model,
                                        media_len=media_len)
    rag = pkg["image_embeds"]("RAG1", 12, d_model)
    eng.upload("*", "RAG1", rag, dynamic=True)
    mk = pkg["Request"]
    reqs = [mk(prompt=s.prompt, max_new_tokens=MAX_NEW, policy=p,
               policy_kwargs=POLICY_KW.get(p, {}))
            for s, p in zip(samples, policies)]
    rag_req = mk(prompt=pkg["Prompt"]([pkg["text_segment"](
        np.arange(20, 60))], user_id="u0"), max_new_tokens=MAX_NEW,
        policy="mpic", policy_kwargs=POLICY_KW["mpic"])
    rag_req.retrieval_query = rag.mean(0)
    reqs.append(rag_req)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while any(e.scheduler.queue or any(e.running) for e in engines) \
            and steps < 1000:
        eng.step()
        steps += 1
    return [{"tokens": list(r.output_tokens), "first": firsts[r.req_id],
             "n_reused": r.prefill_stats.get("n_reused"),
             "n_recomputed": r.prefill_stats.get("n_recomputed"),
             "linked": list(r.linked_media), "done": r.state.value}
            for r in reqs]


def _torch_pkg():
    from repro_torch.core import Prompt, text_segment
    from repro_torch.data import image_embeds, make_dialogues
    from repro_torch.serving import Request
    return {"make_dialogues": make_dialogues, "image_embeds": image_embeds,
            "text_segment": text_segment, "Prompt": Prompt,
            "Request": Request}


# ---------------------------------------------------------------------------
# the cases a rank runs
# ---------------------------------------------------------------------------

class counting_drops:
    """Inside the block every routing pass's (rows, dropped pairs) is
    appended to ``drops``, in the order the passes route (``moe.route``
    is the seam)."""

    def __init__(self):
        self.drops = []

    def __enter__(self):
        from repro_torch.models import moe
        self._route = route = moe.route

        def counting(*args, **kwargs):
            out = route(*args, **kwargs)
            self.drops.append((int(out[1].shape[0]), int((~out[4]).sum())))
            return out

        moe.route = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def case_serve(model, params, mesh, setup: str):
    """One setup of :data:`SETUPS` through ``MPICEngine(mesh=)``; also
    whether every page came back and which shapes the pool and the dense
    cache have."""
    from repro_torch.serving import EngineConfig, MPICEngine
    over, policies = SETUPS[setup]
    eng = MPICEngine(model, params, EngineConfig(**over), mesh=mesh,
                     device="cpu")
    try:
        out = run_traffic(eng, _torch_pkg(), model.cfg.d_model,
                          model.cfg.media_token_len, policies)
        facts = {"attn_sharded": eng.sharding.attn,
                 "local_kv_heads": eng.model.cfg.num_kv_heads}
        if eng.pool is not None:
            facts["pool_shape"] = tuple(eng.pool.k.shape)
            facts["pages_back"] = (eng.pool.free_pages
                                   == eng.pool.cfg.num_pages - 1)
            if eng.pool.quantized:
                facts["scale_shape"] = tuple(eng.pool.k_scale.shape)
        else:
            facts["cache_shape"] = tuple(eng._batch_cache["k"].shape)
        return {"requests": out, "facts": facts}
    finally:
        eng.close()


def case_kernel(model, params, mesh):
    """Kernels 1, 3 and 5 (their dispatchers) on the rank's kv heads of
    whole seeded inputs, gathered over the heads, against the whole call:
    the largest difference of each."""
    from repro_torch.kernels.paged_attn.ops import paged_attention
    from repro_torch.kernels.selective_attn.ops import (
        selective_attention,
        selective_attention_paged,
    )
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, model.cfg)
    rng = np.random.default_rng(0)
    hkv, g, dh, pages, ps = model.cfg.num_kv_heads, 2, 16, 6, 16
    hq = hkv * g

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    kp, vp = t(pages, ps, hkv, dh), t(pages, ps, hkv, dh)
    table = torch.as_tensor(rng.permutation(pages)[:4][None].repeat(2, 0),
                            dtype=torch.int32)
    lengths = torch.tensor([37, 12], dtype=torch.int32)
    q1 = t(2, hq, dh)
    qs = t(1, 5, hq, dh)
    qpos = torch.tensor([[3, 10, 20, 30, 36]], dtype=torch.int32)
    k, v = t(1, 40, hkv, dh), t(1, 40, hkv, dh)
    kvpos = torch.arange(40, dtype=torch.int32)[None]
    lo, n = sh.mesh.rank * (hkv // mesh.model), hkv // mesh.model

    def heads(x, dim):
        return x.narrow(dim, lo * g, n * g) if x.shape[dim] == hq \
            else x.narrow(dim, lo, n)

    runs = {
        "paged_decode": (lambda q, kp_, vp_: paged_attention(
            q, kp_, vp_, table, lengths, window=8), (q1, kp, vp), (1, 2, 2),
            1),
        "paged_prefill": (lambda q, kp_, vp_: selective_attention_paged(
            q, kp_, vp_, table[:1], qpos, lengths[:1]), (qs, kp, vp),
            (2, 2, 2), 2),
        "dense": (lambda q, k_, v_: selective_attention(
            q, k_, v_, qpos, kvpos, window=16), (qs, k, v), (2, 2, 2), 2),
    }
    err = {}
    for name, (fn, args, dims, out_dim) in runs.items():
        want = fn(*args)
        got = mesh.all_gather(fn(*[heads(a, d).contiguous()
                                   for a, d in zip(args, dims)]), out_dim)
        err[name] = float((got - want).abs().max())
    return err


def case_decode(model, params, mesh, tokens, steps: int):
    """The reference's model-level decode case: a prefill of ``tokens``
    into a dense cache, its K/V written into a head-sharded pool, then
    ``steps`` paged decode steps fed greedily.  Returns the prefill's last
    logits and each step's (whole vocabulary), and the collectives the
    prefill and the first decode step ran (``record_collectives``)."""
    from repro_torch.cache.paged import PagedConfig, PagedKVPool
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, model.cfg)
    local, shard = sh.local_model(), sh.shard(params)
    cfg = local.cfg
    t0 = len(tokens)
    with torch.inference_mode():
        cache = local.make_cache(1, 64, device="cpu")
        with record_collectives(mesh) as prefill_calls:
            logits, cache = local.prefill(
                shard, torch.as_tensor(np.asarray(tokens)[None],
                                       dtype=torch.int32), cache)
        pool = PagedKVPool(PagedConfig(
            num_pages=8, page_size=16, num_layers=cfg.num_layers,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            dtype="float32"), device="cpu")
        pt = pool.alloc("r", t0 + steps)
        pool.write_tokens(pt, 0, cache["k"][:, 0, :t0], cache["v"][:, 0, :t0])
        out = [logits[0, -1].numpy().copy()]
        tok = int(logits[0, -1].argmax())
        decode_calls = []
        for i in range(steps):
            cur = t0 + i
            with record_collectives(mesh) as calls:
                lg = local.decode_step_paged(
                    shard, torch.tensor([[tok]], dtype=torch.int32),
                    torch.tensor([[cur]], dtype=torch.int32), pool.k, pool.v,
                    torch.as_tensor(pt[None]),
                    torch.tensor([cur + 1], dtype=torch.int32),
                    torch.tensor([pt[cur // 16]], dtype=torch.int32),
                    torch.tensor([cur % 16], dtype=torch.int32))
            decode_calls = decode_calls or calls
            out.append(lg[0].numpy().copy())
            tok = int(lg[0].argmax())
    return {"logits": out, "pool_shape": tuple(pool.k.shape),
            "prefill_calls": prefill_calls, "decode_calls": decode_calls}


def _spooled(spool_dir: str, mesh=None):
    """A static and a dynamic library with no memory budget over
    ``spool_dir``, in ``mesh``'s role: every block spools at its upload."""
    from repro_torch.cache import KVLibrary
    return [KVLibrary(shared=shared, spool_dir=spool_dir, hbm_capacity=0,
                      host_capacity=0, device="cpu", mesh=mesh)
            for shared in (False, True)]


def _tiers(lib) -> dict:
    """A library's disk (and network) read and write counters."""
    tiers = lib.stats()["tiers"]
    out = {f"disk_{k}": tiers["disk"][k]
           for k in ("fetches", "bytes_read", "bytes_written")}
    if "network" in tiers:
        out["network_fetches"] = tiers["network"]["fetches"]
    return out


def case_disk(model, params, mesh, spool_dir: str):
    """The paged setup with every image, static and dynamic, spooled into
    the directory that the ranks share: rank 0 writes, every rank reads.
    Also returns the content keys of the static blocks this rank read."""
    from repro_torch.serving import EngineConfig, MPICEngine
    over, policies = SETUPS["paged"]
    static, dynamic = _spooled(spool_dir, mesh)
    read, get = set(), static.disk.get

    def recorded(key):
        got = get(key)
        if got is not None:
            read.add(key)
        return got

    static.disk.get = recorded
    eng = MPICEngine(model, params, EngineConfig(**over), mesh=mesh,
                     device="cpu", static_library=static,
                     dynamic_library=dynamic)
    try:
        out = run_traffic(eng, _torch_pkg(), model.cfg.d_model,
                          model.cfg.media_token_len, policies)
        return {"requests": out,
                "static": dict(_tiers(static), read_keys=sorted(read)),
                "dynamic": _tiers(dynamic)}
    finally:
        eng.close()


def case_peer(model, params, mesh, inbox, spool_dir: str):
    """The paged setup with no dialogue image uploaded: rank 0 pulls each
    from the peer whose address ``inbox`` brings (the JAX package's block
    server), the other ranks read what rank 0 wrote into ``spool_dir``."""
    from repro_torch.cache import KVLibrary
    from repro_torch.serving import EngineConfig, MPICEngine
    addr = inbox.get(timeout=JOIN_TIMEOUT_S)
    over, policies = SETUPS["paged"]
    static = KVLibrary(peers=[addr], spool_dir=spool_dir, device="cpu",
                       mesh=mesh)
    eng = MPICEngine(model, params, EngineConfig(**over), mesh=mesh,
                     device="cpu", static_library=static)
    try:
        out = run_traffic(eng, _torch_pkg(), model.cfg.d_model,
                          model.cfg.media_token_len, policies, upload=False)
        return {"requests": out, "static": _tiers(static)}
    finally:
        eng.close()


def case_sessions(model, params, mesh, pool: str, spool_dir: str):
    """One dialogue under ``full_recompute`` frozen after 4 tokens (and
    spooled), thawed with a 4-token suffix, then forked into 2; also run
    unsharded (``mesh=None``) as the oracle.  Returns each request's
    tokens and its first token's logits, and the snapshot's disk reads."""
    from repro_torch.cache import KVLibrary
    from repro_torch.serving import EngineConfig, MPICEngine, Request
    pkg = _torch_pkg()
    lib = KVLibrary(spool_dir=spool_dir, device="cpu", mesh=mesh)
    eng = MPICEngine(model, params, EngineConfig(
        max_seq_len=256, decode_slots=2, pool_dtype=pool), mesh=mesh,
        device="cpu", static_library=lib)
    firsts = {}
    select = eng._select_token

    def record(req, row):
        firsts.setdefault(req.req_id, np.asarray(row, np.float32).copy())
        return select(req, row)

    eng._select_token = record
    try:
        dialogue = pkg["make_dialogues"](
            n=1, n_images=2, d_model=model.cfg.d_model,
            media_len=model.cfg.media_token_len)[0]
        for _, seg in dialogue.prompt.media_segments():
            eng.upload(dialogue.prompt.user_id, seg.media_id, seg.embeds)
        req = eng.submit(pkg["Request"](
            prompt=dialogue.prompt, max_new_tokens=8, freeze_after=4,
            policy="full_recompute"))
        eng.run()
        handle = eng.sessions.handles[req.session_id]
        spooled = eng.sessions.stats()["spooled_handles"]
        thawed = eng.thaw(handle, [7, 8, 9, 10], max_new_tokens=MAX_NEW)
        eng.run()
        forks = eng.fork(handle, 2, max_new_tokens=MAX_NEW)
        eng.run()
        done = [req, thawed, *forks]
        return {"tokens": [list(r.output_tokens) for r in done],
                "first": [firsts[r.req_id] for r in done[:2]],
                "state": [r.state.value for r in done],
                "spooled": spooled, "static": _tiers(lib)}
    finally:
        eng.close()


def case_replicas(model, params, mesh):
    """The paged setup through two replicas over the mesh (affinity
    routing, rank 0's decisions)."""
    from repro_torch.serving import (ClusterConfig, EngineConfig,
                                     MPICCluster)
    over, policies = SETUPS["paged"]
    cluster = MPICCluster(model, params, EngineConfig(**over), ClusterConfig(
        replicas=2, router="affinity"), mesh=mesh, device="cpu")
    try:
        out = run_traffic(cluster, _torch_pkg(), model.cfg.d_model,
                          model.cfg.media_token_len, policies)
        return {"requests": out,
                "replicas": [d.replica for d in cluster.decisions]}
    finally:
        cluster.close()


def case_aging(model, params, mesh):
    """Three dialogues of priorities 0, 2 and 1 into one slot with queue
    aging, rank 1 waiting 0.2 s after each submit, so that its clock would
    age its older requests ahead of rank 0's order.  Returns the admission
    order (request indices) and every request's tokens."""
    from repro_torch.serving import EngineConfig, MPICEngine
    pkg = _torch_pkg()
    eng = MPICEngine(model, params, EngineConfig(
        max_seq_len=256, decode_slots=1, queue_aging_s=0.05), mesh=mesh,
        device="cpu")
    admitted = []
    pop = eng.scheduler.pop

    def record():
        req, handle = pop()
        admitted.append(req)
        return req, handle

    eng.scheduler.pop = record
    try:
        samples = upload_dialogues(eng, pkg, model.cfg.d_model,
                                   model.cfg.media_token_len)
        reqs = []
        for s, priority in zip(samples, (0, 2, 1)):
            reqs.append(eng.submit(pkg["Request"](
                prompt=s.prompt, max_new_tokens=3, priority=priority,
                policy="mpic", policy_kwargs=POLICY_KW["mpic"])))
            if mesh.rank == 1:
                time.sleep(0.2)
        eng.run()
        return {"order": [reqs.index(r) for r in admitted],
                "tokens": [list(r.output_tokens) for r in reqs]}
    finally:
        eng.close()


def audio_passes(model, params, mesh, tokens, audio, steps: int):
    """whisper's model on the rank's shard: ``tokens`` (B, S) prefilled
    into a dense cache of 64 slots with ``audio`` (B, Senc, D) encoded
    first, then ``steps`` greedy decode steps.  Returns each pass's
    whole-vocabulary last logits (B, V), the cache's cross K/V shape and
    the collectives of the prefill (the encoder's included) and of the
    first decode step."""
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.serving.sharding import ServingSharding
    sh = ServingSharding(mesh, model.cfg)
    local, shard = sh.local_model(), sh.shard(params)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32)
    b, s = toks.shape
    with torch.inference_mode():
        cache = local.make_cache(b, 64, device="cpu")
        with record_collectives(mesh) as prefill_calls:
            logits, cache = local.prefill(shard, toks, cache,
                                          audio_embeds=torch.as_tensor(audio))
        out = [logits[:, -1].numpy().copy()]
        tok, decode_calls = logits[:, -1].argmax(-1), None
        for i in range(steps):
            p = torch.full((b, 1), s + i, dtype=torch.int32)
            with record_collectives(mesh) as calls:
                lg, cache = local.decode_step(
                    shard, tok[:, None].to(torch.int32), p, cache, p)
            decode_calls = calls if decode_calls is None else decode_calls
            out.append(lg.numpy().copy())
            tok = lg.argmax(-1)
    return {"logits": out, "cross_k": tuple(cache["cross_k"].shape),
            "prefill_calls": prefill_calls, "decode_calls": decode_calls}


def case_call(model, params, mesh, target: str, **kw):
    """``target`` (``"module:function"``, a test helper importable in the
    rank) called with the model, its whole weights, the mesh and ``kw``:
    a parity module's own traffic through ``MPICEngine(mesh=)``."""
    import importlib
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)(
        model, params, mesh, **kw)


CASES = {"serve": case_serve, "kernel": case_kernel, "decode": case_decode,
         "disk": case_disk, "peer": case_peer, "sessions": case_sessions,
         "replicas": case_replicas, "aging": case_aging, "call": case_call}


def _rank_main(rank, world, port, cfg, tree, jobs, out_q):
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model
    from repro_torch.weights import params_from_numpy
    torch.set_num_threads(1)
    mesh = None
    try:
        mesh = make_serving_mesh(model=world, device="cpu", rank=rank,
                                 init_method=f"tcp://127.0.0.1:{port}",
                                 timeout_s=INIT_TIMEOUT_S)
        model = build_model(cfg)
        params = params_from_numpy(tree, cfg, "cpu")
        res = {name: CASES[kind](model, params, mesh, **kw)
               for name, kind, kw in jobs}
        out_q.put((rank, res, None))
    except BaseException:
        out_q.put((rank, None, traceback.format_exc()))
    finally:
        if mesh is not None:
            mesh.close()


class Ranks:
    """``world`` ranks started now, each running ``jobs`` (``(name,
    case, kwargs)``) on ``cfg`` (the port's config) with the weights of
    ``tree``."""

    def __init__(self, world: int, cfg, tree, jobs):
        from repro_torch.launch.mesh import free_port
        ctx = mp.get_context("spawn")
        self._q = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, port, cfg, tree, jobs, self._q)) for r in range(world)]
        for p in self._procs:
            p.start()
        self._t0 = time.monotonic()
        self._out = None

    def results(self):
        """{rank: {job name: result}}, collected at the first call and
        kept; raises (at every call) on a rank's error or past the join
        timeout (the ranks are killed either way)."""
        if self._out is None:
            try:
                self._out = self._collect()
            except (RuntimeError, TimeoutError) as e:
                self._out = e
        if isinstance(self._out, Exception):
            raise self._out
        return self._out

    def close(self):
        """Kill the ranks still running (results never asked for)."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)

    def _collect(self):
        out = {}
        try:
            while len(out) < len(self._procs):
                left = JOIN_TIMEOUT_S - (time.monotonic() - self._t0)
                try:
                    rank, res, err = self._q.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(len(self._procs))) - set(out))}"
                        f" gave no result in {JOIN_TIMEOUT_S} s")
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                out[rank] = res
            for p in self._procs:
                p.join(timeout=max(JOIN_TIMEOUT_S
                                   - (time.monotonic() - self._t0), 1.0))
        finally:
            self.close()
        return out
