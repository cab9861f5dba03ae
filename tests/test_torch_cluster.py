"""The port's data-parallel cluster (``repro_torch.serving.cluster``)
against the JAX package's ``MPICCluster``.

The same traffic (three two-image dialogues and an MRAG request,
submitted twice, so that the second round finds its media warm) goes
through two replicas of two decode slots behind the affinity router, with
a backpressure cap of two queued requests a replica, on the fp32 and the
int8 pool, in three runs: clean; ``engine.step:crash`` on ``replica1``
after its first step (quarantined, its requests routed again); and with
the budgets of one decoding request, one request in a replica's queue and
one held by backpressure set to elapse after the first step (both rounds
submitted at once; the other runs submit the second round once the first
is served).  Both
packages give the same routing decisions (replica, scores, warmth), the
same replica, state and greedy tokens for every request, first-token
logits within 1e-3, the same warm hits, requeues and reaped requests; the
crashed and reaped runs give the clean run's tokens for every request
they finish; every page goes back to its pool and no pin is held.  Also:
the aging queue pops in the reference's order, and a cluster whose every
replica crashes raises ``StuckFleetError`` as the reference's does.
"""
import itertools
import time

import numpy as np
import pytest

from repro.cache import FaultPlan as JaxFaultPlan
from repro.data import image_embeds as jax_image_embeds
from repro.data import make_dialogues as jax_dialogues
from repro.serving import ClusterConfig as JaxClusterConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICCluster as JaxCluster
from repro.serving import Request as JaxRequest
from repro.serving import StuckFleetError as JaxStuck
from repro.serving import WaitingQueue as JaxQueue
from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro_torch.cache import FaultPlan
from repro_torch.core import Prompt, text_segment
from repro_torch.data import image_embeds, make_dialogues
from repro_torch.serving import (
    ClusterConfig,
    EngineConfig,
    MPICCluster,
    Request,
    StuckFleetError,
    WaitingQueue,
)

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

MAX_NEW = 4
CRASH = "engine.step:crash:target=replica1,start=1"
RUNS = [(pool, mode) for pool in ("", "int8")
        for mode in ("clean", "crash", "deadline")]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _cluster(pkg, pair, pool_dtype, plan=""):
    jmodel, jparams, tmodel, tparams = pair
    ccfg = dict(replicas=2, router="affinity", max_queue_per_replica=2)
    ecfg = dict(max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype,
                pipelined=False)
    if pkg == "jax":
        return JaxCluster(jmodel, jparams,
                          JaxEngineConfig(paged_backend="ref", **ecfg),
                          JaxClusterConfig(faults=JaxFaultPlan.parse(plan)
                                           if plan else None, **ccfg))
    return MPICCluster(tmodel, tparams, EngineConfig(**ecfg),
                       ClusterConfig(faults=FaultPlan.parse(plan)
                                     if plan else None, **ccfg),
                       device="cpu")


def _traffic(pkg, cluster):
    """Uploads, and the requests of two rounds of the same prompts."""
    if pkg == "jax":
        dialogues, embeds, text, mk_prompt, mk_req = (
            jax_dialogues, jax_image_embeds, jax_text, JaxPrompt, JaxRequest)
    else:
        dialogues, embeds, text, mk_prompt, mk_req = (
            make_dialogues, image_embeds, text_segment, Prompt, Request)
    d = cluster.engines[0].model.cfg.d_model
    samples = dialogues(n=3, n_images=2, d_model=d, media_len=16)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            cluster.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    rag = embeds("RAG1", 12, d)
    cluster.upload("*", "RAG1", rag, dynamic=True)
    reqs = []
    for _ in range(2):
        for s in samples:
            reqs.append(mk_req(prompt=s.prompt, max_new_tokens=MAX_NEW,
                               policy="mpic", policy_kwargs={"k": 4}))
        r = mk_req(prompt=mk_prompt([text(np.arange(20, 60))],
                                    user_id="u0"),
                   max_new_tokens=MAX_NEW, policy="mpic",
                   policy_kwargs={"k": 4})
        r.retrieval_query = rag.mean(0)
        reqs.append(r)
    return reqs


def _serve(pkg, pair, pool_dtype, mode):
    cluster = _cluster(pkg, pair, pool_dtype, CRASH if mode == "crash"
                       else "")
    firsts = {}
    for eng in cluster.engines:
        def record(req, result, *rest, _fin=eng._finalize_prefill):
            firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
            return _fin(req, result, *rest)
        eng._finalize_prefill = record
    reqs = _traffic(pkg, cluster)
    rounds = [reqs] if mode == "deadline" else [reqs[:4], reqs[4:]]
    held, reaped = 0, []
    for batch in rounds:
        for r in batch:
            cluster.submit(r)
        held = max(held, cluster.pending)
        if mode != "deadline":
            cluster.run()
    if mode == "deadline":
        cluster.step()
        queued = {id(r) for e in cluster.engines for r in e.waiting}
        pending = {id(r) for r in cluster._pending}
        picks = [next(i for i, r in enumerate(reqs)
                      if r.state.value == "running" and r.output_tokens),
                 next(i for i, r in enumerate(reqs) if id(r) in queued),
                 next(i for i, r in enumerate(reqs) if id(r) in pending)]
        for i in picks:
            reqs[i].deadline_s = 1e-9
        reaped = picks
    cluster.run()
    rep = cluster.report()
    engines = cluster.engines
    pages_free = [e.pool.free_pages == e.pool.cfg.num_pages - 1
                  for e in engines]
    pins = sum(getattr(e, "_pins", None) or e.meta.pins
               for e in cluster.static_lib._entries.values())
    out = {
        "decisions": [(d.replica, d.scores, d.warmth)
                      for d in cluster.decisions],
        "replica": [r.replica for r in reqs],
        "state": [r.state.value for r in reqs],
        "tokens": [list(r.output_tokens) for r in reqs],
        "firsts": [firsts.get(r.req_id) for r in reqs],
        "warm_hits": sum(1 for d in cluster.decisions
                         if d.req_id in {r.req_id for r in reqs[4:]}
                         and d.warmth.get("hbm", 0) == 2),
        "held": held, "reaped": reaped,
        "expired": sorted(reqs.index(r) for r in cluster.expired),
        "requeued": rep["requeued"], "quarantined": sorted(rep["quarantined"]),
        "routing": rep["routing"], "dedup": rep["loader_dedup_hits"],
        "pages_free": pages_free, "pins": pins,
        "linked": [list(r.linked_media) for r in reqs],
    }
    cluster.close()
    return out


@pytest.fixture(scope="module")
def runs(pair):
    return {}


@pytest.fixture(scope="module", params=RUNS,
            ids=[f"{p or 'fp32'}-{m}" for p, m in RUNS])
def served(request, pair, runs):
    pool, mode = request.param
    for key in {(pool, "clean"), (pool, mode)}:
        if key not in runs:
            runs[key] = (_serve("jax", pair, *key), _serve("torch", pair, *key))
    return pool, mode, runs[pool, mode], runs[pool, "clean"]


def test_routing_and_tokens_equal_the_reference(served):
    _, mode, (jout, tout), _ = served
    for key in ("decisions", "replica", "state", "tokens", "warm_hits",
                "held", "expired", "requeued", "quarantined", "routing",
                "dedup", "linked"):
        assert tout[key] == jout[key], key
    for jl, tl in zip(jout["firsts"], tout["firsts"]):
        if jl is not None:
            np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    assert "RAG1" in tout["linked"][3]
    if mode == "deadline":
        assert tout["held"] > 0             # backpressure held some
    if mode == "clean":
        # the second round found every image warm on the replica it went to
        assert tout["warm_hits"] == 3
        assert all(s == "done" for s in tout["state"])


def test_faults_keep_the_clean_tokens_and_free_everything(served):
    _, mode, (_, tout), (_, clean) = served
    assert all(tout["pages_free"]) and tout["pins"] == 0
    for i, (state, toks) in enumerate(zip(tout["state"], tout["tokens"])):
        if state == "done":
            assert toks == clean["tokens"][i], i
    if mode == "crash":
        assert tout["quarantined"] == [1] and tout["requeued"] >= 1
        assert all(s == "done" for s in tout["state"])
        assert set(tout["replica"]) == {0}  # replica 1's work re-routed
    if mode == "deadline":
        assert tout["expired"] == sorted(tout["reaped"])
        assert [tout["state"][i] for i in tout["reaped"]] == ["deadline"] * 3
        # the decoding one keeps its partial output
        assert 0 < len(tout["tokens"][tout["reaped"][0]]) < MAX_NEW


def test_aging_queue_pops_in_the_reference_order(monkeypatch):
    tick = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 0.02 * next(tick))
    rng = np.random.default_rng(0)
    pris = [int(p) for p in rng.integers(0, 4, 12)]
    orders = []
    for queue_cls, req_cls in ((JaxQueue, JaxRequest), (WaitingQueue, Request)):
        for aging in (0.0, 0.05):
            q = queue_cls(aging_s=aging)
            reqs = [req_cls(prompt=None, priority=p) for p in pris]
            order = []
            for i, r in enumerate(reqs):
                q.push(r)
                if i % 3 == 2:
                    order.append(reqs.index(q.pop()))
            order += [reqs.index(q.peek(1)[0])]
            while q:
                order.append(reqs.index(q.pop()))
            orders.append(order)
    assert orders[2:] == orders[:2]
    assert orders[0] != orders[1]           # aging changed the order


def test_every_replica_crashing_raises_stuck_fleet(pair):
    errors = []
    for pkg, exc_type in (("jax", JaxStuck), ("torch", StuckFleetError)):
        cluster = _cluster(pkg, pair, "", "engine.step:crash")
        for r in _traffic(pkg, cluster)[:2]:
            cluster.submit(r)
        with pytest.raises(exc_type) as info:
            cluster.run()
        errors.append((str(info.value), info.value.fleet["pending"],
                       sorted(info.value.fleet["quarantined"])))
        cluster.close()
    assert errors[1] == errors[0]
    assert errors[1][2] == [0, 1]
