"""The port's routers (``repro_torch.serving.router``) against the JAX
package's on seeded random replica views: ``random`` (same seed, same
picks), ``least_loaded`` and ``affinity`` (default and other weights) pick
the same replica with the same scores, ties to the lower id included;
``make_router`` rejects an unknown name as the reference does; and
``heartbeat_view`` builds the reference's view from one heartbeat.
"""
import dataclasses

import numpy as np
import pytest

from repro.cache.backends import scope_digest as jax_scope_digest
from repro.core import Prompt as JaxPrompt
from repro.core import media_segment as jax_media
from repro.core import text_segment as jax_text
from repro.serving import ReplicaView as JaxView
from repro.serving import Request as JaxRequest
from repro.serving import heartbeat_view as jax_heartbeat_view
from repro.serving import make_router as jax_make_router
from repro_torch.core import Prompt, media_segment, text_segment
from repro_torch.serving import ReplicaView, Request, heartbeat_view, make_router

TIERS = ("hbm", "host", "disk", "miss")
ROUTERS = [("random", {}), ("least_loaded", {}), ("affinity", {}),
           ("affinity", {"w_hbm": 1.0, "w_host": 3.0, "w_disk": 2.0,
                         "w_load": 0.5})]


def _views(seed):
    """2-5 views of random load and warmth; every third seed repeats one
    view under another id, so that scores tie."""
    rng = np.random.default_rng(seed)
    views = []
    for rid in range(int(rng.integers(2, 6))):
        total = int(rng.choice([0, 8, 64]))
        views.append(dict(
            replica_id=rid, free_slots=int(rng.integers(0, 4)),
            queue_depth=int(rng.integers(0, 5)),
            free_pages=int(rng.integers(0, total + 1)), total_pages=total,
            warmth={t: int(rng.integers(0, 3)) for t in TIERS}))
    if seed % 3 == 0:
        views[-1] = dict(views[0], replica_id=views[-1]["replica_id"])
    return views


@pytest.mark.parametrize("name,kwargs", ROUTERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ROUTERS)])
@pytest.mark.parametrize("seed", range(6))
def test_routers_pick_the_reference_replica_and_scores(name, kwargs, seed):
    jrouter = jax_make_router(name, seed=seed, **kwargs)
    trouter = make_router(name, seed=seed, **kwargs)
    for k in range(4):
        views = _views(100 * seed + k)
        jd = jrouter.route(JaxRequest(prompt=None),
                           [JaxView(**v) for v in views])
        td = trouter.route(Request(prompt=None),
                           [ReplicaView(**v) for v in views])
        assert td.replica == jd.replica
        assert td.scores == jd.scores
        assert td.warmth == jd.warmth and td.policy == jd.policy == name


def test_ties_go_to_the_lower_replica_id():
    same = dict(free_slots=1, queue_depth=0, free_pages=4, total_pages=8,
                warmth={"hbm": 1})
    for name in ("least_loaded", "affinity"):
        views = [ReplicaView(replica_id=r, **same) for r in (2, 0, 1)]
        assert make_router(name).route(Request(prompt=None),
                                       views).replica == 0


def test_make_router_rejects_an_unknown_name_as_the_reference():
    with pytest.raises(ValueError) as jexc:
        jax_make_router("bogus")
    with pytest.raises(ValueError) as texc:
        make_router("bogus")
    assert str(texc.value) == str(jexc.value)


def test_heartbeat_view_gives_the_reference_view():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((4, 8)).astype(np.float32)
    toks = rng.integers(8, 200, 5)
    media = ["warm", "cold", "hot"]
    jreq = JaxRequest(prompt=JaxPrompt(
        [jax_text(toks)] + [jax_media(m, emb) for m in media], user_id="u1"))
    treq = Request(prompt=Prompt(
        [text_segment(toks)] + [media_segment(m, emb) for m in media],
        user_id="u1"))
    heartbeat = {"load": {"free_slots": 1, "queue_depth": 2,
                          "free_pages": 7, "total_pages": 9},
                 "media": {jax_scope_digest(("u1", "warm")): "disk",
                           jax_scope_digest(("u1", "hot")): "hbm",
                           jax_scope_digest(("u2", "cold")): "host"}}
    jv = jax_heartbeat_view(1, "127.0.0.1:9", heartbeat, jreq)
    tv = heartbeat_view(1, "127.0.0.1:9", heartbeat, treq)
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    assert tv.warmth == {"disk": 1, "miss": 1, "hbm": 1}
