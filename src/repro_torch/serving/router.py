"""Request routing for the data-parallel cluster and the fleet (port of the
JAX package's ``serving/router.py``).

A router picks the replica that serves a request from a snapshot of every
eligible replica (:class:`ReplicaView`: free decode slots, free pool pages,
queue depth, and how warm the request's media are on that replica).  Three
policies:

* ``random``: a seeded uniform choice, the baseline;
* ``least_loaded``: the most spare capacity (free slots, free page share,
  minus half the queue depth);
* ``affinity``: the replica where the request's media KV is warmest (hbm
  on that replica, host, disk), the load deciding between equally warm
  ones.  Position-independent reuse pays at fleet scale only if requests
  land where their media KV already is.

Ties go to the lower replica id.  Every decision is kept
(:class:`RoutingDecision`) for the cluster's report.  A fleet host's
heartbeat gossips its library's ``{scope digest: tier}`` map, from which
:func:`heartbeat_view` recomputes a request's warmth on that host, so a
remote host is scored exactly as a local replica is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache.backends import scope_digest
from repro_torch.cache.library import TIER_DISK, TIER_HBM, TIER_HOST
from repro_torch.serving.request import Request


@dataclasses.dataclass
class ReplicaView:
    """One eligible replica at routing time.  ``address`` is a fleet
    host's control address (None in the in-process cluster, which
    dispatches by ``replica_id``)."""
    replica_id: int
    free_slots: int
    queue_depth: int
    free_pages: int
    total_pages: int
    warmth: Dict[str, int]          # tier -> count over this request's media
    address: Optional[str] = None

    @property
    def load_score(self) -> float:
        """Higher: more spare capacity."""
        pages = (self.free_pages / self.total_pages
                 if self.total_pages else 1.0)
        return self.free_slots + pages - 0.5 * self.queue_depth


@dataclasses.dataclass
class RoutingDecision:
    """One routed request, kept for the report."""
    req_id: str
    policy: str
    replica: int
    scores: Dict[int, float]        # replica -> score (empty for random)
    warmth: Dict[str, int]          # the chosen replica's tier histogram
    address: Optional[str] = None   # the chosen host's (fleet routing)


class Router:
    """Base router: subclasses implement :meth:`choose`."""

    name = "?"

    def choose(self, req: Request, views: List[ReplicaView]
               ) -> Tuple[int, Dict[int, float]]:
        raise NotImplementedError

    def route(self, req: Request, views: List[ReplicaView]
              ) -> RoutingDecision:
        if not views:
            raise ValueError("a router needs at least one eligible replica")
        replica, scores = self.choose(req, views)
        chosen = next(v for v in views if v.replica_id == replica)
        return RoutingDecision(req_id=req.req_id, policy=self.name,
                               replica=replica, scores=scores,
                               warmth=dict(chosen.warmth),
                               address=chosen.address)


class RandomRouter(Router):
    name = "random"

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def choose(self, req, views):
        return views[int(self._rng.integers(len(views)))].replica_id, {}


def _best(views: List[ReplicaView], scores: Dict[int, float]) -> int:
    """The highest score, the lowest replica id on ties."""
    return max(views, key=lambda v: (scores[v.replica_id],
                                     -v.replica_id)).replica_id


class LeastLoadedRouter(Router):
    name = "least_loaded"

    def choose(self, req, views):
        scores = {v.replica_id: v.load_score for v in views}
        return _best(views, scores), scores


class AffinityRouter(Router):
    """Warmth-weighted routing, the load breaking ties.

    ``w_hbm`` / ``w_host`` weigh blocks warm on the replica's device against
    blocks resident in the library's memory (any replica links those,
    only the holder skips the copy); ``w_disk`` makes a host whose spool
    has the block (a restarted, rehydrated fleet host) beat a cold one.
    In one process every replica sees the same disk, so the term cancels.
    ``w_load`` scales the load down so that it only decides between
    equally warm replicas; the cluster offers no saturated replica.
    """

    name = "affinity"

    def __init__(self, w_hbm: float = 2.0, w_host: float = 1.0,
                 w_disk: float = 0.5, w_load: float = 0.01):
        self.w_hbm = w_hbm
        self.w_host = w_host
        self.w_disk = w_disk
        self.w_load = w_load

    def choose(self, req, views):
        scores = {
            v.replica_id: (self.w_hbm * v.warmth.get(TIER_HBM, 0)
                           + self.w_host * v.warmth.get(TIER_HOST, 0)
                           + self.w_disk * v.warmth.get(TIER_DISK, 0)
                           + self.w_load * v.load_score)
            for v in views}
        return _best(views, scores), scores


ROUTERS = {
    "random": RandomRouter,
    "least_loaded": LeastLoadedRouter,
    "affinity": AffinityRouter,
}


def make_router(name: str, *, seed: int = 0, **kwargs) -> Router:
    """A routing policy by name; an unknown name raises ``ValueError``."""
    if name not in ROUTERS:
        raise ValueError(
            f"unknown router policy {name!r} (known: {sorted(ROUTERS)})")
    if name == "random":
        return RandomRouter(seed=seed, **kwargs)
    return ROUTERS[name](**kwargs)


def _media_ids(req: Request) -> List[str]:
    return [seg.media_id for _, seg in req.prompt.media_segments()]


def replica_view(engine, library, req: Request,
                 warmth: Optional[Dict[str, int]] = None) -> ReplicaView:
    """One in-process replica's view for ``req``, from its engine's
    ``load_info`` and the shared library's warmth on that replica."""
    info = engine.load_info()
    if warmth is None:
        warmth = library.warmth(req.prompt.user_id, _media_ids(req),
                                engine.replica_id)
    return ReplicaView(replica_id=info["replica"],
                       free_slots=info["free_slots"],
                       queue_depth=info["queue_depth"],
                       free_pages=info["free_pages"],
                       total_pages=info["total_pages"], warmth=warmth)


def heartbeat_view(host_id: int, address: str, heartbeat: dict,
                   req: Request) -> ReplicaView:
    """A fleet host's view for ``req`` from its gossiped heartbeat (``GET
    /health``): the engine's ``load_info`` under ``"load"`` and the
    library's ``ident_tiers()`` under ``"media"``; each media segment's
    scope digest looks its tier up (``"miss"`` when absent)."""
    load = heartbeat.get("load", {})
    media = heartbeat.get("media", {})
    warmth: Dict[str, int] = {}
    for mid in _media_ids(req):
        tier = media.get(scope_digest((req.prompt.user_id, mid)), "miss")
        warmth[tier] = warmth.get(tier, 0) + 1
    return ReplicaView(replica_id=host_id,
                       free_slots=load.get("free_slots", 0),
                       queue_depth=load.get("queue_depth", 0),
                       free_pages=load.get("free_pages", 0),
                       total_pages=load.get("total_pages", 0),
                       warmth=warmth, address=address)
