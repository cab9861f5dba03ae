"""Data-parallel serving cluster: N engine replicas behind one KV library
(port of the JAX package's ``serving/cluster.py``).

:class:`MPICCluster` owns N :class:`~repro_torch.serving.engine.MPICEngine`
replicas, each with its own page pool, decode slots and scheduler, over one
static library, one dynamic library, one retriever and one
:class:`~repro_torch.cache.transfer.ParallelLoader` with
``loader_workers_per_replica`` workers a replica.  Requests enter through
a router (``serving/router.py``) and the replicas step in turn, so one
Python driver serves them all:

* **affinity routing**: the shared library knows which replica holds each
  media block warm; the affinity router sends a request where its media
  are;
* **backpressure**: a replica whose waiting queue holds
  ``max_queue_per_replica`` requests takes no more; when none can,
  requests wait in the cluster's own pending queue and are routed as
  replicas drain, against fresh load and warmth;
* **one load stream**: each replica's prefetches are tagged with its id on
  the shared loader, which serves concurrent fetches of one block with one
  read;
* **peers**: ``ClusterConfig.peers`` pulls blocks missing locally from
  other hosts' block servers, ``serve_port`` exports this cluster's static
  library.

**Faults.**  A replica whose ``step()`` raises is quarantined: it leaves
routing and stepping, and every request it held that is not terminal
comes back through :meth:`MPICEngine.drain_for_failover` (pages freed,
pins released, reset to ``WAITING``) to be routed again.  A resubmit gives
the tokens the crashed replica would have given: the replicas share the
model and its weights, decode rows are independent, and sampling is
seeded per request.  ``deadline_s`` stamps a default budget on every
request; requests held under backpressure are reaped here, the rest by
the engines.  ``run`` and ``drain`` raise :class:`StuckFleetError` (or
record ``stuck_report`` with ``on_stuck="report"``) when ``max_steps`` end
with work still live, and a cluster whose every replica is quarantined
raises at once.

**Replicas over a mesh.**  ``mesh=`` gives every replica an engine over
the same tensor-parallel mesh, as the JAX cluster does: every rank runs
the same cluster, uploads and submits the same work, and the replicas
step round-robin, so the ranks issue their collectives in one order.
Rank 0 decides what reads a clock or rank-local state (a pending
request's deadline, each routing decision) and broadcasts it; the block
server runs on rank 0 alone.  A crash from the seeded fault plan fires
alike on every rank and quarantines the replica there; any other error
ends the run on every rank instead of quarantining a replica on one.

In eager PyTorch the replicas share the one model module; there is no
compiled step to share between them (the JAX cluster's ``_share_jits``)
and no trace count to report.  ``device`` follows the engine: None means
the card (the mesh's device under a mesh), and raises without one.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cache.faults import ReplicaCrash
from repro_torch.cache.library import KVLibrary
from repro_torch.cache.net import KVPeerServer
from repro_torch.cache.transfer import ParallelLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import agree
from repro_torch.serving.engine import EngineConfig, MPICEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever
from repro_torch.serving.router import (
    RoutingDecision,
    make_router,
    replica_view,
)


@dataclasses.dataclass
class ClusterConfig:
    replicas: int = 2
    router: str = "least_loaded"     # random | least_loaded | affinity
    router_seed: int = 0
    max_queue_per_replica: int = 4   # backpressure threshold
    loader_workers_per_replica: int = 4
    # other hosts' block servers to pull missing blocks from, and the port
    # to serve this cluster's static library on (0: any free port; None:
    # no server)
    peers: Optional[List[str]] = None
    serve_port: Optional[int] = None
    deadline_s: Optional[float] = None   # default Request.deadline_s
    faults: Optional[object] = None      # FaultPlan for every layer
    on_stuck: str = "raise"              # raise | report


class StuckFleetError(RuntimeError):
    """``run`` or ``drain`` ran out of steps with requests still live, or
    every replica is quarantined; ``fleet`` holds
    :meth:`MPICCluster.fleet_state` at that moment."""

    def __init__(self, msg: str, fleet: dict):
        super().__init__(msg)
        self.fleet = fleet


class MPICCluster:
    """N data-parallel ``MPICEngine`` replicas behind one KV library."""

    def __init__(self, model, params, engine_cfg: Optional[EngineConfig] = None,
                 cluster_cfg: Optional[ClusterConfig] = None, *,
                 static_library: Optional[KVLibrary] = None,
                 dynamic_library: Optional[KVLibrary] = None, device=None,
                 mesh=None):
        self.cfg = cluster_cfg or ClusterConfig()
        if self.cfg.replicas < 1:
            raise ValueError(f"replicas {self.cfg.replicas}: need >= 1")
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.faults = self.cfg.faults
        self.static_lib = static_library or KVLibrary(
            faults=self.faults, device=self.device, mesh=mesh)
        self.dynamic_lib = dynamic_library or KVLibrary(shared=True,
                                                        mesh=mesh)
        if self.faults is not None and self.static_lib.faults is None:
            # a library built outside joins the cluster's fault plan
            self.static_lib.faults = self.faults
            self.static_lib.disk.faults = self.faults
        if self.cfg.peers:
            self.static_lib.connect_peers(self.cfg.peers)
        self.peer_server = None
        if self.cfg.serve_port is not None and (mesh is None
                                                or mesh.rank == 0):
            self.peer_server = KVPeerServer(self.static_lib,
                                            port=self.cfg.serve_port)
        self.retriever = Retriever()
        self.loader = ParallelLoader(
            self.static_lib,
            max_workers=self.cfg.loader_workers_per_replica
            * self.cfg.replicas)
        self.router = make_router(self.cfg.router, seed=self.cfg.router_seed)
        self.engines: List[MPICEngine] = [
            MPICEngine(model, params, engine_cfg,
                       static_library=self.static_lib,
                       dynamic_library=self.dynamic_lib,
                       retriever=self.retriever, device=self.device,
                       faults=self.faults, replica_id=i, loader=self.loader,
                       mesh=mesh)
            for i in range(self.cfg.replicas)]
        self._pending: deque = deque()      # held by backpressure
        self.decisions: List[RoutingDecision] = []
        self._rr = 0                        # the replica that steps first
        self._closed = False
        self._quarantined: Dict[int, str] = {}
        self._expired: List[Request] = []   # reaped while pending
        self.requeued = 0                   # requests routed again
        self.stuck_report: Optional[dict] = None

    # -- workflow 1: the libraries and the retriever are shared, so one
    # upload serves every replica
    def upload(self, user_id: str, media_id: str, embeds, *,
               ttl: float = float("inf"), dynamic: bool = False) -> None:
        self.engines[0].upload(user_id, media_id, embeds, ttl=ttl,
                               dynamic=dynamic)

    # -- workflow 2: submit, then route or hold
    def submit(self, request: Request) -> Request:
        if self._closed:
            raise RuntimeError("cluster is draining/closed")
        if request.deadline_s is None and self.cfg.deadline_s is not None:
            request.deadline_s = self.cfg.deadline_s
        self._pending.append(request)
        self._dispatch()
        return request

    # -- sessions: the snapshot lands in the shared library, so a session
    # frozen on one replica thaws on any (and, with peers, on any host)
    def freeze(self, req_id: str, *, spool: bool = False):
        """Freeze a running request wherever it runs."""
        for e in self._healthy():
            if any(r is not None and r.req_id == req_id for r in e.running):
                return e.freeze(req_id, spool=spool)
        raise KeyError(f"freeze: no replica is running {req_id!r}")

    def _slot_capacity(self, need: int) -> MPICEngine:
        """The healthy replica with the most free slots, at least
        ``need``."""
        best, best_free = None, -1
        for e in self._healthy():
            free = sum(1 for r in e.running if r is None)
            if free >= need and free > best_free:
                best, best_free = e, free
        if best is None:
            raise RuntimeError(
                f"no healthy replica has {need} free decode slot(s)")
        return best

    def thaw(self, handle, suffix_tokens=None, *,
             max_new_tokens: Optional[int] = None) -> Request:
        """Resume a frozen session on the replica with the most free
        slots."""
        eng = self._slot_capacity(1)
        req = eng.thaw(handle, suffix_tokens, max_new_tokens=max_new_tokens)
        req.replica = eng.replica_id
        return req

    def fork(self, handle, n: int, *,
             max_new_tokens: Optional[int] = None) -> List[Request]:
        """Fork ``n`` copy-on-write children on one replica (they share
        pool pages, and a pool is one replica's)."""
        eng = self._slot_capacity(n)
        children = eng.fork(handle, n, max_new_tokens=max_new_tokens)
        for r in children:
            r.replica = eng.replica_id
        return children

    def session_handles(self) -> Dict[str, object]:
        """``session_id -> SessionHandle`` over every replica."""
        out: Dict[str, object] = {}
        for e in self.engines:
            out.update(e.sessions.handles)
        return out

    # -- routing
    def _healthy(self) -> List[MPICEngine]:
        return [e for e in self.engines
                if e.replica_id not in self._quarantined]

    def _eligible(self) -> List[MPICEngine]:
        cap = self.cfg.max_queue_per_replica
        return [e for e in self._healthy() if len(e.queue) < cap]

    def _dispatch(self) -> None:
        """Route pending requests onto replicas with queue room; one whose
        deadline passed while it was held is reaped instead.  Under a mesh
        both are rank 0's decisions."""
        while self._pending:
            late = self._pending[0].past_deadline()
            if self._pending[0].deadline_s is not None:
                late = agree(self.mesh, late)
            if late:
                req = self._pending.popleft()
                req.state = State.DEADLINE
                req.error = f"deadline exceeded ({req.deadline_s:.3f}s)"
                self._expired.append(req)
                continue
            eligible = self._eligible()
            if not eligible:
                return                      # backpressure: hold
            req = self._pending.popleft()
            views = [replica_view(e, self.static_lib, req) for e in eligible]
            decision = agree(self.mesh, self.router.route(req, views))
            self.decisions.append(decision)
            req.replica = decision.replica
            self.engines[decision.replica].submit(req)

    # -- stepping: one engine step per healthy replica, the first replica
    # rotating so that none always admits first
    def step(self) -> None:
        self._dispatch()
        n = len(self.engines)
        for i in range(n):
            eng = self.engines[(self._rr + i) % n]
            if eng.replica_id in self._quarantined:
                continue
            if eng.has_work:
                try:
                    eng.step()
                except Exception as exc:
                    if self.mesh is not None and not isinstance(
                            exc, ReplicaCrash):
                        raise
                    self._quarantine(eng, exc)
            self._dispatch()                # freed room is used at once
        self._rr = (self._rr + 1) % n

    def _quarantine(self, eng: MPICEngine, exc: Exception) -> None:
        """Take a crashed replica out of rotation and route everything it
        held again (see :meth:`MPICEngine.drain_for_failover`)."""
        self._quarantined[eng.replica_id] = repr(exc)
        drained = eng.drain_for_failover()
        self.requeued += len(drained)
        self._pending.extend(drained)
        if not self._healthy():
            raise StuckFleetError(
                f"every replica is quarantined (last: replica "
                f"{eng.replica_id}: {exc!r})", self.fleet_state())
        self._dispatch()

    @property
    def _live_work(self) -> bool:
        return bool(self._pending) or any(e.has_work for e in self._healthy())

    def run(self, max_steps: int = 10_000, *,
            on_stuck: Optional[str] = None) -> List[Request]:
        """Step until idle.  Live work after ``max_steps`` raises
        :class:`StuckFleetError` (``on_stuck="report"``, or the config's,
        keeps the snapshot in ``stuck_report`` and returns)."""
        steps = 0
        while self._live_work and steps < max_steps:
            self.step()
            steps += 1
        if self._live_work:
            fleet = self.fleet_state()
            msg = (f"fleet still has live work after {max_steps} steps: "
                   f"{len(self._pending)} pending, "
                   f"{len(self._quarantined)} quarantined replica(s)")
            if (on_stuck or self.cfg.on_stuck) == "raise":
                raise StuckFleetError(msg, fleet)
            self.stuck_report = {"message": msg, **fleet}
        return self.finished

    def drain(self, max_steps: int = 10_000, *,
              on_stuck: Optional[str] = None) -> List[Request]:
        """Accept no more requests and serve everything in flight."""
        self._closed = True
        return self.run(max_steps, on_stuck=on_stuck)

    def fleet_state(self) -> dict:
        """Pending and quarantined counts, and each replica's load, running
        requests and waiting queue."""
        return {
            "pending": len(self._pending),
            "quarantined": dict(self._quarantined),
            "replicas": {
                e.replica_id: {
                    **e.load_info(),
                    "running": [
                        {"req_id": r.req_id, "state": r.state.value,
                         "cur_len": r.cur_len,
                         "tokens": len(r.output_tokens)}
                        for r in e.running if r is not None],
                    "waiting": [r.req_id for r in e.queue],
                }
                for e in self.engines},
        }

    def close(self) -> None:
        """Stop the shared loader's threads and the block server."""
        self._closed = True
        self.loader.close()
        if self.peer_server is not None:
            self.peer_server.close()

    # -- results
    @property
    def pending(self) -> int:
        """Requests held by backpressure."""
        return len(self._pending)

    @property
    def finished(self) -> List[Request]:
        done = [r for e in self.engines for r in e.finished]
        done.sort(key=lambda r: r.t_done)
        return done

    @property
    def failed(self) -> List[Request]:
        return [r for e in self.engines for r in e.failed]

    @property
    def expired(self) -> List[Request]:
        """Requests reaped at their deadline, by the engines or while
        pending."""
        return [r for e in self.engines for r in e.expired] + self._expired

    @property
    def quarantined(self) -> Dict[int, str]:
        """Replica id -> the crash that took it out of rotation."""
        return dict(self._quarantined)

    def report(self) -> dict:
        done = self.finished
        routed: Dict[int, int] = {}
        tiers: Dict[str, int] = {}
        for d in self.decisions:
            routed[d.replica] = routed.get(d.replica, 0) + 1
            for tier, n in d.warmth.items():
                tiers[tier] = tiers.get(tier, 0) + n
        n_media = sum(tiers.values())
        library = self.static_lib.stats()
        out = {
            "replicas": len(self.engines),
            "router": self.router.name,
            "requests": len(done),
            "failed": len(self.failed),
            "expired": len(self.expired),
            "pending": len(self._pending),
            "quarantined": dict(self._quarantined),
            "requeued": self.requeued,
            "total_tokens": sum(len(r.output_tokens) for r in done),
            "routing": {
                "decisions": len(self.decisions),
                "per_replica": routed,
                "media_tiers": tiers,
                "hbm_hit_rate": (tiers.get("hbm", 0) / n_media
                                 if n_media else 0.0),
            },
            "loader_dedup_hits": self.loader.dedup_hits,
            "library": library,
            "per_replica": {e.replica_id: e.report() for e in self.engines},
            "cache_tiers": library.get("tiers", {}),
            "sessions": library.get("sessions", {}),
        }
        if self.peer_server is not None:
            out["peer_server"] = {"address": self.peer_server.address,
                                  **self.peer_server.stats()}
        if done:
            ttfts = [r.ttft for r in done]
            out["mean_ttft_s"] = float(np.mean(ttfts))
            out["p90_ttft_s"] = float(np.percentile(ttfts, 90))
        return out
