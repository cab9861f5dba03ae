"""Supervised multi-process serving fleet, one engine process per host
(port of the JAX package's ``launch/fleet.py``).

Each *host* is its own OS process owning one
:class:`~repro_torch.serving.engine.MPICEngine` and one
:class:`~repro_torch.cache.library.KVLibrary` with a spool directory of
its own, exporting its blocks to the other hosts through a
:class:`~repro_torch.cache.net.KVPeerServer` and taking work over a small
HTTP control plane.  A :class:`FleetSupervisor` spawns the hosts, routes
requests to them and keeps them alive:

* **liveness**: it asks every host's ``GET /health`` each ``heartbeat_s``;
  ``miss_threshold`` misses in a row, or a dead process, make the host
  dead.  The heartbeat carries the engine's ``load_info`` and the
  library's ``{scope digest: tier}`` map, so the affinity router scores a
  remote host as it scores a local replica
  (:func:`~repro_torch.serving.router.heartbeat_view`);
* **recovery**: a dead host's requests go to the hosts alive (seeded
  sampling gives them the same tokens), and the host is started again with
  the same ports and spool directory, so its library rehydrates the spool
  (``KVLibrary(rehydrate=True)``) and it rejoins warm;
* **drain**: SIGTERM or ``POST /drain`` stops admission and finishes the
  work in flight; the host then lingers until ``POST /shutdown``.

Control protocol (JSON, or an npz blob for requests and uploads):

    GET  /health    load, media tiers, drain state, counters
    POST /submit    a request blob (503 while draining)
    POST /upload    an upload blob: precompute and store
    GET  /results   terminal requests not delivered yet
    POST /freeze    {req_id, spool}: snapshot a running session, its handle
    POST /thaw      {handle, suffix?, max_new_tokens?}: resume it here (a
                    missing snapshot is pulled from a peer)
    GET  /sessions  the frozen session handles on this host
    POST /drain     stop admission, finish in-flight work
    POST /shutdown  exit after the current step

The blobs are the JAX package's, byte for byte, so either package's
supervisor and hosts read the other's.  ``/health`` reads only what the
step loop last published (load, results, media map, counters), never the
engine or the library: a host busy in a long step, a spool or a first
kernel load still answers its heartbeat.

Cross-process clocks: ``Request.t_arrival`` is stamped anew when a host
decodes a request (``time.perf_counter`` is per process), so a reported
``ttft`` is the host's: queueing and prefill there.  The supervisor also
records each request's submit-to-result wall time (``latency_s``).

The host runs on the card at the full-width config (``configs.
get_config``) unless ``--device cpu`` asks for the smoke config on the
kernels' plain versions; without a card it exits non-zero.  Every host
builds the same seeded weights (``init(seed=0)``), which is what keeps a
failed-over request's tokens.  A host prints its kernels' launch counts
(``launches=``) next to ``steps=`` whenever they changed while it is idle
and on its exit line, in its log under the supervisor's ``base_dir``.

``python -m repro_torch.launch.fleet --hosts 2 --requests 8 [--device
cpu]`` runs a demo fleet end to end; ``--serve-host`` is the entry point
the supervisor spawns, not for direct use.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

import numpy as np

# torch and the models are imported inside host_main() and the demo, so
# that the module stays light to import


# ---------------------------------------------------------------------------
# wire: an npz blob with a __json__ header field
# ---------------------------------------------------------------------------

def pack_blob(header: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    """``header`` (JSON) and named numpy arrays in one npz blob."""
    wire = {"__json__": np.array(json.dumps(header))}
    for name, a in arrays.items():
        wire[name] = np.ascontiguousarray(a)
    buf = io.BytesIO()
    np.savez(buf, **wire)
    return buf.getvalue()


def unpack_blob(data: bytes):
    """:func:`pack_blob`'s inverse: ``(header, arrays)``."""
    arrays: Dict[str, np.ndarray] = {}
    with np.load(io.BytesIO(data)) as z:
        header = json.loads(str(z["__json__"]))
        for name in z.files:
            if name != "__json__":
                arrays[name] = z[name]
    return header, arrays


def encode_request(req) -> bytes:
    """A request as a blob: the segments' structure in the header, their
    tokens and embeddings as arrays; ``req_id`` and ``seed`` travel as
    they are, so the receiving host replays the same tokens."""
    segs, arrays = [], {}
    for i, s in enumerate(req.prompt.segments):
        segs.append({"kind": s.kind, "length": int(s.length),
                     "media_id": s.media_id})
        if s.tokens is not None:
            arrays[f"tok{i}"] = s.tokens
        if s.embeds is not None:
            arrays[f"emb{i}"] = s.embeds
    header = {"req_id": req.req_id, "user_id": req.prompt.user_id,
              "segments": segs, "policy": req.policy,
              "policy_kwargs": req.policy_kwargs,
              "max_new_tokens": int(req.max_new_tokens),
              "priority": int(req.priority), "seed": int(req.seed),
              "deadline_s": req.deadline_s,
              "session_id": req.session_id,
              "freeze_after": req.freeze_after}
    return pack_blob(header, arrays)


def decode_request(data: bytes):
    """A blob as a new :class:`~repro_torch.serving.request.Request`, its
    ``t_arrival`` this process's clock."""
    from repro_torch.core.segments import Prompt, Segment
    from repro_torch.serving.request import Request
    header, arrays = unpack_blob(data)
    segments = [Segment(kind=d["kind"], length=d["length"],
                        tokens=arrays.get(f"tok{i}"),
                        media_id=d.get("media_id"),
                        embeds=arrays.get(f"emb{i}"))
                for i, d in enumerate(header["segments"])]
    req = Request(prompt=Prompt(segments=segments,
                                user_id=header["user_id"]),
                  max_new_tokens=header["max_new_tokens"],
                  policy=header["policy"],
                  policy_kwargs=dict(header.get("policy_kwargs") or {}),
                  priority=header.get("priority", 0),
                  seed=header.get("seed", 0),
                  deadline_s=header.get("deadline_s"),
                  session_id=header.get("session_id"),
                  freeze_after=header.get("freeze_after"))
    req.req_id = header["req_id"]
    return req


def encode_upload(user_id: str, media_id: str, embeds: np.ndarray, *,
                  ttl: float = float("inf"), dynamic: bool = False) -> bytes:
    header = {"user_id": user_id, "media_id": media_id, "ttl": ttl,
              "dynamic": dynamic}
    return pack_blob(header, {"embeds": np.asarray(embeds)})


# ---------------------------------------------------------------------------
# the engine host (--serve-host)
# ---------------------------------------------------------------------------

class _HostState:
    """What the control handler threads and the step loop share.

    ``lock`` guards the engine (held around ``submit``/``step``, which can
    take seconds, and by the handlers that call the engine); ``qlock``
    guards the inbox, the outbox and the published snapshot, all that
    ``/submit``, ``/health`` and ``/results`` touch, so that they answer at
    once while the engine works.
    """

    def __init__(self, host_id: int):
        self.host_id = host_id
        self.lock = threading.Lock()
        self.qlock = threading.Lock()
        self.engine = None
        self.draining = threading.Event()
        self.shutdown = threading.Event()
        self.steps = 0
        self.seen: set = set()          # accepted req_ids (resubmits dedup)
        self.delivered: set = set()     # req_ids /results has returned
        self.inbox: list = []           # decoded requests for the loop
        self.outbox: Dict[str, dict] = {}   # req_id -> terminal result row
        self.snapshot: dict = {}        # what the step loop last published
        self.publish = None             # host_main's: refresh the snapshot


def _result_row(r, host_id: int, session: Optional[dict] = None) -> dict:
    from repro_torch.serving.request import State
    state = {State.DONE: "done", State.FAILED: "failed",
             State.DEADLINE: "deadline"}.get(r.state, r.state.value)
    row = {"req_id": r.req_id, "state": state, "host": host_id,
           "tokens": [int(t) for t in r.output_tokens],
           "ttft": r.ttft if r.t_first_token else None,
           "n_reused": int(r.prefill_stats.get("n_reused", 0)),
           "error": r.error}
    if session is not None:
        # a frozen request is terminal here; its handle rides the row so
        # that the supervisor can thaw it anywhere
        row["session"] = session
    return row


def _failed_row(req_id: str, host_id: int, error: str) -> dict:
    return {"req_id": req_id, "state": "failed", "host": host_id,
            "tokens": [], "ttft": None, "n_reused": 0, "error": error}


class _CtrlHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: ARG002
        pass

    def _json(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_GET(self):
        st: _HostState = self.server.state
        if self.path == "/health":
            with st.qlock:
                snap = dict(st.snapshot)
                accepted = len(st.seen)
            self._json({
                "host": st.host_id, "pid": os.getpid(),
                "draining": st.draining.is_set(), "steps": st.steps,
                "load": snap.get("load", {}), "media": snap.get("media", {}),
                "rehydrate": st.engine.static_lib.rehydrate_stats,
                "sessions": snap.get("sessions", {}),
                "network": snap.get("network", {}),
                "done": snap.get("done", 0), "accepted": accepted})
        elif self.path == "/sessions":
            with st.lock:
                handles = {sid: h.to_json()
                           for sid, h in st.engine.sessions.handles.items()}
            self._json({"sessions": handles})
        elif self.path == "/results":
            rows = []
            with st.qlock:
                for req_id, row in st.outbox.items():
                    if req_id not in st.delivered:
                        st.delivered.add(req_id)
                        rows.append(row)
            self._json({"results": rows})
        else:
            self.send_error(404)

    def do_POST(self):
        st: _HostState = self.server.state
        if self.path == "/submit":
            data = self._body()
            if st.draining.is_set():
                self._json({"error": "draining"}, status=503)
                return
            try:
                req = decode_request(data)
            except Exception as exc:
                self._json({"error": f"bad request blob: {exc}"}, status=400)
                return
            with st.qlock:
                if req.req_id in st.seen:
                    # a resubmit of a request queued, running or done here
                    self._json({"req_id": req.req_id, "dup": True})
                    return
                st.seen.add(req.req_id)
                st.inbox.append(req)
            self._json({"req_id": req.req_id})
        elif self.path == "/upload":
            try:
                header, arrays = unpack_blob(self._body())
            except Exception as exc:
                self._json({"error": f"bad upload blob: {exc}"}, status=400)
                return
            with st.lock:
                st.engine.upload(header["user_id"], header["media_id"],
                                 arrays["embeds"],
                                 ttl=float(header.get("ttl", float("inf"))),
                                 dynamic=bool(header.get("dynamic")))
                st.publish()            # the media map the router reads
            self._json({"media_id": header["media_id"]})
        elif self.path == "/freeze":
            # spooled by default: a fleet freeze exists to outlive the host
            try:
                body = json.loads(self._body().decode() or "{}")
                req_id = body["req_id"]
            except Exception as exc:
                self._json({"error": f"bad freeze body: {exc}"}, status=400)
                return
            with st.lock:
                try:
                    handle = st.engine.freeze(
                        req_id, spool=bool(body.get("spool", True)))
                except (KeyError, ValueError, RuntimeError) as exc:
                    self._json({"error": str(exc)}, status=409)
                    return
                st.publish()
            self._json({"handle": handle.to_json()})
        elif self.path == "/thaw":
            # a snapshot missing here is pulled from a peer
            from repro_torch.serving.sessions import SessionHandle
            try:
                body = json.loads(self._body().decode() or "{}")
                handle = SessionHandle.from_json(body["handle"])
            except Exception as exc:
                self._json({"error": f"bad thaw body: {exc}"}, status=400)
                return
            if st.draining.is_set():
                self._json({"error": "draining"}, status=503)
                return
            mnt = body.get("max_new_tokens")
            with st.lock:
                try:
                    req = st.engine.thaw(
                        handle, body.get("suffix") or None,
                        max_new_tokens=int(mnt) if mnt is not None else None)
                except Exception as exc:
                    self._json({"error": str(exc)}, status=409)
                    return
                st.publish()
            with st.qlock:
                st.seen.add(req.req_id)
            self._json({"req_id": req.req_id, "session_id": req.session_id})
        elif self.path == "/drain":
            st.draining.set()
            self._json({"draining": True})
        elif self.path == "/shutdown":
            st.shutdown.set()
            self._json({"shutdown": True})
        else:
            self.send_error(404)


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import KERNELS
    return {name: k.launches for name, k in KERNELS.items()}


def host_main(args) -> int:
    """One engine host (``--serve-host``): build the model (the seeded
    weights every host shares), rehydrate the library from the host's
    spool directory, then serve the control plane and the block server
    until drained or shut down.  SIGTERM drains."""
    from repro_torch.cache.library import KVLibrary
    from repro_torch.cache.net import (
        KVPeerServer,
        PeerTransport,
        ReusableThreadingHTTPServer,
    )
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MPICEngine

    device = resolve_device(args.device)
    cfg = (get_config(args.arch) if device.type == "cuda"
           else get_smoke_config(args.arch))
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    lib_kw = {}
    if args.hbm_bytes > 0:
        lib_kw["hbm_capacity"] = args.hbm_bytes
    if args.host_bytes > 0:
        lib_kw["host_capacity"] = args.host_bytes
    lib = KVLibrary(spool_dir=args.spool_dir, rehydrate=True, device=device,
                    **lib_kw)
    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    if peers:
        # no retry: a dead peer must cost less than a heartbeat, and the
        # breaker mutes it after a few misses
        lib.connect_peers([PeerTransport(p, timeout_s=args.peer_timeout_s,
                                         retries=0) for p in peers])
    engine = MPICEngine(model, params, EngineConfig(
        max_seq_len=args.max_seq_len, decode_slots=args.slots,
        freeze_idle_s=args.freeze_idle_s), static_library=lib, device=device)
    peer_server = KVPeerServer(lib, port=args.block_port)

    st = _HostState(args.host_id)
    st.engine = engine

    def publish() -> None:
        """Copy the engine's results, load, the library's media map and
        counters where the handlers read them.  Called with ``st.lock``
        held; takes ``st.qlock`` briefly."""
        rows = [_result_row(r, st.host_id)
                for r in engine.finished + engine.failed + engine.expired]
        for r in engine.frozen:
            h = engine.sessions.handles.get(r.session_id)
            rows.append(_result_row(
                r, st.host_id, session=h.to_json() if h is not None else None))
        stats = lib.stats()
        snapshot = {"load": engine.load_info(), "done": len(rows),
                    "media": lib.ident_tiers(),
                    "sessions": stats.get("sessions", {}),
                    "network": stats["tiers"].get("network", {})}
        with st.qlock:
            for row in rows:
                st.outbox.setdefault(row["req_id"], row)
            st.snapshot = snapshot

    st.publish = publish
    with st.lock:
        publish()           # a heartbeat before the first step reads sense
    ctrl = ReusableThreadingHTTPServer(("127.0.0.1", args.ctrl_port),
                                       _CtrlHandler)
    ctrl.state = st
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: st.draining.set())
    print(f"[host {st.host_id}] up pid={os.getpid()} device={device} "
          f"ctrl={args.ctrl_port} blocks={peer_server.address} "
          f"rehydrated={lib.rehydrate_stats}", flush=True)

    printed: Dict[str, int] = {}
    idle_since = None
    while not st.shutdown.is_set():
        with st.qlock:
            inbox, st.inbox = st.inbox, []
        with st.lock:
            for req in inbox:
                try:
                    engine.submit(req)
                except Exception as exc:        # a prompt too long, say
                    with st.qlock:
                        st.outbox[req.req_id] = _failed_row(
                            req.req_id, st.host_id, str(exc))
            work = engine.has_work
            if work:
                engine.step()
                st.steps += 1
            if work or inbox:
                publish()
        if work:
            idle_since = None
            continue
        launches = _launch_counts()
        if launches != printed:
            print(f"[host {st.host_id}] idle steps={st.steps} "
                  f"launches={json.dumps(launches)}", flush=True)
            printed = launches
        if st.draining.is_set():
            # drained and idle: linger for the supervisor's last /results,
            # then exit on /shutdown or after linger_s
            if idle_since is None:
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since > args.linger_s:
                break
        time.sleep(0.005)

    ctrl.shutdown()
    ctrl.server_close()
    peer_server.close()
    engine.close()
    print(f"[host {st.host_id}] exit steps={st.steps} "
          f"launches={json.dumps(_launch_counts())}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the supervisor: router and process keeper
# ---------------------------------------------------------------------------

@dataclass
class HostSpec:
    """A host's identity; a restart reuses all of it (ports, spool
    directory), which is what makes a warm rejoin possible."""
    host_id: int
    ctrl_port: int
    block_port: int
    spool_dir: str


@dataclass
class FleetHost:
    spec: HostSpec
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"         # starting | up | dead | draining
    misses: int = 0                 # heartbeats missed in a row
    restarts: int = 0
    health: Optional[dict] = None   # the last good heartbeat
    spawned_at: float = 0.0         # monotonic (start-up grace)

    @property
    def ctrl_addr(self) -> str:
        return f"127.0.0.1:{self.spec.ctrl_port}"

    @property
    def block_addr(self) -> str:
        return f"127.0.0.1:{self.spec.block_port}"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class _Inflight:
    data: bytes                     # the encoded request, replayable
    req: object                     # the request (the router's input)
    host: Optional[int] = None      # the host serving it
    t_submit: float = field(default_factory=time.perf_counter)
    resubmits: int = 0
    session: bool = False           # a thawed session: no blob to replay


class FleetSupervisor:
    """Spawn, heartbeat, route, fail over and drain a fleet of engine host
    processes.  One thread: callers drive it with :meth:`pump` or
    :meth:`run_until_done`, so the order of events is deterministic.

    ``device`` is the hosts' (None: the card, which must be there;
    ``"cpu"``: the smoke config on the plain versions).  Each host is a
    fresh interpreter (``python -m repro_torch.launch.fleet
    --serve-host``), never a fork of a process that may hold CUDA.
    ``base_dir`` (a new temporary directory by default) holds each host's
    spool directory and log."""

    def __init__(self, hosts: int = 2, *, arch: str = "llava-1.6-7b",
                 base_dir: Optional[str] = None, router: str = "affinity",
                 heartbeat_s: float = 0.25, miss_threshold: int = 3,
                 auto_restart: bool = True, slots: int = 2,
                 max_seq_len: int = 256, peer_timeout_s: float = 0.5,
                 linger_s: float = 20.0, hbm_bytes: int = 0,
                 host_bytes: int = 0, start_grace_s: float = 180.0,
                 freeze_idle_s: float = 0.0, env: Optional[dict] = None,
                 device=None):
        from repro_torch.device import resolve_device
        from repro_torch.serving.router import make_router
        if hosts < 1:
            raise ValueError(f"hosts {hosts}: need >= 1")
        self.device = resolve_device(device).type
        self.arch = arch
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="mpic_fleet_")
        os.makedirs(self.base_dir, exist_ok=True)
        self.router = make_router(router)
        self.router_name = router
        self.heartbeat_s = heartbeat_s
        self.miss_threshold = miss_threshold
        self.auto_restart = auto_restart
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.peer_timeout_s = peer_timeout_s
        self.linger_s = linger_s
        self.hbm_bytes = hbm_bytes
        self.host_bytes = host_bytes
        self.start_grace_s = start_grace_s
        self.freeze_idle_s = freeze_idle_s
        self._env = env
        self.hosts: List[FleetHost] = []
        for i in range(hosts):
            spool = os.path.join(self.base_dir, f"host{i}", "spool")
            os.makedirs(spool, exist_ok=True)
            self.hosts.append(FleetHost(HostSpec(
                host_id=i, ctrl_port=_free_port(), block_port=_free_port(),
                spool_dir=spool)))
        self.inflight: Dict[str, _Inflight] = {}
        self.pending: deque = deque()   # req_ids waiting for a host
        self.results: Dict[str, dict] = {}
        self.latency_s: Dict[str, float] = {}
        self.requeued = 0               # failover resubmissions
        self.deaths = 0
        self._last_beat = 0.0

    # -- processes ---------------------------------------------------------
    def log_path(self, host_id: int) -> str:
        return os.path.join(self.base_dir, f"host{host_id}.log")

    def _spawn(self, host: FleetHost) -> None:
        spec = host.spec
        peers = ",".join(h.block_addr for h in self.hosts
                         if h.spec.host_id != spec.host_id)
        cmd = [sys.executable, "-m", "repro_torch.launch.fleet",
               "--serve-host", "--host-id", str(spec.host_id),
               "--arch", self.arch, "--device", self.device,
               "--ctrl-port", str(spec.ctrl_port),
               "--block-port", str(spec.block_port),
               "--spool-dir", spec.spool_dir, "--peers", peers,
               "--slots", str(self.slots),
               "--max-seq-len", str(self.max_seq_len),
               "--peer-timeout-s", str(self.peer_timeout_s),
               "--linger-s", str(self.linger_s),
               "--hbm-bytes", str(self.hbm_bytes),
               "--host-bytes", str(self.host_bytes),
               "--freeze-idle-s", str(self.freeze_idle_s)]
        env = dict(os.environ if self._env is None else self._env)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        with open(self.log_path(spec.host_id), "ab") as log:
            host.proc = subprocess.Popen(cmd, env=env, stdout=log,
                                         stderr=log)
        host.state = "starting"
        host.misses = 0
        host.health = None
        host.spawned_at = time.monotonic()

    def start(self, timeout_s: float = 180.0) -> None:
        """Spawn every host and wait until all answer their heartbeat."""
        for h in self.hosts:
            self._spawn(h)
        self.wait_healthy(timeout_s=timeout_s)

    def wait_healthy(self, host_ids=None, *, timeout_s: float = 180.0):
        """Probe until the given hosts (default: all) answer a fresh
        heartbeat; ``TimeoutError`` otherwise.  A host whose process has
        exited fails at once."""
        want = set(host_ids if host_ids is not None
                   else [h.spec.host_id for h in self.hosts])
        ok: set = set()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for h in self.hosts:
                if h.spec.host_id not in want or h.spec.host_id in ok:
                    continue
                if h.proc is not None and h.proc.poll() is not None:
                    raise RuntimeError(
                        f"host {h.spec.host_id} exited {h.proc.returncode} "
                        f"while starting (log: {self.log_path(h.spec.host_id)})")
                hb = self._http("GET", h, "/health", timeout=1.0)
                if hb is not None:
                    h.health, h.misses = hb, 0
                    h.state = "draining" if hb.get("draining") else "up"
                    ok.add(h.spec.host_id)
            if ok == want:
                return
            time.sleep(0.2)
        raise TimeoutError(
            f"hosts {sorted(want)} not healthy after {timeout_s}s "
            f"(states: {[(h.spec.host_id, h.state) for h in self.hosts]})")

    def _host(self, host_id: int) -> FleetHost:
        return self.hosts[host_id]

    def kill_host(self, host_id: int) -> None:
        """``kill -9`` a host; the next heartbeats find it dead, fail its
        work over and restart it, as for a real crash."""
        proc = self._host(host_id).proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

    def restart_host(self, host_id: int, *, wipe_spool: bool = False,
                     timeout_s: float = 180.0) -> None:
        """Restart a host on purpose; ``wipe_spool`` brings it back cold."""
        h = self._host(host_id)
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()
            h.proc.wait(timeout=10)
        if wipe_spool:
            for fname in os.listdir(h.spec.spool_dir):
                try:
                    os.unlink(os.path.join(h.spec.spool_dir, fname))
                except OSError:
                    pass
        h.restarts += 1
        self._spawn(h)
        self.wait_healthy([host_id], timeout_s=timeout_s)

    # -- HTTP ------------------------------------------------------------------
    def _http(self, method: str, host: FleetHost, path: str, *,
              data: Optional[bytes] = None, timeout: float = 2.0):
        """One control call; None on any transport or HTTP failure (the
        heartbeat turns repeated Nones into a death)."""
        req = urllib.request.Request(f"http://{host.ctrl_addr}{path}",
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode() or "{}")
        except Exception:
            return None

    # -- liveness ----------------------------------------------------------------
    def heartbeat(self) -> None:
        """One liveness round over the hosts not dead: a good heartbeat
        refreshes the host's gossip; ``miss_threshold`` misses in a row
        or an exited process make it dead.  A starting host is spared
        misses for ``start_grace_s``."""
        for h in self.hosts:
            if h.state == "dead":
                continue
            exited = h.proc is None or h.proc.poll() is not None
            hb = None if exited else self._http("GET", h, "/health",
                                                timeout=1.0)
            if hb is not None:
                h.health, h.misses = hb, 0
                h.state = "draining" if hb.get("draining") else "up"
                continue
            if (not exited and h.state == "starting"
                    and time.monotonic() - h.spawned_at < self.start_grace_s):
                continue
            h.misses += 1
            if exited or h.misses >= self.miss_threshold:
                self._on_death(h)

    def _on_death(self, host: FleetHost) -> None:
        """A dead host's requests go back to ``pending`` (a thawed session
        fails: it has no blob to replay, the caller thaws its handle
        again), and with ``auto_restart`` the host starts again with the
        same identity."""
        host.state = "dead"
        host.health = None
        self.deaths += 1
        if host.proc is not None and host.proc.poll() is None:
            host.proc.kill()            # a wedged process: finish it
            try:
                host.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        hid = host.spec.host_id
        lost_sessions = []
        for req_id, rec in self.inflight.items():
            if rec.host != hid or req_id in self.results:
                continue
            if rec.session:
                self.results[req_id] = {
                    "req_id": req_id, "state": "failed", "host": hid,
                    "tokens": [], "ttft": None, "n_reused": 0,
                    "error": "host died mid-resume; re-thaw the handle"}
                lost_sessions.append(req_id)
                continue
            rec.host = None
            rec.resubmits += 1
            self.requeued += 1
            if req_id not in self.pending:
                self.pending.append(req_id)
        for req_id in lost_sessions:
            self.inflight.pop(req_id, None)
        if self.auto_restart:
            host.restarts += 1
            self._spawn(host)

    # -- routing -------------------------------------------------------------------
    def _routable(self) -> List[FleetHost]:
        return [h for h in self.hosts
                if h.state == "up" and h.health is not None]

    def _route(self, req) -> Optional[FleetHost]:
        from repro_torch.serving.router import heartbeat_view
        cands = self._routable()
        if not cands:
            return None
        views = [heartbeat_view(h.spec.host_id, h.ctrl_addr, h.health, req)
                 for h in cands]
        return self._host(self.router.route(req, views).replica)

    def submit(self, req, *, host: Optional[int] = None) -> str:
        """Route and post one request (``host=`` pins the choice); one that
        no host can take waits in ``pending`` for a later :meth:`pump`."""
        rec = _Inflight(data=encode_request(req), req=req, host=host)
        self.inflight[req.req_id] = rec
        self._dispatch(req.req_id, rec)
        return req.req_id

    def _dispatch(self, req_id: str, rec: _Inflight) -> None:
        target = (self._host(rec.host) if rec.host is not None
                  else self._route(rec.req))
        if target is None or target.state != "up":
            if req_id not in self.pending:
                self.pending.append(req_id)
            return
        resp = self._http("POST", target, "/submit", data=rec.data,
                          timeout=5.0)
        if resp is None or "error" in resp:
            # the heartbeat decides the host's fate; the request waits
            target.misses += 1
            rec.host = None
            if req_id not in self.pending:
                self.pending.append(req_id)
            return
        rec.host = target.spec.host_id

    def upload(self, user_id: str, media_id: str, embeds, *,
               ttl: float = float("inf"), host: Optional[int] = None,
               dynamic: bool = False) -> int:
        """Upload media to one host: ``host``, or by the SHA-1 of the media
        id over the routable hosts (not ``hash()``, which
        PYTHONHASHSEED changes).  The others reach the block over the peer
        tier; the affinity router steers requests to its owner."""
        cands = self._routable() or [h for h in self.hosts
                                     if h.state != "dead"]
        if not cands:
            raise RuntimeError("no live host to upload to")
        if host is not None:
            target = self._host(host)
        else:
            digest = int(hashlib.sha1(media_id.encode()).hexdigest(), 16)
            target = cands[digest % len(cands)]
        resp = self._http("POST", target, "/upload", timeout=120.0,
                          data=encode_upload(user_id, media_id, embeds,
                                             ttl=ttl, dynamic=dynamic))
        if resp is None or "error" in resp:
            raise RuntimeError(
                f"upload of {media_id} to host {target.spec.host_id} failed")
        return target.spec.host_id

    # -- sessions --------------------------------------------------------------------
    def freeze(self, host_id: int, req_id: str, *, spool: bool = True) -> dict:
        """Freeze a request running on ``host_id``; returns its handle's
        JSON.  Spooled by default, so that the snapshot outlives the
        host."""
        body = json.dumps({"req_id": req_id, "spool": spool}).encode()
        resp = self._http("POST", self._host(host_id), "/freeze", data=body,
                          timeout=120.0)
        if resp is None or "error" in resp:
            raise RuntimeError(
                f"freeze of {req_id!r} on host {host_id} failed: "
                f"{(resp or {}).get('error', 'transport error')}")
        return resp["handle"]

    def thaw(self, host_id: int, handle, *, suffix=None,
             max_new_tokens: Optional[int] = None) -> str:
        """Resume a frozen session on ``host_id`` (a host without the
        snapshot pulls it from a peer); returns the resumed ``req_id``,
        whose result arrives through :meth:`poll`."""
        hj = handle if isinstance(handle, dict) else handle.to_json()
        body = json.dumps({"handle": hj,
                           "suffix": [int(t) for t in (suffix or [])],
                           "max_new_tokens": max_new_tokens}).encode()
        resp = self._http("POST", self._host(host_id), "/thaw", data=body,
                          timeout=120.0)
        if resp is None or "error" in resp:
            raise RuntimeError(
                f"thaw of {hj.get('session_id')!r} on host {host_id} "
                f"failed: {(resp or {}).get('error', 'transport error')}")
        req_id = resp["req_id"]
        self.inflight[req_id] = _Inflight(data=b"", req=None, host=host_id,
                                          session=True)
        return req_id

    def session_handles(self) -> Dict[str, dict]:
        """``session_id -> handle JSON`` over the live hosts."""
        out: Dict[str, dict] = {}
        for h in self.hosts:
            if h.state not in ("up", "draining"):
                continue
            resp = self._http("GET", h, "/sessions", timeout=5.0)
            if resp is not None:
                out.update(resp.get("sessions", {}))
        return out

    # -- results ---------------------------------------------------------------------
    def poll(self) -> int:
        """Collect terminal requests from the live hosts; the first result
        of a request wins.  Returns how many were new."""
        new = 0
        for h in self.hosts:
            if h.state not in ("up", "draining"):
                continue
            resp = self._http("GET", h, "/results", timeout=5.0)
            if resp is None:
                continue
            for row in resp.get("results", []):
                req_id = row["req_id"]
                if req_id in self.results:
                    continue
                self.results[req_id] = row
                rec = self.inflight.pop(req_id, None)
                if rec is not None:
                    self.latency_s[req_id] = time.perf_counter() - rec.t_submit
                if req_id in self.pending:
                    self.pending.remove(req_id)
                new += 1
        return new

    # -- the drive loop -------------------------------------------------------------
    def pump(self) -> None:
        """One round: a heartbeat (every ``heartbeat_s``), the results, then
        the pending requests to whatever host can take them."""
        now = time.monotonic()
        if now - self._last_beat >= self.heartbeat_s:
            self._last_beat = now
            self.heartbeat()
        self.poll()
        for req_id in list(self.pending):
            rec = self.inflight.get(req_id)
            if rec is None:
                self.pending.remove(req_id)
                continue
            if self._routable():
                self.pending.remove(req_id)
                self._dispatch(req_id, rec)

    def run_until_done(self, timeout_s: float = 300.0) -> Dict[str, dict]:
        """Pump until every submitted request has a result."""
        deadline = time.monotonic() + timeout_s
        while self.inflight or self.pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet stuck: {len(self.inflight)} in flight, "
                    f"{len(self.pending)} pending after {timeout_s}s "
                    f"(states: "
                    f"{[(h.spec.host_id, h.state) for h in self.hosts]})")
            self.pump()
            time.sleep(0.02)
        return self.results

    def drain(self, timeout_s: float = 120.0) -> None:
        """Stop admission everywhere, collect the last results, shut every
        host down and reap the processes."""
        for h in self.hosts:
            if h.state in ("up", "draining"):
                self._http("POST", h, "/drain", timeout=2.0)
        if self.inflight or self.pending:
            self.run_until_done(timeout_s=timeout_s)
        for h in self.hosts:
            if h.proc is not None and h.proc.poll() is None:
                self._http("POST", h, "/shutdown", timeout=2.0)
        for h in self.hosts:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=10)
        for h in self.hosts:
            h.state = "dead"

    def stop(self) -> None:
        """Hard stop: ``kill -9`` every live host."""
        for h in self.hosts:
            if h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            h.state = "dead"

    def report(self) -> dict:
        lat = sorted(self.latency_s.values())
        out = {
            "hosts": len(self.hosts),
            "router": self.router_name,
            "completed": len(self.results),
            "failed": sum(1 for r in self.results.values()
                          if r["state"] not in ("done", "frozen")),
            "frozen": sum(1 for r in self.results.values()
                          if r["state"] == "frozen"),
            "deaths": self.deaths,
            "restarts": sum(h.restarts for h in self.hosts),
            "requeued": self.requeued,
        }
        sess: Dict[str, float] = {}
        for h in self.hosts:
            for k, v in ((h.health or {}).get("sessions") or {}).items():
                sess[k] = sess.get(k, 0) + v
        if sess:
            out["sessions"] = sess
        if lat:
            out["mean_latency_s"] = float(np.mean(lat))
            out["p95_latency_s"] = float(lat[int(0.95 * (len(lat) - 1))])
        return out


# ---------------------------------------------------------------------------
# the demo and the entry points
# ---------------------------------------------------------------------------

def run_fleet(*, hosts: int = 2, requests: int = 8,
              arch: str = "llava-1.6-7b", policy: str = "mpic",
              max_new_tokens: int = 8, mpic_k: int = 8,
              router: str = "affinity", deadline_s: Optional[float] = None,
              timeout_s: float = 300.0, freeze_idle_s: float = 0.0,
              max_seq_len: int = 256, device=None) -> dict:
    """Spawn a fleet, upload the media of a synthetic request stream,
    serve it across the processes, drain, print a line per request and
    the report, and return the report (``serve.py --fleet N``).  On the
    card the hosts serve the full-width config with its images of
    ``media_token_len`` tokens (pass a ``max_seq_len`` that holds the
    prompts); on the CPU the smoke config with 24-token images."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import image_embeds, make_dialogues
    from repro_torch.device import resolve_device
    from repro_torch.serving.request import Request

    on_card = resolve_device(device).type == "cuda"
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    media_len = cfg.media_token_len if on_card else 24
    fleet = FleetSupervisor(hosts, arch=arch, router=router,
                            max_seq_len=max_seq_len,
                            freeze_idle_s=freeze_idle_s, device=device)
    try:
        print(f"starting {hosts} engine host(s)…", flush=True)
        fleet.start()
        dialogues = make_dialogues(n=requests, n_images=2,
                                   d_model=cfg.d_model, media_len=media_len,
                                   style="mmdu", user_id="u1")
        seen = set()
        for d in dialogues:
            for mid in d.media_ids:
                if mid not in seen:
                    fleet.upload("u1", mid, image_embeds(mid, media_len,
                                                         cfg.d_model))
                    seen.add(mid)
        policies = [p.strip() for p in policy.split(",") if p.strip()]
        for i, d in enumerate(dialogues):
            pol = policies[i % len(policies)]
            kw = {"k": mpic_k} if pol == "mpic" else {}
            fleet.submit(Request(prompt=d.prompt,
                                 max_new_tokens=max_new_tokens, policy=pol,
                                 policy_kwargs=kw, deadline_s=deadline_s))
        fleet.run_until_done(timeout_s=timeout_s)
        fleet.drain()
        rep = fleet.report()
        for req_id in sorted(fleet.results,
                             key=lambda r: int(r[3:]) if r[3:].isdigit()
                             else 0):
            row = fleet.results[req_id]
            print(f"  {req_id}: host={row['host']} state={row['state']} "
                  f"ttft={(row.get('ttft') or 0) * 1e3:7.0f} ms "
                  f"reused={row['n_reused']:4d} "
                  f"tokens={len(row['tokens'])}")
        for k, v in rep.items():
            print(f"  {k}: {v}")
        return rep
    finally:
        fleet.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve-host", action="store_true",
                    help="internal: run as one engine host (spawned by the "
                         "supervisor)")
    ap.add_argument("--device", default=None,
                    help="'cpu' serves the smoke config on the plain "
                         "PyTorch path; default: the card, at full width")
    # the host's
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--arch", default="llava-1.6-7b")
    ap.add_argument("--ctrl-port", type=int, default=0)
    ap.add_argument("--block-port", type=int, default=0)
    ap.add_argument("--spool-dir", default=None,
                    help="the host's spool directory (default: a new "
                         "temporary one)")
    ap.add_argument("--peers", default="",
                    help="comma-separated host:port peer block servers")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--peer-timeout-s", dest="peer_timeout_s", type=float,
                    default=0.5)
    ap.add_argument("--linger-s", dest="linger_s", type=float, default=20.0)
    ap.add_argument("--hbm-bytes", dest="hbm_bytes", type=int, default=0,
                    help=">0: the host library's HBM budget")
    ap.add_argument("--host-bytes", dest="host_bytes", type=int, default=0,
                    help=">0: the host library's host budget (small values "
                         "spool media KV to the host's disk)")
    ap.add_argument("--freeze-idle-s", dest="freeze_idle_s", type=float,
                    default=0.0,
                    help=">0: spool frozen session snapshots idle this "
                         "many seconds")
    # the demo's
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--policy", default="mpic")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--mpic-k", type=int, default=8)
    ap.add_argument("--router", default="affinity",
                    choices=["random", "least_loaded", "affinity"])
    ap.add_argument("--deadline-s", type=float, default=None)
    args = ap.parse_args()
    if args.serve_host:
        if args.spool_dir is None:
            args.spool_dir = tempfile.mkdtemp(prefix="mpic_fleet_host_")
        return host_main(args)
    run_fleet(hosts=args.hosts, requests=args.requests, arch=args.arch,
              policy=args.policy, max_new_tokens=args.max_new_tokens,
              mpic_k=args.mpic_k, router=args.router,
              deadline_s=args.deadline_s, max_seq_len=args.max_seq_len,
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
