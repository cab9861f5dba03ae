"""Peer block transport for the network KV tier (port of the JAX package's
``cache/net.py``; the standard library's HTTP, nothing else).

One host's :class:`~repro_torch.cache.library.KVLibrary` exports its blocks
through a :class:`KVPeerServer`; another host's
:class:`~repro_torch.cache.backends.NetworkBackend` pulls them with a
:class:`PeerTransport`.  The protocol is four verbs on one resource, byte
for byte the JAX package's, so either package's client talks to the
other's server:

    GET    /blocks/<ident>   -> 200 npz body | 404
    HEAD   /blocks/<ident>   -> 200 | 404          (existence probe)
    PUT    /blocks/<ident>   -> 204                (push a block)
    DELETE /blocks/<ident>   -> 204

``<ident>`` is the scope digest (``backends.scope_digest``), which hosts
that share a ``(user, media)`` scope compute alike.  The body is the spool
wire format (``cache/quant.py``).  Response headers carry what the
receiving library needs to admit the block:

    X-Block-Key      content-hash block key (the client re-verifies the body)
    X-Media-Id       media id of the new entry
    X-TTL-Remaining  seconds of TTL left at the serving host ("inf" allowed)
    X-Body-Sha1      SHA-1 of the raw body (transport-level integrity)

Failure contract, which the library's fallback to recompute relies on:
every request has a hard ``timeout_s`` (per socket operation, so it must
cover the time the server takes to serialize a block before it answers);
transient failures (connect refused, timeout, 5xx) get ``retries`` retries
(one by default) under exponential backoff with seeded jitter; a 404 is a
definitive miss and is never retried.  ``PeerTransport`` never raises for
data-plane failures: it returns ``(None, {})``.

Peer health lives above the transport: :class:`PeerBreaker` is a
closed / open / half-open circuit breaker, one per peer in
:class:`~repro_torch.cache.backends.NetworkBackend`.  ``last_status`` says
whether the peer responded at all (any HTTP status, 404 included, counts;
None is a transport-level failure).

``KVPeerServer`` is a daemon-threaded ``ThreadingHTTPServer``: each block
transfer gets its own thread.  ``delay_s`` delays every GET and HEAD;
deterministic failures (blackhole, latency, corrupt body) come from a
:class:`~repro_torch.cache.faults.FaultPlan` on the transport.
"""
from __future__ import annotations

import hashlib
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

_TRANSIENT = (urllib.error.URLError, TimeoutError, ConnectionError, OSError)


class PeerBreaker:
    """Per-peer circuit breaker: closed -> open -> half-open -> closed.

    * **closed**: every request allowed.  A transport failure adds to the
      streak of consecutive failures; ``threshold`` of them open the
      breaker.  Any response (404 and 5xx included) resets the streak.
    * **open**: requests are skipped until ``cooldown_s`` has passed.
    * **half-open**: exactly one probe is admitted; its success closes the
      breaker, its failure opens it for another cooldown.

    Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failure_streak = 0
        self.opened = 0              # times the breaker tripped
        self.skips = 0               # requests short-circuited while open
        self._open_until = 0.0
        self._probing = False        # half-open: one probe in flight

    def allow(self) -> bool:
        """May a request go to this peer now?  Counts a skip when not."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if (self.state == self.OPEN
                    and self._clock() >= self._open_until):
                self.state = self.HALF_OPEN
                self._probing = False
            if self.state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            self.skips += 1
            return False

    def record_success(self) -> None:
        """The peer responded (any HTTP status): close, reset the streak."""
        with self._lock:
            self.state = self.CLOSED
            self.failure_streak = 0
            self._probing = False

    def record_failure(self) -> None:
        """A transport-level failure: add to the streak, and trip at
        ``threshold`` (at once when half-open)."""
        with self._lock:
            self.failure_streak += 1
            self._probing = False
            if (self.state == self.HALF_OPEN
                    or self.failure_streak >= self.threshold):
                if self.state != self.OPEN:
                    self.opened += 1
                self.state = self.OPEN
                self._open_until = self._clock() + self.cooldown_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "failure_streak": self.failure_streak,
                    "opened": self.opened, "skips": self.skips}


class PeerTransport:
    """HTTP client for one peer's block server.

    Thread-safe.  The outcome of a call (``last_retries``,
    ``last_timeouts``, ``last_status``, ``last_sha1_s``), which
    ``NetworkBackend`` reads right after it, is kept per thread: the
    loader's threads share one transport, and a call that began on another
    thread must not reset the status of a call that has just answered, or
    a healthy peer's breaker counts a failure (the JAX package keeps them
    on the object and shows it).
    """

    def __init__(self, address: str, *, timeout_s: float = 2.0,
                 retries: int = 1, backoff_base_s: float = 0.05,
                 jitter_seed: int = 0, faults=None):
        # "host:port" or a full "http://host:port"
        if "://" not in address:
            address = f"http://{address}"
        self.address = address.rstrip("/")
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        self.backoff_base_s = float(backoff_base_s)
        self.faults = faults          # FaultPlan or None
        self._rng = random.Random(jitter_seed)
        self._rng_lock = threading.Lock()
        self._call = threading.local()

    # this thread's last call: retries, timed-out attempts, the HTTP status
    # of its last completed attempt (404 and 5xx included; None when the
    # peer never responded: the breaker's health signal) and the seconds
    # of the body's SHA-1
    last_retries = property(lambda s: getattr(s._call, "retries", 0))
    last_timeouts = property(lambda s: getattr(s._call, "timeouts", 0))
    last_status = property(lambda s: getattr(s._call, "status", None))
    last_sha1_s = property(lambda s: getattr(s._call, "sha1_s", 0.0))

    def _url(self, ident: str) -> str:
        return f"{self.address}/blocks/{urllib.parse.quote(ident, safe='')}"

    def _backoff_s(self, attempt: int) -> float:
        """``base * 2^attempt`` scaled by a seeded draw in [0.5, 1.5)."""
        with self._rng_lock:
            jitter = 0.5 + self._rng.random()
        return self.backoff_base_s * (2 ** attempt) * jitter

    def _request(self, ident: str, method: str, data: bytes = None,
                 headers: Optional[dict] = None):
        """One verb under the timeout and retry policy.  Returns
        ``(status, body, headers)``, or ``(None, None, {})`` once the retry
        budget is spent; a 404 returns at once.

        Fault site ``peer.request``: ``blackhole`` makes the attempt behave
        as an unreachable peer (it waits ``delay_s``, the timeout by
        default, and fails); ``latency`` sleeps ``delay_s`` before a real
        attempt."""
        call = self._call
        call.retries = call.timeouts = 0
        call.status = None
        req = urllib.request.Request(self._url(ident), data=data,
                                     method=method)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        for attempt in range(self.retries + 1):
            rule = (self.faults.check("peer.request", self.address)
                    if self.faults is not None else None)
            if rule is not None and rule.kind == "latency":
                time.sleep(rule.delay_s)
                rule = None
            if rule is not None and rule.kind == "blackhole":
                time.sleep(rule.delay_s or self.timeout_s)
                call.timeouts += 1
            else:
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as resp:
                        call.status = resp.status
                        return resp.status, resp.read(), dict(resp.headers)
                except urllib.error.HTTPError as e:
                    call.status = e.code        # the peer responded
                    if e.code == 404:
                        return 404, None, {}
                    # 5xx and the like: transient, retried below
                except _TRANSIENT as e:
                    if isinstance(e, TimeoutError) or "timed out" in str(e):
                        call.timeouts += 1
            if attempt < self.retries:
                call.retries += 1
                time.sleep(self._backoff_s(attempt))
        return None, None, {}

    def fetch(self, ident: str) -> Tuple[Optional[bytes], dict]:
        """GET a block: ``(body, headers)``, or ``(None, {})`` on a miss,
        a timeout or a body that fails its ``X-Body-Sha1``.  Verifying the
        content hash against ``X-Block-Key`` is the caller's job (it parses
        the payload).  Fault site ``peer.body``: ``corrupt`` flips the
        body's first byte, which the checksum must catch."""
        self._call.sha1_s = 0.0
        status, body, hdrs = self._request(ident, "GET")
        if status != 200 or body is None:
            return None, {}
        if self.faults is not None and body:
            rule = self.faults.check("peer.body", self.address)
            if rule is not None and rule.kind == "corrupt":
                body = bytes([body[0] ^ 0xFF]) + body[1:]
        want = hdrs.get("X-Body-Sha1")
        if want:
            t0 = time.perf_counter()
            got = hashlib.sha1(body).hexdigest()
            self._call.sha1_s = time.perf_counter() - t0
            if got != want:
                return None, {}
        return body, hdrs

    def push(self, ident: str, data: bytes, *, block_key: str = None,
             media_id: str = None, ttl: float = None) -> bool:
        """PUT one block to the peer; True on a 2xx.  The body's checksum
        travels in ``X-Body-Sha1``."""
        headers = {"X-Body-Sha1": hashlib.sha1(data).hexdigest()}
        if block_key:
            headers["X-Block-Key"] = block_key
        if media_id:
            headers["X-Media-Id"] = media_id
        if ttl is not None:
            headers["X-TTL-Remaining"] = repr(float(ttl))
        status, _, _ = self._request(ident, "PUT", data=data,
                                     headers=headers)
        return status in (200, 201, 204)

    def probe(self, ident: str) -> bool:
        """HEAD existence check, no payload transfer."""
        status, _, _ = self._request(ident, "HEAD")
        return status == 200

    def remove(self, ident: str) -> bool:
        """DELETE the block on the peer; True if it acknowledged."""
        status, _, _ = self._request(ident, "DELETE")
        return status in (200, 204)


class DictBlockStore:
    """In-memory block source for a :class:`KVPeerServer`, for tests of
    the network tier on its own; the serving path serves a
    :class:`~repro_torch.cache.library.KVLibrary`, which implements the same
    four methods."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: Dict[str, Tuple[bytes, dict]] = {}

    def export_block(self, ident: str):
        with self._lock:
            return self._blocks.get(ident)

    def admit_block(self, ident: str, data: bytes, headers: dict) -> None:
        with self._lock:
            self._blocks[ident] = (data, dict(headers))

    def delete_block(self, ident: str) -> None:
        with self._lock:
            self._blocks.pop(ident, None)

    def has_block(self, ident: str) -> bool:
        with self._lock:
            return ident in self._blocks


class ReusableThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that a restarted host can rebind on the same
    port: ``SO_REUSEADDR`` is set explicitly, and handler threads are
    daemons, so that a wedged peer read cannot hold the process open."""

    allow_reuse_address = True
    daemon_threads = True

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        super().server_bind()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: ARG002
        pass                            # no stderr line per request

    def _ident(self) -> Optional[str]:
        if not self.path.startswith("/blocks/"):
            return None
        return urllib.parse.unquote(self.path[len("/blocks/"):])

    def _delay(self) -> None:
        if self.server.delay_s:
            time.sleep(self.server.delay_s)

    def do_GET(self):
        ident = self._ident()
        self._delay()
        found = ident and self.server.source.export_block(ident)
        if not found:
            self.send_error(404)
            return
        data, headers = found
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Body-Sha1", hashlib.sha1(data).hexdigest())
        for k, v in headers.items():
            if k.startswith("X-") and k != "X-Body-Sha1":
                self.send_header(k, v)
        self.end_headers()
        # counted before the body goes out, so that a client holding the
        # body always sees its block counted
        with self.server._lock:
            self.server.served_blocks += 1
            self.server.served_bytes += len(data)
        self.wfile.write(data)

    def do_HEAD(self):
        ident = self._ident()
        self._delay()
        if ident and self.server.source.has_block(ident):
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()
        else:
            self.send_error(404)

    def do_PUT(self):
        ident = self._ident()
        if not ident:
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        want = self.headers.get("X-Body-Sha1")
        if want and hashlib.sha1(data).hexdigest() != want:
            self.send_error(400, "body checksum mismatch")
            return
        self.server.source.admit_block(ident, data, dict(self.headers))
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        ident = self._ident()
        if ident:
            self.server.source.delete_block(ident)
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()


class KVPeerServer:
    """Serve one block source (a library or a :class:`DictBlockStore`) to
    peers from a daemon thread; ``close()`` is idempotent.  ``delay_s``
    sleeps that long in every GET and HEAD before answering."""

    def __init__(self, source, *, host: str = "127.0.0.1", port: int = 0,
                 delay_s: float = 0.0):
        self._httpd = ReusableThreadingHTTPServer((host, port), _Handler)
        self._httpd.source = source
        self._httpd.delay_s = delay_s
        self._httpd._lock = threading.Lock()
        self._httpd.served_blocks = 0
        self._httpd.served_bytes = 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def delay_s(self) -> float:
        return self._httpd.delay_s

    @delay_s.setter
    def delay_s(self, value: float) -> None:
        self._httpd.delay_s = value

    def stats(self) -> dict:
        with self._httpd._lock:
            return {"served_blocks": self._httpd.served_blocks,
                    "served_bytes": self._httpd.served_bytes}

    def close(self) -> None:
        """Stop the accept loop, close the listening socket and join the
        server thread; the port is rebindable at once afterwards."""
        try:
            self._httpd.shutdown()
        except Exception:
            pass
        try:
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)
