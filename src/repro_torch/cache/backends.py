"""Storage backends of the tiered KV library (port of the JAX package's
``cache/backends.py``).

Every tier implements one :class:`StorageBackend` contract (``put`` /
``get`` / ``delete`` / ``contains`` / ``stats``) over content-hash block
keys, and :class:`~repro_torch.cache.library.KVLibrary` orchestrates them:
it owns promotion, demotion, pins, TTLs and locking, and no backend holds
policy.

* :class:`MemoryBackend`: resident blocks (tensors on the engine's device)
  and the HBM / host byte budgets.
* :class:`DiskBackend`: the npz spool directory (wire format in
  ``cache/quant.py``, so an int8 block spools as int8).  Writes are atomic
  (a unique ``mkstemp`` file, flushed, then ``os.replace``); reads are
  verified against the content hash in the key, and a corrupt or truncated
  file is unlinked and counted as a miss, never handed out.  After
  ``disk_fail_threshold`` consecutive device-level failures the library
  quarantines the tier (``failure_streak``); a full disk (ENOSPC) is
  counted but never feeds the streak.
* :class:`NetworkBackend`: blocks pulled from peers' libraries over the
  HTTP transport of ``cache/net.py`` (timeout, one retry, checksummed
  bodies, a circuit breaker per peer), so that a host that misses memory
  and disk pulls a peer's block instead of recomputing it.  The body is
  the spool wire format (:func:`payload_to_bytes`).

**Keys.**  ``sha1(stored arrays)[:32] + "-" + sha1(repr(scope))[:8]``: the
content half lets a reader verify the bytes it loaded, the scope half
keeps two users' identical media apart.  The hash covers, per stored array,
its numpy dtype name (``"bfloat16"`` for bf16), ``str`` of its shape tuple
and its C-ordered bytes, exactly as the JAX package hashes its numpy
arrays, so both packages give one block the same key.

Fault sites (``cache/faults.py``): ``disk.read`` and ``disk.write`` in
:class:`DiskBackend`, ``peer.request`` and ``peer.body`` in the transport.

**One spool, many readers.**  The ranks of a tensor-parallel mesh share one
host and one spool directory: rank 0's library owns the files, and every
other rank's :class:`DiskBackend` is a ``reader``, which reads the same
keys and never writes, deletes, sweeps or unlinks a file (not even a
corrupt one or an orphaned ``.tmp``: the owner decides about it).

**Per-replica HBM accounting.**  A library that a cluster's replicas share
records, per block, which replicas hold it warm on their device
(``BlockMetadata.hbm_replicas``, replica -> last use there), and
:meth:`MemoryBackend.demote_replicas` holds each replica to its own
``hbm_capacity``: demoting replica A's hold never evicts replica B's hot
set.
"""
from __future__ import annotations

import abc
import dataclasses
import errno
import hashlib
import io
import os
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.cache.quant import (
    QuantizedKV,
    dtype_name,
    host_array,
    read_spool_meta,
    spool_payload,
    unspool_payload,
)
from repro_torch.cache.net import PeerBreaker, PeerTransport

TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_DISK = "disk"
TIER_NETWORK = "network"

# per-tier load rates (bytes/s) of the analytic transfer plan
# (``transfer.plan_transfers``); real loads go through the backends
# whatever these say.  The host tier is one PCIe Gen5 x16 link a card
# (64 GB/s a direction); disk (3.5 GB/s, an NVMe drive) and network
# (1.25 GB/s, a 10 GbE peer link) are the reference's assumptions, not
# measurements.
TIER_BW = {TIER_HBM: float("inf"), TIER_HOST: 64e9,
           TIER_DISK: 3.5e9, TIER_NETWORK: 1.25e9}


# ---------------------------------------------------------------------------
# payload and metadata
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVPayload:
    """The movable bytes of one KV block: the fp tensors (``k``/``v``),
    the int8 storage (``qk``/``qv``), or both (an int8 block dequantized
    for an fp consumer holds both)."""
    k: Optional[torch.Tensor] = None       # (L, S, Hkv, Dh)
    v: Optional[torch.Tensor] = None
    qk: Optional[QuantizedKV] = None
    qv: Optional[QuantizedKV] = None

    @property
    def nbytes(self) -> int:
        """Resident bytes: both copies count."""
        total = 0
        if self.qk is not None:
            total += self.qk.nbytes + self.qv.nbytes
        if self.k is not None:
            total += self.k.nbytes + self.v.nbytes
        return total

    @property
    def stored_nbytes(self) -> int:
        """Bytes a backend persists: the int8 storage when present."""
        if self.qk is not None:
            return self.qk.nbytes + self.qv.nbytes
        if self.k is not None:
            return self.k.nbytes + self.v.nbytes
        return 0

    def stored_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The tensors that reach the medium, in hash order."""
        if self.qk is not None:
            return (self.qk.q, self.qk.scale, self.qv.q, self.qv.scale)
        return (self.k, self.v)

    def tensors(self):
        """Every resident tensor."""
        out = [t for t in (self.k, self.v) if t is not None]
        for qkv in (self.qk, self.qv):
            if qkv is not None:
                out += [qkv.q, qkv.scale]
        return out

    @property
    def dtype(self) -> Optional[str]:
        if self.k is not None:
            return dtype_name(self.k)
        if self.qk is not None:
            return dtype_name(self.qk.q)
        return None

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        if self.k is not None:
            return tuple(self.k.shape)
        if self.qk is not None:
            return tuple(self.qk.q.shape)
        return None


@dataclasses.dataclass
class BlockMetadata:
    """Per-block bookkeeping the library keeps without the payload; every
    field is written under the library lock."""
    media_id: str
    key: Optional[str] = None          # content-hash block key
    ident: Optional[str] = None        # scope digest
    scope_user: Optional[str] = None
    salt: Optional[str] = None         # a session block's cache salt
    nbytes: int = 0                    # stored bytes (survives a spool)
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    tier: str = TIER_HBM
    pins: int = 0                      # > 0: a consumer reads the tensors
    # replica id -> last use on that replica (per-replica HBM warmth)
    hbm_replicas: Dict = dataclasses.field(default_factory=dict)
    created: float = 0.0
    last_used: float = 0.0
    expires: float = float("inf")


def _digest(payload: KVPayload) -> str:
    h = hashlib.sha1()
    for t in payload.stored_arrays():
        h.update(dtype_name(t).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(host_array(t))
    return h.hexdigest()[:32]


def content_key(payload: KVPayload, scope, salt: Optional[str] = None) -> str:
    """``sha1(stored arrays)[:32]-sha1(scope)[:8]``, the JAX package's key
    for the same bytes and scope.  ``salt`` mixes into the scope half."""
    return f"{_digest(payload)}-{scope_digest(scope, salt)[:8]}"


def scope_digest(scope, salt: Optional[str] = None) -> str:
    """Stable digest of a library scope (``(user_id, media_id)``), not
    ``hash()``, which changes with PYTHONHASHSEED."""
    h = hashlib.sha1(repr(scope).encode())
    if salt:
        h.update(b"\x00" + str(salt).encode())
    return h.hexdigest()[:24]


def verify_payload(payload: KVPayload, key: str) -> bool:
    """True iff the bytes read back hash to the content half of ``key``."""
    return key.split("-")[0] == _digest(payload)


def payload_to_bytes(payload: KVPayload) -> bytes:
    """The spool wire format of a payload, in memory (a network body); a
    payload on the card is copied to the host once, tensor by tensor."""
    buf = io.BytesIO()
    spool_payload(buf, payload)
    return buf.getvalue()


def payload_from_bytes(data: bytes) -> KVPayload:
    """Parse wire bytes into a payload of CPU tensors.  Raises on truncated
    or non-npz input, which callers count as a tier miss."""
    return KVPayload(**unspool_payload(io.BytesIO(data)))


# ---------------------------------------------------------------------------
# the backend contract
# ---------------------------------------------------------------------------

class StorageBackend(abc.ABC):
    """One storage tier behind the KV library.

    * ``put(key, payload, meta=None)``: persist; overwriting is idempotent.
    * ``get(key)``: a :class:`KVPayload` or None.  A corrupt, truncated or
      unreadable block is a counted miss, never a raise.
    * ``delete(key)``: idempotent.  ``contains(key)``: existence probe.
    * ``stats()``: ``hits``/``misses``/``puts``/``deletes``/``bytes_read``/
      ``bytes_written``/``fetch_s`` plus the backend's own counters.

    Thread-safe; a backend locks only its own counters and index.
    """

    name: str = "?"

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {
            "hits": 0, "misses": 0, "puts": 0, "deletes": 0,
            "bytes_read": 0, "bytes_written": 0, "fetch_s": 0.0,
        }

    def _count(self, **kv) -> None:
        with self._lock:
            for k, n in kv.items():
                self.counters[k] = self.counters.get(k, 0) + n

    @abc.abstractmethod
    def put(self, key: str, payload: KVPayload,
            meta: Optional[BlockMetadata] = None) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[KVPayload]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def contains(self, key: str) -> bool: ...

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["backend"] = self.name
        return out


class MemoryBackend(StorageBackend):
    """Resident tier: payloads by key (the library's scope digest), plus
    the byte budgets the library rebalances against (``hbm_capacity``,
    ``host_capacity``)."""

    name = TIER_HBM

    def __init__(self, *, hbm_capacity: int = 2 << 30,
                 host_capacity: int = 16 << 30):
        super().__init__()
        self.hbm_capacity = hbm_capacity
        self.host_capacity = host_capacity
        self._store: Dict[str, KVPayload] = {}

    def put(self, key: str, payload: KVPayload,
            meta: Optional[BlockMetadata] = None) -> None:
        with self._lock:
            self._store[key] = payload
        self._count(puts=1, bytes_written=payload.nbytes)

    def get(self, key: str) -> Optional[KVPayload]:
        with self._lock:
            hit = self._store.get(key)
        if hit is None:
            self._count(misses=1)
            return None
        self._count(hits=1, bytes_read=hit.nbytes)
        return hit

    def delete(self, key: str) -> None:
        with self._lock:
            existed = self._store.pop(key, None) is not None
        if existed:
            self._count(deletes=1)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def demote_replicas(self, metas: Iterable[BlockMetadata],
                        nbytes_of) -> int:
        """For every replica over ``hbm_capacity``, drop its hold on its
        least recently used blocks until it fits; a block whose last hold
        drops falls back to the host tier.  ``nbytes_of(meta)`` gives a
        block's resident bytes.  Returns the holds dropped.  The caller
        holds the library lock (the metadata's only writer)."""
        holders: Dict = {}
        for m in metas:
            for r in m.hbm_replicas:
                holders.setdefault(r, []).append(m)
        dropped = 0
        for r, held in holders.items():
            used = sum(nbytes_of(m) for m in held)
            held.sort(key=lambda m: m.hbm_replicas[r])
            for m in held:
                if used <= self.hbm_capacity:
                    break
                del m.hbm_replicas[r]
                if not m.hbm_replicas:
                    m.tier = TIER_HOST
                used -= nbytes_of(m)
                dropped += 1
        return dropped

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            out["blocks"] = len(self._store)
            out["resident_bytes"] = sum(p.nbytes
                                        for p in self._store.values())
        out["hbm_capacity"] = self.hbm_capacity
        out["host_capacity"] = self.host_capacity
        return out


class DiskBackend(StorageBackend):
    """Spool-directory tier: one npz file per block, named by its key.

    ``spool_dir=None`` makes a private directory under the temp dir at the
    first write.  A read returns CPU tensors; ``verify_s`` counts the
    seconds spent re-hashing what was read (inside ``fetch_s``).
    ``failure_streak`` counts consecutive device-level failures (reads and
    writes; a clean one resets it), which the library's quarantine reads.
    ``reader=True`` (another process owns the directory) makes ``put`` and
    ``delete`` no-ops, sweeps no ``.tmp`` file at construction and leaves a
    corrupt file where it is.
    """

    name = TIER_DISK

    def __init__(self, spool_dir: Optional[str] = None, *, faults=None,
                 reader: bool = False):
        super().__init__()
        self.spool_dir = spool_dir
        self.faults = faults          # FaultPlan (disk.read / disk.write)
        self.reader = reader
        self.failure_streak = 0
        self.counters.update(corrupt=0, io_errors=0, tmp_swept=0,
                             verify_s=0.0)
        if spool_dir is None or reader:
            return
        os.makedirs(spool_dir, exist_ok=True)
        # a crash mid-put leaves `<key>.*.npz.tmp` behind (a final name is
        # only ever made by os.replace, so it is always whole): sweep them
        for fname in os.listdir(spool_dir):
            if fname.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(spool_dir, fname))
                    self.counters["tmp_swept"] += 1
                except OSError:
                    pass

    def path_for(self, key: str) -> Optional[str]:
        if self.spool_dir is None:
            return None
        return os.path.join(self.spool_dir, f"{key}.npz")

    def scan(self):
        """Yield ``(key, path)`` for every whole block file in the spool
        directory, sorted; ``.tmp`` orphans were swept at construction.
        The library's cold-start rehydration reads it."""
        if self.spool_dir is None:
            return
        for fname in sorted(os.listdir(self.spool_dir)):
            if fname.endswith(".npz"):
                yield fname[:-4], os.path.join(self.spool_dir, fname)

    @staticmethod
    def read_meta(path: str) -> Optional[dict]:
        """A block file's ``__meta__`` sidecar, None for a file without
        one; raises on corrupt bytes, so that the rehydration scan can
        unlink the file and go on."""
        return read_spool_meta(path)

    @staticmethod
    def _sidecar(meta: Optional[BlockMetadata]) -> Optional[dict]:
        """The JAX package's ``__meta__`` fields, so its rehydration scan
        can index a file this backend wrote; a session block keeps its salt,
        without which a rehydrated entry answers only unsalted lookups."""
        if meta is None:
            return None
        return {"media_id": meta.media_id, "user_id": meta.scope_user,
                "key": meta.key, "ident": meta.ident, "salt": meta.salt,
                "nbytes": meta.nbytes, "dtype": meta.dtype,
                "shape": list(meta.shape) if meta.shape else None,
                "created": meta.created, "expires": meta.expires}

    def _io_failure(self) -> None:
        with self._lock:
            self.counters["io_errors"] += 1
            self.failure_streak += 1

    def _io_success(self) -> None:
        with self._lock:
            self.failure_streak = 0

    def put(self, key: str, payload: KVPayload,
            meta: Optional[BlockMetadata] = None) -> None:
        """Write atomically; an ``OSError`` is counted and raised, so that
        the library keeps the entry resident.  ENOSPC is counted but kept
        out of the failure streak: a full disk is not a dying one.  A
        reader writes nothing."""
        if self.reader:
            return
        with self._lock:
            if self.spool_dir is None:
                self.spool_dir = tempfile.mkdtemp(prefix="mpic_spool_")
        path = self.path_for(key)
        tmp = None
        try:
            if self.faults is not None:
                rule = self.faults.check("disk.write", path)
                if rule is not None:
                    code = (errno.ENOSPC if rule.kind == "enospc"
                            else errno.EIO)
                    raise OSError(code, f"injected {rule.kind}", path)
            fd, tmp = tempfile.mkstemp(dir=self.spool_dir, prefix=f"{key}.",
                                       suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                spool_payload(f, payload, meta=self._sidecar(meta))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException as exc:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if isinstance(exc, OSError):
                if exc.errno == errno.ENOSPC:
                    self._count(io_errors=1)
                else:
                    self._io_failure()
            raise
        self._io_success()
        self._count(puts=1, bytes_written=payload.stored_nbytes)

    def get(self, key: str) -> Optional[KVPayload]:
        path = self.path_for(key)
        if path is None:
            self._count(misses=1)
            return None
        t0 = time.perf_counter()
        try:
            if self.faults is not None:
                rule = self.faults.check("disk.read", path)
                if rule is not None and rule.kind == "io_error":
                    raise OSError(errno.EIO, "injected io_error", path)
            fields = unspool_payload(path)
        except FileNotFoundError:
            self._count(misses=1)
            return None
        except OSError:
            # a device-level read failure: the file may be whole, so it
            # stays; the caller falls back to the next tier or recompute
            self._io_failure()
            self._count(misses=1)
            return None
        except Exception:
            # truncated zip, bad magic, short read: unlink the junk
            self._corrupt(path)
            return None
        payload = KVPayload(**fields)
        t1 = time.perf_counter()
        if not verify_payload(payload, key):
            self._corrupt(path)
            return None
        t2 = time.perf_counter()
        self._io_success()
        self._count(hits=1, bytes_read=payload.stored_nbytes,
                    fetch_s=t2 - t0, verify_s=t2 - t1)
        return payload

    def _corrupt(self, path: str) -> None:
        if not self.reader:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._count(misses=1, corrupt=1)

    def delete(self, key: str) -> None:
        path = self.path_for(key)
        if path is None or self.reader:
            return
        try:
            os.unlink(path)
        except FileNotFoundError:
            return
        self._count(deletes=1)

    def contains(self, key: str) -> bool:
        path = self.path_for(key)
        return path is not None and os.path.exists(path)

    def stats(self) -> dict:
        out = super().stats()
        out["spool_dir"] = self.spool_dir
        return out


class NetworkBackend(StorageBackend):
    """Peer tier: pull blocks from other hosts' libraries over HTTP.

    One :class:`~repro_torch.cache.net.PeerTransport` per peer, tried in
    order.  The transport bounds every request (timeout, retries under
    seeded backoff, no retry on a 404, checksummed bodies), so the worst
    case is one bounded stall a peer and then a miss: the caller
    recomputes.  Each peer sits behind a
    :class:`~repro_torch.cache.net.PeerBreaker`: ``breaker_threshold``
    consecutive no-responses open it and the peer is skipped
    (``breaker_skips``) until its cooldown lets one probe through.  A 404
    is a response from a live peer and resets the streak.

    Blocks are addressed by scope ``ident``; the content key travels in
    ``X-Block-Key`` and the parsed payload is re-verified against it.
    ``verify_s`` counts the receiving side's SHA-1 seconds (the body's
    checksum and the content hash), inside ``fetch_s``.
    """

    name = TIER_NETWORK

    def __init__(self, peers: Iterable = (), *, faults=None,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 5.0):
        super().__init__()
        self.transports: List = []
        for p in peers:
            t = p if hasattr(p, "fetch") else PeerTransport(p, faults=faults)
            if faults is not None and getattr(t, "faults", None) is None:
                t.faults = faults
            self.transports.append(t)
        self.breakers: Dict[str, PeerBreaker] = {
            t.address: PeerBreaker(threshold=breaker_threshold,
                                   cooldown_s=breaker_cooldown_s)
            for t in self.transports}
        self.counters.update(timeouts=0, retries=0, breaker_skips=0,
                             verify_s=0.0)

    def _admit(self, t) -> bool:
        """May a request go to this peer now?  Counts the skip when not."""
        br = self.breakers.get(t.address)
        if br is None or br.allow():
            return True
        self._count(breaker_skips=1)
        return False

    def _record(self, t) -> None:
        """Feed the transport's outcome to the peer's breaker: any HTTP
        response is health, only a transport-level failure is not."""
        self._count(retries=t.last_retries, timeouts=t.last_timeouts)
        br = self.breakers.get(t.address)
        if br is None:
            return
        if getattr(t, "last_status", None) is not None:
            br.record_success()
        else:
            br.record_failure()

    def put(self, key: str, payload: KVPayload,
            meta: Optional[BlockMetadata] = None) -> None:
        """Push to the first reachable peer (explicit export; serving
        publishes by answering peers' GETs from its own library)."""
        data = payload_to_bytes(payload)
        ttl = (meta.expires - time.time()) if meta is not None else None
        for t in self.transports:
            if not self._admit(t):
                continue
            ok = t.push(key, data, block_key=key, ttl=ttl)
            self._record(t)
            if ok:
                self._count(puts=1, bytes_written=len(data))
                return

    def get(self, key: str) -> Optional[KVPayload]:
        return self.get_with_headers(key, require_key=key)[0]

    def get_with_headers(self, key: str, *, require_key: Optional[str] = None):
        """``(payload, the peer's response headers)``, or ``(None, {})``.
        The payload is verified against ``X-Block-Key`` (or
        ``require_key`` when the peer sends none); an undecodable or
        mismatching body counts against that peer and the next is tried."""
        t0 = time.perf_counter()
        for t in self.transports:
            if not self._admit(t):
                continue
            data, hdrs = t.fetch(key)
            self._record(t)
            self._count(verify_s=getattr(t, "last_sha1_s", 0.0))
            if data is None:
                continue
            try:
                payload = payload_from_bytes(data)
            except Exception:
                continue        # undecodable body: a miss at this peer
            claimed = hdrs.get("X-Block-Key") or require_key
            if claimed:
                t1 = time.perf_counter()
                ok = verify_payload(payload, claimed)
                self._count(verify_s=time.perf_counter() - t1)
                if not ok:
                    continue    # never link bytes that fail their key
            self._count(hits=1, bytes_read=len(data),
                        fetch_s=time.perf_counter() - t0)
            return payload, hdrs
        self._count(misses=1, fetch_s=time.perf_counter() - t0)
        return None, {}

    def delete(self, key: str) -> None:
        for t in self.transports:
            if not self._admit(t):
                continue
            ok = t.remove(key)
            self._record(t)
            if ok:
                self._count(deletes=1)

    def contains(self, key: str) -> bool:
        for t in self.transports:
            if not self._admit(t):
                continue
            ok = t.probe(key)
            self._record(t)
            if ok:
                return True
        return False

    def stats(self) -> dict:
        out = super().stats()
        out["peers"] = [t.address for t in self.transports]
        out["breakers"] = {addr: br.snapshot()
                           for addr, br in self.breakers.items()}
        return out
