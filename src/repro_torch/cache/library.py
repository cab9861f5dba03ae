"""Static and dynamic KV libraries, a tier orchestrator over memory, disk
and peers (port of the JAX package's ``cache/library.py``).

The **static library** holds the KV of user-uploaded files, scoped per user
(user A cannot link user B's cache).  The **dynamic library** holds the
MRAG corpus, shared under the ``"*"`` scope.  The bytes live in
:mod:`~repro_torch.cache.backends` tiers,

    memory (hbm / host)  <->  disk (npz spool)  <->  network (peer pull)

and the library owns the policy: content-hash block keys, promotion on a
hit, demotion under pressure, pins, TTL expiry, and the per-tier hit,
promote and demote counters of :meth:`KVLibrary.stats`.  The memory tier
holds an entry under its scope digest; the content key, which names and
verifies a spool file, is computed at the entry's first spool, so a
library that never spools never copies its blocks to the host to hash
them.

**Where the tensors are.**  A resident entry's tensors live where ``put``
got them: on the engine's device (the card, or the CPU when the engine was
asked for it).  ``hbm`` and ``host`` are byte budgets over resident
entries, as in the JAX package, and moving between them moves no bytes;
only a spool to disk frees an entry's tensors.  A disk read brings the
block back to its entry's device: on the card through pinned host memory
on the library's own copy stream, waited on by the reading thread, so the
copy never queues behind the engine's kernels on the default stream.  A
consumer calls :meth:`Entry.wait_loaded` on its own thread before it reads
the tensors (the linker does): the tensors are recorded on its stream, so
the caching allocator cannot hand their blocks back to the copy stream
while the consumer's kernels read them.

``quantize=True`` stores int8 (``cache/quant.py``): half the bytes of
bf16, on the device and on disk.  An fp consumer dequantizes lazily
through ``Entry.k``/``Entry.v`` (counted in ``dequants``); the int8 pool
links the int8 bytes directly (``note_direct_link``).

**Locking** (the JAX package's model):

* ``KVLibrary._lock`` (RLock) guards the entry map, all metadata and the
  pin counts.
* ``Entry._mlock`` serializes materialization of one entry, so that N
  loader workers fetching one block do one disk read.
* Code may take ``_lock`` while holding ``_mlock``; nothing **blocks** on
  ``_mlock`` while holding ``_lock`` (``_spool`` and ``_evict`` do not
  wait for it).  A disk read therefore never holds the library lock.

**Cold start.**  ``rehydrate=True`` re-indexes the spool directory at
construction (:meth:`KVLibrary.rehydrate_spool`): every block file with a
``__meta__`` sidecar comes back as a disk-tier entry without its payload,
whose first lookup is a verified disk read.  Files written by the JAX
package's library rehydrate too, and the other way round.

**Peers.**  ``peers=`` (or :meth:`KVLibrary.connect_peers`) adds the
network tier: a scope with no local entry is asked of the peers'
:class:`~repro_torch.cache.net.KVPeerServer` instances, and a verified pull
becomes a local entry (``_network_admit``), copied to ``device`` (None
means the card) through the copy stream a disk read takes.
:meth:`KVLibrary.register_remote` plants a payload-less network-tier entry
that the loader pulls like a disk block.  The library is itself a peer
server's block source (``export_block`` / ``admit_block`` /
``delete_block`` / ``has_block``): a resident block is serialized from
wherever it lives, hashing its content key first if it never spooled, and
a spooled one is served from its file.

**Faults.**  ``faults=`` threads a ``FaultPlan`` (``cache/faults.py``)
into the disk and network tiers and the loader.  ``disk_fail_threshold``
consecutive device-level disk failures quarantine the disk tier: spooling
stops, reads skip it, and the library serves from memory and peers until
:meth:`KVLibrary.reinstate_disk`.

**Sessions.**  A frozen session's snapshot (``serving/sessions.py``) is a
block like any other, stored under a per-session ``salt`` that mixes into
its content key and its scope digest, so the spool file's name and the
peers' address both need the salt: a lookup with another salt (or none) is
a miss, here and on every peer.  ``put(raw=True)`` keeps an fp snapshot's
bytes in a ``quantize=True`` library, and ``put(qk=, qv=)`` stores an int8
snapshot as it is.  ``stats()["sessions"]`` counts freezes, thaws and forks
(:meth:`KVLibrary.note_session`) beside the live copy-on-write gauges of
the engines' pools (:meth:`KVLibrary.add_session_source`).

**Replicas.**  A cluster's replicas share one library
(``serving/cluster.py``), and each replica is its own device: a
``get(..., replica=r)`` marks the entry warm on replica ``r``
(``BlockMetadata.hbm_replicas``), each replica's holdings are held to
``hbm_capacity`` on their own (:meth:`MemoryBackend.demote_replicas`), and
:meth:`KVLibrary.touch` marks a block that another replica's fetch
brought in.  The affinity router reads :meth:`KVLibrary.warmth` (and
``peek_tier(..., replica=)``); a fleet host gossips
:meth:`KVLibrary.ident_tiers` in its heartbeat.  Without ``replica`` every
call keeps the single-engine accounting.

**Tensor parallelism.**  Under a mesh (``KVLibrary(mesh=)``, and
:meth:`KVLibrary.attach_mesh`, which a mesh engine calls) every rank of
the world (both axes of a ``data x model`` mesh) holds the same whole
entries, and world rank 0 ("rank 0" below) decides every outcome that
reads a clock, a disk or a peer.  Rank 0's library is an ordinary one: it
rehydrates, expires, spools, quarantines, pulls and writes the files.
Every other rank's is a follower, which decides nothing on its own: its
disk tier reads rank 0's spool directory and never writes, sweeps or
unlinks a file in it, it rehydrates nothing, pulls from no peer, expires
nothing by its own clock and demotes nothing by its own budget.  A library
given ``mesh=`` takes that role when it is built, before it touches the
spool; one attached later only from then on.  Two calls on the engine's
thread (never on a loader worker) carry rank 0's outcomes to the others:

* :meth:`KVLibrary.sync` (every engine step and upload) broadcasts the
  placement of the entries that rank 0 changed since the last sync (all
  of them at the first), which a follower mirrors: a block rank 0 spooled
  drops its tensors and takes rank 0's content key, a block rank 0
  dropped goes, a spooled block the follower lacks is indexed from rank
  0's file.  A step that changed nothing broadcasts an empty change log.
* :meth:`KVLibrary.agree` (each lookup a request consumes) broadcasts rank
  0's hit or miss.  A follower that hit where rank 0 missed drops its hit;
  one that missed where rank 0 hit reads rank 0's file (rank 0 writes one
  first for a block it pulled from a peer).  The ranks then sum a flag: if
  one rank could not follow, every rank raises :class:`RankDivergence`
  together, so that no rank recomputes alone and no collective is left
  waiting.
"""
from __future__ import annotations

import errno
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.cache.backends import (
    TIER_DISK,
    TIER_HBM,
    TIER_HOST,
    TIER_NETWORK,
    BlockMetadata,
    DiskBackend,
    KVPayload,
    MemoryBackend,
    NetworkBackend,
    content_key,
    payload_to_bytes,
    scope_digest,
)
from repro_torch.cache.quant import QuantizedKV, dequantize_kv, quantize_kv
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import agree

__all__ = ["TIER_HBM", "TIER_HOST", "TIER_DISK", "TIER_NETWORK", "Entry",
           "KVLibrary", "RankDivergence"]


class RankDivergence(RuntimeError):
    """A rank of a mesh could not follow rank 0's outcome of a lookup (its
    read of rank 0's spool file failed, or rank 0 holds the block in no
    file); every rank raises it together."""


class _Placement(NamedTuple):
    """Rank 0's view of one entry, which the other ranks mirror."""
    tier: str
    resident: bool
    key: Optional[str]
    nbytes: int
    replicas: tuple
    ident: Optional[str]
    salt: Optional[str]
    media_id: str
    scope_user: Optional[str]
    dtype: Optional[str]
    shape: Optional[tuple]
    created: float
    expires: float


class Entry:
    """One KV block: metadata, and its payload while resident.

    ``payload.k is None and payload.qk is None`` means the block lives
    only on disk or on a peer.  Residency checks read the payload fields:
    the ``k``/``v`` getters dequantize int8 storage as a side effect.
    Reading the tensors across a release of the library lock needs a pin
    (``get(pin=True)`` / ``try_pin``), or a spool may free them.
    """

    def __init__(self, media_id: str, *, created: float, expires: float,
                 device: torch.device):
        self.payload = KVPayload()
        self.meta = BlockMetadata(media_id=media_id, created=created,
                                  last_used=created, expires=expires)
        self.device = device          # where a tier read brings the block
        self._owner: Optional["KVLibrary"] = None
        self._mlock = threading.Lock()
        # set by a disk or peer read onto the card: the tensors were
        # allocated on the library's copy stream
        self._on_copy_stream = False
        self._pulled = False          # its bytes came from a peer

    qk = property(lambda s: s.payload.qk)
    qv = property(lambda s: s.payload.qv)
    tier = property(lambda s: s.meta.tier,
                    lambda s, x: setattr(s.meta, "tier", x))
    last_used = property(lambda s: s.meta.last_used,
                         lambda s, x: setattr(s.meta, "last_used", x))
    expires = property(lambda s: s.meta.expires)
    pins = property(lambda s: s.meta.pins)

    @property
    def nbytes(self) -> int:
        """Resident bytes (both copies of a dequantized int8 block), or the
        stored size once spooled."""
        return self.payload.nbytes or self.meta.nbytes

    def _lazy_kv(self) -> KVPayload:
        """Dequantize the int8 payload into the fp copy at the first
        ``.k``/``.v`` read, so that int8 consumers never pay for it."""
        with self._mlock:
            if self.payload.k is None and self.payload.qk is not None:
                self.wait_loaded()
                self.payload.k = dequantize_kv(self.payload.qk)
                self.payload.v = dequantize_kv(self.payload.qv)
                if self._owner is not None:
                    self._owner._note_dequant()
        return self.payload

    @property
    def k(self) -> torch.Tensor:
        """The fp KV (dequantized lazily from int8 storage)."""
        if self.payload.k is None and self.payload.qk is not None:
            return self._lazy_kv().k
        return self.payload.k

    @property
    def v(self) -> torch.Tensor:
        if self.payload.v is None and self.payload.qv is not None:
            return self._lazy_kv().v
        return self.payload.v

    def wait_loaded(self) -> None:
        """Record a disk or peer read's tensors on the calling thread's
        current stream, so that a spool cannot free them to the copy stream
        while that stream's kernels read them.  The reading thread already
        waited for the copy.  A no-op for blocks that never came from disk
        or a peer, and on the CPU."""
        if not self._on_copy_stream:
            return
        stream = torch.cuda.current_stream(self.device)
        for t in self.payload.tensors():
            t.record_stream(stream)

    def materialize(self) -> "Entry":
        """Make the tensors resident, reading the disk or network tier if
        needed (int8 stays int8).  Concurrent callers serialize on
        ``_mlock``, so one read serves them all.  Raises
        ``FileNotFoundError`` when every lower tier misses: the caller
        recomputes."""
        with self._mlock:
            self._materialize_locked()
        return self

    def _materialize_locked(self) -> None:
        if (self.tier in (TIER_DISK, TIER_NETWORK)
                and self.payload.k is None and self.payload.qk is None):
            self._owner._fetch_into(self)
            # resident again: the host budget sees it, and a rebalance may
            # spool it once more under pressure
            self.tier = TIER_HOST


class KVLibrary:
    """Tiered, scoped KV store: memory <-> disk <-> peers behind one
    policy.

    ``spool_dir`` None gives a private spool directory made at the first
    spool.  The backends are public (``memory``, ``disk``, ``network``)
    for their counters; every change goes through the library.
    ``rehydrate=True`` re-indexes ``spool_dir`` now (``rehydrate_stats``
    holds the counts).  Blocks that ``put`` stores live on their tensors'
    device; a rehydrated block's disk read and a block pulled from a peer
    land on ``device`` (None means the card).  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ServingMesh`) gives a rank other than
    0 the follower's role from the start: its disk tier sweeps and unlinks
    nothing and it does not rehydrate (rank 0 does; the first
    :meth:`sync` indexes rank 0's blocks).
    """

    def __init__(self, *, hbm_capacity: int = 2 << 30,
                 host_capacity: int = 16 << 30,
                 spool_dir: Optional[str] = None,
                 default_ttl: float = float("inf"),
                 shared: bool = False, quantize: bool = False,
                 peers: Optional[List] = None, faults=None,
                 disk_fail_threshold: int = 3,
                 rehydrate: bool = False, device=None, mesh=None):
        self.mesh = mesh              # or attach_mesh
        self.quantize = quantize
        self.default_ttl = default_ttl
        self.shared = shared
        self.faults = faults          # FaultPlan, threaded into every tier
        self.device = device          # where pulled and rehydrated blocks go
        self.memory = MemoryBackend(hbm_capacity=hbm_capacity,
                                    host_capacity=host_capacity)
        self.disk = DiskBackend(spool_dir, faults=faults,
                                reader=self._follower)
        self.disk_fail_threshold = disk_fail_threshold
        self._disk_quarantined = False  # sticky until reinstate_disk
        self.network: Optional[NetworkBackend] = None
        if peers:
            self.connect_peers(peers)
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, str], Entry] = {}
        self._by_ident: Dict[str, Tuple[str, str]] = {}
        self._pushed: Dict[str, Tuple[bytes, dict]] = {}  # peers' PUTs
        self._listeners: List[Callable] = []
        self._clock = threading.Lock()          # counters only
        self._tiers = {t: {"hits": 0, "promotes": 0, "demotes": 0}
                       for t in (TIER_HBM, TIER_HOST, TIER_DISK,
                                 TIER_NETWORK)}
        self._misses = 0
        self._dequants = 0          # lazy int8 -> fp expansions
        self._direct_links = 0      # blocks linked from their int8 bytes
        self._spool_failures = 0
        self._enospc = 0
        # disk and peer reads' staging and copy to the card, by tier
        self._copy_s = {TIER_DISK: 0.0, TIER_NETWORK: 0.0}
        self._copy_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._session_ctr = {"freezes": 0, "thaws": 0, "forks": 0}
        self._session_sources: List[Callable[[], Dict[str, int]]] = []
        self._attached = None         # the mesh of the first sync
        # the keys whose placement this rank changed since the last sync
        # (None: every key, or not attached yet): rank 0 sends them; a
        # follower puts them back as rank 0 last placed them (its own disk
        # read makes a block resident that rank 0 holds on disk)
        self._dirty: Optional[set] = None
        # a follower: rank 0's last placement of each key, and the
        # demotions it could not mirror yet (the entry pinned or being
        # read), retried at each sync
        self._placed: Dict[Tuple[str, str], _Placement] = {}
        self._unmirrored: Dict[Tuple[str, str], _Placement] = {}
        self.rehydrate_stats: Dict[str, int] = {}
        if rehydrate and not self._follower:
            self.rehydrate_stats = self.rehydrate_spool(device)

    def connect_peers(self, peers: List, **net_kwargs) -> None:
        """Enable the network tier over ``peers``: ``host:port`` addresses
        of other hosts' ``KVPeerServer`` instances, or ready transports;
        replaces the current peer set.  ``net_kwargs`` go to :class:`NetworkBackend`
        (breaker threshold and cooldown); the library's fault plan rides
        along."""
        net_kwargs.setdefault("faults", self.faults)
        self.network = NetworkBackend(peers, **net_kwargs)

    def _disk_ok(self) -> bool:
        """Is the disk tier usable?  ``disk_fail_threshold`` consecutive
        device-level failures quarantine it, and the flag stays until
        :meth:`reinstate_disk`, so that a flapping disk cannot
        oscillate.  A follower rank reads what rank 0's outcomes send it
        to read: rank 0's quarantine stops rank 0's spools, which the
        follower mirrors."""
        if self._follower:
            return True
        if self._disk_quarantined:
            return False
        if self.disk.failure_streak >= self.disk_fail_threshold:
            self._disk_quarantined = True
            return False
        return True

    def reinstate_disk(self) -> None:
        """Clear the disk quarantine (after the disk was repaired)."""
        self._disk_quarantined = False
        self.disk.failure_streak = 0

    def add_invalidation_listener(self, fn: Callable) -> None:
        """Call ``fn(user_id, media_id)`` (outside the lock) whenever
        :meth:`put` replaces an entry: the loader drops its in-flight
        fetch of the old block."""
        with self._lock:
            self._listeners.append(fn)

    def _count(self, tier: str, what: str, n: int = 1) -> None:
        with self._clock:
            self._tiers[tier][what] += n

    def _note_dequant(self) -> None:
        with self._clock:
            self._dequants += 1

    def note_direct_link(self, n: int = 1) -> None:
        """Consumers report blocks linked straight from their int8 bytes
        (``PagedKVPool.link_write_q8``)."""
        with self._clock:
            self._direct_links += n

    def note_session(self, **events: int) -> None:
        """Count session events (``freezes``, ``thaws``, ``forks``) for
        ``stats()["sessions"]``."""
        with self._clock:
            for name, n in events.items():
                self._session_ctr[name] = self._session_ctr.get(name, 0) + n

    def add_session_source(self, fn: Callable[[], Dict[str, int]]) -> None:
        """Register a live gauge for ``stats()["sessions"]``: an engine's
        pool gives its ``cow_copies`` and ``pages_shared``; several sources
        sum by key."""
        with self._clock:
            self._session_sources.append(fn)

    def _key(self, user_id: str, media_id: str) -> Tuple[str, str]:
        return ("*", media_id) if self.shared else (user_id, media_id)

    @property
    def _follower(self) -> bool:
        """A rank of a mesh other than rank 0: it follows rank 0."""
        m = self.mesh
        return m is not None and m.world > 1 and m.rank != 0

    def _mark(self, *keys) -> None:
        """These keys' placement changed on this rank (for the next
        :meth:`sync`)."""
        if self._dirty is not None and self.mesh is not None:
            self._dirty.update(keys)

    def _live(self, e: Entry, now: Optional[float] = None) -> bool:
        """Is ``e`` unexpired?  A follower's clock decides nothing: rank
        0's expiries reach it through :meth:`sync` and :meth:`agree`."""
        return self._follower or (time.time() if now is None
                                  else now) <= e.expires

    # -- the API ---------------------------------------------------------------
    def put(self, user_id: str, media_id: str, k=None, v=None, *,
            ttl: Optional[float] = None, salt: Optional[str] = None,
            raw: bool = False, qk: Optional[QuantizedKV] = None,
            qv: Optional[QuantizedKV] = None) -> Entry:
        """Store one media KV block (L, S, Hkv, Dh), replacing any block
        under the scope; ``quantize=True`` stores int8, unless ``raw``.
        ``qk``/``qv`` store an already-quantized payload as it is.
        ``salt`` (a session's cache salt) mixes into the block's content key
        and scope digest; only a lookup with the same salt finds it.
        Quantizing runs outside the lock, the swap and rebalance inside it,
        the invalidation listeners after it.  No bytes are hashed here: the
        content key waits for the first spool.  The returned entry is not
        pinned."""
        now = time.time()
        expires = now + (self.default_ttl if ttl is None else ttl)
        if qk is not None:
            e = Entry(media_id, created=now, device=qk.q.device,
                      expires=expires)
            e.payload.qk, e.payload.qv = qk, qv
        else:
            k, v = torch.as_tensor(k), torch.as_tensor(v)
            e = Entry(media_id, created=now, device=k.device,
                      expires=expires)
            if self.quantize and not raw:
                e.payload.qk, e.payload.qv = quantize_kv(k), quantize_kv(v)
            else:
                e.payload.k, e.payload.v = k, v
        key = self._key(user_id, media_id)
        m = e.meta
        m.ident = scope_digest(key, salt)
        m.salt = salt
        m.scope_user = key[0]
        m.dtype, m.shape = e.payload.dtype, e.payload.shape
        e._owner = self
        with self._lock:
            # a put over a live key evicts the old entry, or its spool file
            # would be orphaned
            replaced = key in self._entries
            if replaced:
                self._evict(key)
            self._entries[key] = e
            self._by_ident[m.ident] = key
            self.memory.put(m.ident, e.payload, m)
            self._mark(key)
            self._rebalance()
        if replaced:
            for fn in list(self._listeners):
                fn(user_id, media_id)
        return e

    def get(self, user_id: str, media_id: str, *, replica=None,
            pin: bool = False,
            salt: Optional[str] = None) -> Optional[Entry]:
        """Lookup honouring scope and expiry.  The lock covers the lookup
        only; a disk read or a peer pull runs outside it, so loader workers
        fetch different entries at once.  A scope with no local entry is
        asked of the peers when there are any (a verified pull becomes a
        local entry).  ``pin`` holds the tensors against a spool until
        :meth:`unpin`.  ``replica`` marks the entry warm on that cluster
        replica (its link copies the KV to that replica's device).  A miss
        on every lower tier (file gone, corrupt or
        unreadable; peers missing or down) drops the entry and returns
        None: the caller recomputes.  ``salt`` must be the stored block's
        (None for a block stored without one); another is a miss, locally
        and on the peers, whose address the salt is part of."""
        key = self._key(user_id, media_id)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and not self._live(e):
                self._evict(key)
                e = None
            if e is not None and e.meta.salt != salt:
                e = None            # another session's block: a miss
            if e is not None:
                e.last_used = time.time()
                hit_tier = e.tier
        if e is None:
            e = self._network_admit(user_id, media_id, salt)
            if e is None:
                with self._clock:
                    self._misses += 1
                return None
            hit_tier = TIER_NETWORK
        self._count(hit_tier, "hits")
        was_slow = hit_tier in (TIER_DISK, TIER_NETWORK)
        try:
            e.materialize()
            if was_slow or replica is not None or pin:
                # holding _mlock keeps the non-blocking _spool off the entry
                # we hand out; a spool in the gap after materialize is
                # undone by the reload
                with e._mlock:
                    e._materialize_locked()
                    with self._lock:
                        if pin:
                            e.meta.pins += 1
                        changed = was_slow
                        if was_slow or replica is not None:
                            self._mark(key)
                        if replica is not None:
                            fresh = (replica not in e.meta.hbm_replicas
                                     or e.tier != TIER_HBM)
                            if fresh:
                                self._count(TIER_HOST, "promotes")
                            changed |= fresh
                            e.meta.hbm_replicas[replica] = time.time()
                            e.tier = TIER_HBM
                        # a pin alone moves no bytes
                        if changed:
                            self._rebalance()
        except FileNotFoundError:
            with self._lock:
                if self._entries.get(key) is e:
                    self._entries.pop(key)
                    self._mark(key)
            return None
        return e

    # -- the lower tiers: disk, then peers ---------------------------------
    def _fetch_into(self, e: Entry) -> None:
        """Fill ``e.payload`` from the fastest lower tier that has the
        block; the caller holds ``e._mlock``, never the library lock (a
        pull can take seconds).  Raises ``FileNotFoundError`` when every
        tier misses; the backends count corruption and timeouts as
        misses."""
        m = e.meta
        if m.key is not None and self._disk_ok():
            p = self.disk.get(m.key)
            if p is not None:
                self._adopt(e, p, TIER_DISK)
                return
        if self.network is not None and m.ident and not self._follower:
            p, hdrs = self.network.get_with_headers(m.ident)
            claimed = hdrs.get("X-Block-Key")
            if p is not None and (m.key is None or claimed is None
                                  or claimed == m.key):
                if m.key is None:
                    m.key = claimed or content_key(
                        p, (m.scope_user, m.media_id), m.salt)
                self._adopt(e, p, TIER_NETWORK)
                e._pulled = True
                return
        raise FileNotFoundError(m.key or m.ident or m.media_id)

    def _adopt(self, e: Entry, p: KVPayload, tier: str) -> None:
        """Move a payload read from ``tier`` onto ``e.device`` and into
        ``e`` (the caller holds ``e._mlock``)."""
        self._to_device(e, p, tier)
        e.payload.k, e.payload.v = p.k, p.v
        e.payload.qk, e.payload.qv = p.qk, p.qv
        e.meta.dtype = e.meta.dtype or e.payload.dtype
        e.meta.shape = e.meta.shape or e.payload.shape
        self.memory.put(e.meta.ident, e.payload, e.meta)
        self._count(tier, "promotes")

    def register_remote(self, user_id: str, media_id: str, *,
                        nbytes: int = 0, salt: Optional[str] = None,
                        ttl: Optional[float] = None) -> Optional[Entry]:
        """Register a block that lives on a peer without pulling it: a
        payload-less network-tier entry, which the loader prefetches and
        the first ``get`` (with the same ``salt``) pulls onto ``device``.
        None if the scope already has an entry (the local block wins)."""
        if self.network is None:
            raise RuntimeError("register_remote requires connect_peers()")
        now = time.time()
        key = self._key(user_id, media_id)
        e = Entry(media_id, created=now, device=resolve_device(self.device),
                  expires=now + (self.default_ttl if ttl is None else ttl))
        m = e.meta
        m.tier, m.nbytes = TIER_NETWORK, nbytes
        m.ident, m.scope_user = scope_digest(key, salt), key[0]
        m.salt = salt
        e._owner = self
        with self._lock:
            if key in self._entries:
                return None
            self._entries[key] = e
            self._by_ident[m.ident] = key
            self._mark(key)
        return e

    def _network_admit(self, user_id: str, media_id: str,
                       salt: Optional[str] = None) -> Optional[Entry]:
        """A scope miss, asked of the peers at the salted address.  A
        verified pull becomes a host-tier entry with the peer's content key
        and remaining TTL, its tensors copied to ``device``; a miss (404,
        timeouts after the retry, a failed checksum, open breakers) returns
        None.  Under a mesh only rank 0 asks (:meth:`agree` brings the
        block to the others)."""
        if self.network is None or self._follower:
            return None
        key = self._key(user_id, media_id)
        ident = scope_digest(key, salt)
        p, hdrs = self.network.get_with_headers(ident)
        if p is None:
            return None
        now = time.time()
        try:
            ttl = float(hdrs.get("X-TTL-Remaining", "inf"))
        except ValueError:
            ttl = float("inf")
        e = Entry(media_id, created=now, expires=now + ttl,
                  device=resolve_device(self.device))
        m = e.meta
        m.tier = TIER_HOST
        m.key = hdrs.get("X-Block-Key") or content_key(p, key, salt)
        m.salt = salt
        e._pulled = True
        self._to_device(e, p, TIER_NETWORK)
        e.payload.k, e.payload.v = p.k, p.v
        e.payload.qk, e.payload.qv = p.qk, p.qv
        m.ident, m.scope_user = ident, key[0]
        m.dtype, m.shape = e.payload.dtype, e.payload.shape
        e._owner = self
        with self._lock:
            if key in self._entries:        # a concurrent put or pull won
                return self._entries[key]
            self._entries[key] = e
            self._by_ident[ident] = key
            self.memory.put(ident, e.payload, m)
            self._mark(key)
            self._count(TIER_NETWORK, "promotes")
            self._rebalance()
        return e

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._clock:
            s = self._copy_streams.get(device)
            if s is None:
                s = self._copy_streams[device] = torch.cuda.Stream(device)
            return s

    def _to_device(self, e: Entry, p: KVPayload, tier: str) -> None:
        """Move a payload read from disk or a peer (CPU tensors) to
        ``e.device``.  On the card: staged through pinned memory, copied
        on the library's copy stream, and waited for here, so that the
        read ends when the bytes are on the card."""
        dev = e.device
        if dev is None or dev.type == "cpu":
            return
        t0 = time.perf_counter()
        stream = self._copy_stream(dev)
        with torch.cuda.stream(stream):
            def up(t):
                return t.pin_memory().to(dev, non_blocking=True)
            if p.k is not None:
                p.k, p.v = up(p.k), up(p.v)
            for name in ("qk", "qv"):
                qkv = getattr(p, name)
                if qkv is not None:
                    setattr(p, name, QuantizedKV(up(qkv.q), up(qkv.scale),
                                                 qkv.block_tokens))
        stream.synchronize()
        e._on_copy_stream = True
        with self._clock:
            self._copy_s[tier] += time.perf_counter() - t0

    # -- pins -------------------------------------------------------------------
    def try_pin(self, entry: Entry) -> bool:
        """Pin ``entry`` if its tensors are still resident; False if a
        spool freed them since it was handed out (re-``get(pin=True)``)."""
        with self._lock:
            if entry.payload.k is None and entry.payload.qk is None:
                return False
            entry.meta.pins += 1
            return True

    def unpin(self, entry: Entry) -> None:
        """Drop one pin; the last one lets deferred demotions run."""
        with self._lock:
            entry.meta.pins = max(0, entry.meta.pins - 1)
            if entry.meta.pins == 0:
                self._rebalance()

    def peek_tier(self, user_id: str, media_id: str, *, replica=None,
                  salt: Optional[str] = None) -> Optional[str]:
        """The tier of a block, without touching its LRU state; a probe
        with another ``salt`` than the block's sees nothing, as in
        :meth:`get`.  ``replica`` gives that replica's view: hbm only if
        it holds the block, host for a resident block another replica
        holds."""
        with self._lock:
            e = self._entries.get(self._key(user_id, media_id))
            if e is None or not self._live(e) or e.meta.salt != salt:
                return None
            if replica is None:
                return e.tier
            if replica in e.meta.hbm_replicas:
                return TIER_HBM
            if e.payload.k is not None or e.payload.qk is not None:
                return TIER_HOST
            return (e.tier if e.tier in (TIER_DISK, TIER_NETWORK)
                    else TIER_HOST)

    # -- replicas -------------------------------------------------------------
    def touch(self, user_id: str, media_id: str, replica) -> None:
        """Mark an entry warm on ``replica`` without a ``get``: a fetch
        deduplicated onto another replica's load was consumed by this one.
        A block spooled since is left alone (the claim would be false)."""
        with self._lock:
            e = self._entries.get(self._key(user_id, media_id))
            if e is None or not self._live(e):
                return
            if e.payload.k is None and e.payload.qk is None:
                return
            e.last_used = time.time()
            fresh = replica not in e.meta.hbm_replicas or e.tier != TIER_HBM
            e.meta.hbm_replicas[replica] = e.last_used
            e.tier = TIER_HBM
            if fresh:
                self._mark(self._key(user_id, media_id))
                self._rebalance()

    def warmth(self, user_id: str, media_ids, replica) -> Dict[str, int]:
        """``{"hbm": n, "host": n, "disk": n, "miss": n}`` over
        ``media_ids`` as ``replica`` sees them (and ``"network"`` with
        peers): the affinity router's input.  Peers are not asked; only
        blocks already registered count as network."""
        counts = {TIER_HBM: 0, TIER_HOST: 0, TIER_DISK: 0, "miss": 0}
        if self.network is not None:
            counts[TIER_NETWORK] = 0
        for mid in media_ids:
            tier = self.peek_tier(user_id, mid, replica=replica)
            counts[tier if tier in counts else "miss"] += 1
        return counts

    def ident_tiers(self) -> Dict[str, str]:
        """``{scope digest: tier}`` of every unexpired entry: the warmth a
        fleet host gossips in its heartbeat."""
        now = time.time()
        with self._lock:
            return {e.meta.ident: e.tier for e in self._entries.values()
                    if e.meta.ident and self._live(e, now)}

    def delete(self, user_id: str, media_id: str) -> None:
        """Remove a block from every tier (idempotent)."""
        with self._lock:
            self._evict(self._key(user_id, media_id))

    def spool_now(self, user_id: str, media_id: str) -> bool:
        """Demote one entry to disk regardless of pressure.  False when the
        entry is missing, pinned, being read, or the write failed (it
        then stays resident).  Under a mesh rank 0 spools, every rank
        returns rank 0's answer, and a follower mirrors the spool at once
        (a :meth:`sync` of rank 0's change log)."""
        done = agree(self.mesh, not self._follower
                     and self._spool_one(user_id, media_id))
        if done and self.mesh is not None:
            self.sync()
        return done

    def _spool_one(self, user_id: str, media_id: str) -> bool:
        with self._lock:
            key = self._key(user_id, media_id)
            e = self._entries.get(key)
            if e is None:
                return False
            if e.payload.k is None and e.payload.qk is None:
                return e.tier == TIER_DISK
            return self._spool(key, e)

    def expire_now(self) -> int:
        """Delete expired entries; returns how many (none on a follower:
        rank 0's expiries reach it through :meth:`sync`)."""
        now = time.time()
        with self._lock:
            dead = [k for k, e in self._entries.items()
                    if not self._live(e, now)]
            for k in dead:
                self._evict(k)
        return len(dead)

    # -- cold start ---------------------------------------------------------------
    def rehydrate_spool(self, device=None) -> Dict[str, int]:
        """Rebuild the entry index from the spool directory after a
        restart: each whole block file's ``__meta__`` sidecar becomes a
        payload-less disk-tier entry under its recorded scope, read
        (verified against its content key) at its first lookup onto
        ``device`` (None means the card).

        The JAX package's scan rules: corrupt or unreadable files are
        unlinked and counted, expired blocks unlinked and counted, files
        without a sidecar (or without a scope in it) skipped, and so are
        scopes that already hold a live entry.  Returns the counts
        ``rehydrated`` / ``skipped`` / ``corrupt`` / ``expired``."""
        dev = resolve_device(device)
        stats = {"rehydrated": 0, "skipped": 0, "corrupt": 0, "expired": 0}
        now = time.time()
        for key, path in self.disk.scan():
            try:
                meta = self.disk.read_meta(path)
            except Exception:
                # a truncated zip or bad magic: unlink it, keep scanning
                _unlink(path)
                stats["corrupt"] += 1
                continue
            if meta is None or not meta.get("media_id") \
                    or meta.get("user_id") is None:
                stats["skipped"] += 1       # no scope recorded
                continue
            expires = float(meta.get("expires", float("inf")))
            if now > expires:
                _unlink(path)
                stats["expired"] += 1
                continue
            scope = (meta["user_id"], meta["media_id"])
            e = Entry(meta["media_id"], created=float(meta.get("created", now)),
                      expires=expires, device=dev)
            m = e.meta
            m.tier, m.last_used = TIER_DISK, now
            m.key = meta.get("key") or key
            m.salt = meta.get("salt")
            m.ident = meta.get("ident") or scope_digest(scope, m.salt)
            m.scope_user = meta["user_id"]
            m.nbytes = int(meta.get("nbytes", 0))
            m.dtype = meta.get("dtype")
            m.shape = tuple(meta["shape"]) if meta.get("shape") else None
            e._owner = self
            with self._lock:
                if scope in self._entries:
                    stats["skipped"] += 1   # the live entry wins
                    continue
                self._entries[scope] = e
                self._by_ident[m.ident] = scope
                self._mark(scope)
            stats["rehydrated"] += 1
        return stats

    # -- the peer server's block source ------------------------------------
    def export_block(self, ident: str):
        """One block for a peer: ``(npz bytes, headers)`` or None.  A
        resident block is pinned, copied to the host once, hashed into its
        content key if it never spooled, and serialized; a spooled block is
        served from its file, whose format is the wire format.  The lookup
        and pin hold the lock, the byte work does not."""
        with self._lock:
            key = self._by_ident.get(ident)
            e = self._entries.get(key) if key is not None else None
            if e is None or not self._live(e):
                pushed = self._pushed.get(ident)
                return (pushed[0], dict(pushed[1])) if pushed else None
            headers = {"X-Media-Id": e.meta.media_id,
                       "X-TTL-Remaining": repr(max(0.0,
                                                   e.expires - time.time()))}
            resident = (e.payload.k is not None
                        or e.payload.qk is not None)
            if resident:
                e.meta.pins += 1
            block_key = e.meta.key
        if not resident:
            if block_key is None:
                return None
            headers["X-Block-Key"] = block_key
            try:
                with open(self.disk.path_for(block_key), "rb") as f:
                    return f.read(), headers
            except FileNotFoundError:
                return None
        try:
            e.wait_loaded()
            host = _on_host(e.payload)
            if block_key is None:
                block_key = content_key(host, key, e.meta.salt)
                with self._lock:
                    e.meta.key = e.meta.key or block_key
            headers["X-Block-Key"] = block_key
            return payload_to_bytes(host), headers
        finally:
            self.unpin(e)

    def admit_block(self, ident: str, data: bytes, headers: dict) -> None:
        """Accept a peer's PUT.  Kept out of the entry map (an ident does
        not give back its scope) but served back by :meth:`export_block`."""
        with self._lock:
            self._pushed[ident] = (data, dict(headers))

    def delete_block(self, ident: str) -> None:
        """A peer's DELETE: evict the addressed entry from every tier."""
        with self._lock:
            self._pushed.pop(ident, None)
            key = self._by_ident.get(ident)
            if key is not None:
                self._evict(key)

    def has_block(self, ident: str) -> bool:
        """A peer's HEAD: an unexpired entry or a pushed block."""
        with self._lock:
            if ident in self._pushed:
                return True
            key = self._by_ident.get(ident)
            e = self._entries.get(key) if key is not None else None
            return e is not None and self._live(e)

    # -- tier management -----------------------------------------------------------
    def _evict(self, key) -> None:
        """Drop one entry from the map and every backend; the caller holds
        the lock.  A concurrent disk read either has the file open (an
        unlink is safe) or misses."""
        e = self._entries.pop(key, None)
        if e is not None:
            self._mark(key)
            if self._by_ident.get(e.meta.ident) == key:
                del self._by_ident[e.meta.ident]
            self.memory.delete(e.meta.ident)
            if e.meta.key:
                self.disk.delete(e.meta.key)

    def _spool(self, key, e: Entry) -> bool:
        """Demote one entry to disk, hashing its bytes into the content
        key at its first spool; False if pinned or being read (the caller
        holds the lock and must not wait for ``_mlock``) or if the write
        failed."""
        if e.meta.pins > 0 or not self._disk_ok():
            return False
        if not e._mlock.acquire(blocking=False):
            return False
        try:
            m = e.meta
            if m.key is None:
                m.key = content_key(e.payload, key, m.salt)
            m.nbytes = e.payload.stored_nbytes
            try:
                self.disk.put(m.key, e.payload, m)
            except OSError as exc:
                # counted; the entry keeps its tensors
                self._spool_failures += 1
                if exc.errno == errno.ENOSPC:
                    self._enospc += 1
                return False
            self._drop_tensors(e, TIER_DISK)
            self._mark(key)
        finally:
            e._mlock.release()
        return True

    def _drop_tensors(self, e: Entry, tier: str) -> None:
        """The tensors of a spooled entry go (the caller holds the lock and
        ``e._mlock``)."""
        self.memory.delete(e.meta.ident)
        e.payload.k = e.payload.v = None
        e.payload.qk = e.payload.qv = None
        e._on_copy_stream = False
        e.tier = tier
        self._count(TIER_HOST, "demotes")

    def _rebalance(self) -> None:
        """Demote LRU entries while a tier is over its budget.  First each
        replica's holds against its own budget
        (:meth:`MemoryBackend.demote_replicas`), then the entries no
        replica holds: hbm -> host (a label), host -> disk (a spool).  The
        caller holds the lock.  A follower demotes only as rank 0 did
        (:meth:`sync`)."""
        if self._follower:
            return
        live = list(self._entries.values())
        nb = {id(e.meta): e.nbytes for e in live}
        held = {id(e.meta): len(e.meta.hbm_replicas) for e in live}
        dropped = self.memory.demote_replicas(
            (e.meta for e in live), lambda m: nb[id(m)])
        if dropped:
            self._count(TIER_HBM, "demotes", dropped)
            self._mark(*(k for k, e in self._entries.items()
                         if len(e.meta.hbm_replicas) != held[id(e.meta)]))
        for tier, cap, demote in (
                (TIER_HBM, self.memory.hbm_capacity, TIER_HOST),
                (TIER_HOST, self.memory.host_capacity, TIER_DISK)):
            cands = [(k, e) for k, e in self._entries.items()
                     if e.tier == tier and not e.meta.hbm_replicas]
            used = sum(e.nbytes for _, e in cands)
            cands.sort(key=lambda kv: kv[1].last_used)
            for k, e in cands:
                if used <= cap:
                    break
                freed = e.nbytes
                if demote == TIER_DISK:
                    if not self._spool(k, e):
                        continue        # pinned or being read: next victim
                else:
                    e.tier = TIER_HOST
                    self._mark(k)
                    self._count(TIER_HBM, "demotes")
                used -= freed

    # -- tensor parallelism: rank 0 decides ---------------------------------
    def attach_mesh(self, mesh) -> None:
        """Serve the ranks of ``mesh`` (see the module's notes).  Every rank
        calls it at the same point (a mesh engine's construction); a second
        call with the same mesh does nothing.  A follower's disk tier
        becomes a reader, and its entries take rank 0's placement (the
        first :meth:`sync`, of every entry)."""
        if self._attached is mesh:
            return
        if self._attached is not None or (self.mesh is not None
                                          and self.mesh is not mesh):
            raise ValueError("a library serves one mesh")
        self.mesh = self._attached = mesh
        if self.device is None:
            self.device = mesh.device   # where a follower's reads land
        self.disk.reader = self._follower
        self._dirty = None
        self.sync()

    @staticmethod
    def _placement_of(e: Entry) -> _Placement:
        m = e.meta
        return _Placement(
            m.tier, e.payload.k is not None or e.payload.qk is not None,
            m.key, m.nbytes, tuple(sorted(m.hbm_replicas, key=repr)),
            m.ident, m.salt, m.media_id, m.scope_user, m.dtype,
            None if m.shape is None else tuple(m.shape), m.created,
            m.expires)

    def sync_state(self) -> Optional[dict]:
        """Rank 0's side of :meth:`sync`: the spool directory and the
        placement of each entry whose placement changed since the last
        call (None for one that went; every entry, with ``full``, at the
        first).  None on a follower."""
        if self._follower:
            return None
        with self._lock:
            full = self._dirty is None
            keys = self._entries if full else self._dirty
            changes = {k: (self._placement_of(self._entries[k])
                           if k in self._entries else None) for k in keys}
            self._dirty = set()
        return {"dir": self.disk.spool_dir, "full": full,
                "entries": changes}

    def apply_sync(self, state: dict) -> None:
        """Every rank's side of :meth:`sync`, with rank 0's ``state``: a
        follower mirrors rank 0's changes."""
        if self._follower:
            if state["dir"] is not None:
                self.disk.spool_dir = state["dir"]
            self._mirror(state["entries"], state["full"])

    def sync(self) -> None:
        """One broadcast of rank 0's :meth:`sync_state` on the engine's
        thread, applied on every rank (every rank calls it at the same
        point).  Nothing without a mesh."""
        if self.mesh is not None:
            self.apply_sync(self.mesh.broadcast_object(self.sync_state()))

    def _mirror(self, changes: Dict, full: bool) -> None:
        """A follower's entries as rank 0 placed them (``changes``: key ->
        rank 0's placement, or None; ``full``: every key rank 0 holds, so
        that one it does not goes).  An entry rank 0 has not goes (its file
        stays: rank 0's), one rank 0 spooled drops its tensors under rank
        0's content key (unless pinned or being read: retried at the next
        sync), a spooled one the follower lacks is indexed from rank 0's
        file, a resident one takes rank 0's tier label and replica holds.
        A block rank 0 holds resident and this rank does not stays unread
        until a lookup asks for it (:meth:`agree`); one this rank read
        where rank 0 holds it on disk goes back to disk."""
        with self._lock:
            if full:
                for key in [k for k in self._entries if k not in changes]:
                    self._evict(key)
                self._unmirrored.clear()
                self._placed.clear()
            own = () if full or self._dirty is None else self._dirty
            pending = {**{k: self._placed[k] for k in own
                          if k in self._placed},
                       **self._unmirrored, **changes}
            self._unmirrored = {}
            for key, p in changes.items():
                if p is None:
                    self._placed.pop(key, None)
                else:
                    self._placed[key] = p
            for key, p in pending.items():
                e = self._entries.get(key)
                if p is None or (e is not None and e.meta.ident != p.ident):
                    self._evict(key)
                    e = None
                if p is None:
                    continue
                if e is None:
                    if not p.resident and p.key is not None:
                        self._index(key, p)
                    continue
                e.meta.hbm_replicas = {r: e.meta.hbm_replicas.get(
                    r, e.last_used) for r in p.replicas}
                resident = (e.payload.k is not None
                            or e.payload.qk is not None)
                if p.resident:
                    if resident:
                        e.tier = p.tier
                    continue
                e.meta.key, e.meta.nbytes = p.key, p.nbytes
                if not resident:
                    e.tier = p.tier
                elif e.meta.pins == 0 and e._mlock.acquire(blocking=False):
                    try:
                        self._drop_tensors(e, p.tier)
                    finally:
                        e._mlock.release()
                else:
                    self._unmirrored[key] = p
            self._dirty = set()

    def _index(self, key, p: _Placement) -> Entry:
        """A payload-less disk-tier entry for rank 0's spooled block ``p``
        (the caller holds the lock)."""
        e = Entry(p.media_id, created=p.created, expires=p.expires,
                  device=resolve_device(self.device))
        m = e.meta
        m.tier, m.last_used = TIER_DISK, time.time()
        m.key, m.nbytes = p.key, p.nbytes
        m.ident, m.salt, m.scope_user = p.ident, p.salt, p.scope_user
        m.dtype, m.shape = p.dtype, p.shape
        e._owner = self
        self._entries[key] = e
        self._by_ident[m.ident] = key
        return e

    def agree(self, user_id: str, media_id: str, entry: Optional[Entry], *,
              salt: Optional[str] = None, replica=None) -> Optional[Entry]:
        """Rank 0's outcome of one lookup, on every rank.  ``entry`` is this
        rank's answer (pinned, or None); the result is ``entry`` or rank
        0's other answer: None where rank 0 missed, or, where only rank 0
        hit, the block read from rank 0's file and pinned (the caller
        unpins ``entry`` when it gets something else).  Without a mesh,
        ``entry``.  On the engine's thread only, every rank calling it for
        the same lookups in the same order: it broadcasts, then sums the
        ranks' flags, and raises :class:`RankDivergence` on every rank when
        one rank could not follow."""
        if self.mesh is None:
            return entry
        key = self._key(user_id, media_id)
        state = None if self._follower else self._lookup_state(key, entry)
        state = self.mesh.broadcast_object(state)
        out, why = entry, None
        if self._follower:
            out, why = self._follow(user_id, media_id, key, entry, state,
                                    salt, replica)
        elif not state["hit"]:
            out = None          # rank 0 could not write its pulled block
        if self.mesh.any_rank(why is not None):
            if out is not None and out is not entry:
                self.unpin(out)
            raise RankDivergence(
                f"{media_id!r}: a rank could not follow rank 0's lookup"
                + (f" (rank {self.mesh.rank}: {why})" if why else ""))
        return out

    def _lookup_state(self, key, entry: Optional[Entry]) -> dict:
        """Rank 0's side of :meth:`agree`.  A block it pulled from a peer
        is on no other rank: its file is written first (a failed write
        makes the lookup a miss on every rank)."""
        if entry is None:
            with self._lock:
                return {"hit": False, "present": key in self._entries}
        m = entry.meta
        if (self.mesh.world > 1 and entry._pulled
                and not self.disk.contains(m.key)):
            try:
                with entry._mlock:
                    entry.wait_loaded()
                    m.nbytes = entry.payload.stored_nbytes
                    self.disk.put(m.key, entry.payload, m)
            except OSError:
                with self._clock:
                    self._spool_failures += 1
                return {"hit": False, "present": True}
        return {"hit": True, "placement": self._placement_of(entry),
                "file": m.key is not None and self.disk.contains(m.key),
                "dir": self.disk.spool_dir}

    def _follow(self, user_id, media_id, key, entry, state, salt, replica):
        """A follower's side of :meth:`agree`: (its answer, why it could
        not follow or None)."""
        if not state["hit"]:
            if not state["present"]:
                with self._lock:
                    self._evict(key)
            return None, None
        if entry is not None:
            return entry, None
        p = state["placement"]
        if not state["file"]:
            return None, "rank 0 holds the block in no file"
        self.disk.spool_dir = state["dir"]
        with self._lock:
            e = self._entries.get(key)
            if e is not None and (e.meta.ident != p.ident
                                  or e.meta.key != p.key):
                self._evict(key)
                e = None
            if e is None:
                self._index(key, p)
        got = self.get(user_id, media_id, salt=salt, replica=replica,
                       pin=True)
        if got is None:
            return None, (f"its read of rank 0's spool file "
                          f"{self.disk.path_for(p.key)} failed")
        return got, None

    def get_agreed(self, user_id: str, media_id: str, *,
                   salt: Optional[str] = None,
                   replica=None) -> Optional[Entry]:
        """``get(..., pin=True)`` on the engine's thread, with rank 0's
        outcome under a mesh (:meth:`agree`)."""
        e = self.get(user_id, media_id, salt=salt, replica=replica, pin=True)
        try:
            out = self.agree(user_id, media_id, e, salt=salt,
                             replica=replica)
        except BaseException:
            if e is not None:
                self.unpin(e)
            raise
        if e is not None and out is not e:
            self.unpin(e)
        return out

    # -- introspection -------------------------------------------------------------
    def stats(self) -> dict:
        """Entry and byte census by tier, the per-tier hit / promote /
        demote counters, and the lower tiers' read counters: ``fetches``,
        ``fetch_misses``, ``fetch_s`` (read or pull, and verify),
        ``verify_s`` (SHA-1), ``bytes_read``, and ``copy_s``, the staging
        and copy of those reads to the card; the disk's ``corrupt``,
        ``io_errors`` and ``quarantined``, the network's ``timeouts``,
        ``retries``, ``breaker_skips`` and ``breakers``.  The network tier
        appears only with peers; ``hbm_bytes_by_replica`` only once a
        replica holds a block.  ``sessions``: the freeze, thaw and fork
        counts and the registered pools' ``cow_copies`` and
        ``pages_shared``."""
        with self._lock:
            by_tier: Dict[str, int] = {}
            by_replica: Dict = {}
            for e in self._entries.values():
                by_tier[e.tier] = by_tier.get(e.tier, 0) + e.nbytes
                for r in e.meta.hbm_replicas:
                    by_replica[r] = by_replica.get(r, 0) + e.nbytes
            out = {"entries": len(self._entries), "bytes_by_tier": by_tier}
            if by_replica:
                out["hbm_bytes_by_replica"] = by_replica
        with self._clock:
            tiers = {t: dict(c) for t, c in self._tiers.items()
                     if t != TIER_NETWORK or self.network is not None}
            out.update(misses=self._misses, dequants=self._dequants,
                       direct_links=self._direct_links)
            copy_s = dict(self._copy_s)
            sessions = dict(self._session_ctr, cow_copies=0, pages_shared=0)
            sources = list(self._session_sources)
        # the pools' live gauges, read outside the counter lock
        for fn in sources:
            for name, n in fn().items():
                sessions[name] = sessions.get(name, 0) + int(n)
        out["sessions"] = sessions
        b = self.disk.stats()
        # evaluated, not read: a streak past the threshold reads degraded
        # before the next disk access sets the flag
        quarantined = not self._disk_ok()
        tiers[TIER_DISK].update(
            fetches=b["hits"], fetch_misses=b["misses"],
            fetch_s=round(b["fetch_s"], 6), verify_s=round(b["verify_s"], 6),
            bytes_read=b["bytes_read"], bytes_written=b["bytes_written"],
            corrupt=b["corrupt"], io_errors=b["io_errors"],
            copy_s=round(copy_s[TIER_DISK], 6), quarantined=quarantined)
        if self.network is not None:
            n = self.network.stats()
            tiers[TIER_NETWORK].update(
                fetches=n["hits"], fetch_misses=n["misses"],
                fetch_s=round(n["fetch_s"], 6),
                verify_s=round(n["verify_s"], 6), bytes_read=n["bytes_read"],
                timeouts=n["timeouts"], retries=n["retries"],
                breaker_skips=n["breaker_skips"], breakers=n["breakers"],
                copy_s=round(copy_s[TIER_NETWORK], 6))
        out["tiers"] = tiers
        out["degraded"] = {"disk_quarantined": quarantined,
                           "disk_failure_streak": self.disk.failure_streak,
                           "spool_failures": self._spool_failures,
                           "enospc": self._enospc}
        return out


def _on_host(p: KVPayload) -> KVPayload:
    """The stored form of a payload (int8 when present) on the host."""
    if p.qk is not None:
        return KVPayload(qk=QuantizedKV(p.qk.q.cpu(), p.qk.scale.cpu(),
                                        p.qk.block_tokens),
                         qv=QuantizedKV(p.qv.q.cpu(), p.qv.scale.cpu(),
                                        p.qv.block_tokens))
    return KVPayload(k=p.k.cpu(), v=p.v.cpu())


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
