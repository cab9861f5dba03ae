"""Parallel KV loads (port of the JAX package's ``cache/transfer.py``, its
loader and prefetch handles).

When a request references media whose KV sits on a slow tier, MPIC
overlaps the **load stream** (fetching that KV) with the **compute
stream** (the engine's prefills and decode steps).  :class:`ParallelLoader`
runs library fetches on a thread pool; :class:`PrefetchHandle` bundles one
request's fetches and hands each entry out, pinned, when the linker asks
for it (blocking only on fetches that are still running).

Under a mesh the workers only fetch: the outcome each rank consumes is
rank 0's, shared where the engine's thread gathers it
(:meth:`PrefetchHandle.get`), so that no collective runs on a worker.

A fetch from disk or from a peer ends when its bytes are on the engine's
device (:meth:`KVLibrary.get` waits for its copy), so a load interval
covers the copy to the card too.  The ``loader.fetch`` fault site
(``cache/faults.py``) stalls a worker or fails its fetch, which counts as
a miss.

One loader may serve a cluster's replicas: each replica's prefetches
carry its id (``replica=``), a fetch of one ``(user, media)`` already in
flight for another replica is shared, and the consuming handle marks the
entry warm on its own replica at gather time (``KVLibrary.touch``).

:class:`TransferPlan` / :func:`plan_transfers` are the paper's Eq. 1
load/compute model (Fig. 6): the blocks that hit, at their tier's rate
(``backends.TIER_BW``), against the misses' recompute, pipelined ``T =
max(load, compute)`` and sequential ``T = load + compute``.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cache.backends import TIER_BW
from repro_torch.cache.library import (
    TIER_DISK,
    TIER_HBM,
    TIER_HOST,
    TIER_NETWORK,
    Entry,
    KVLibrary,
)

# issue order: the slowest tier first, so the long reads get a head start
# on the worker pool; misses last, as in the JAX package (with peers a
# miss is a pull)
_TIER_RANK = {TIER_NETWORK: 0, TIER_DISK: 1, TIER_HOST: 2, TIER_HBM: 3,
              None: 4}


@dataclasses.dataclass
class TransferPlan:
    """The analytic Fig. 6 schedule of one request: which blocks hit (and
    from which tier), which miss, and the modelled wall times."""
    hits: List[Tuple[str, str, int]]      # (media_id, tier, nbytes)
    misses: List[str]
    load_s: float
    compute_s: float

    @property
    def parallel_s(self) -> float:
        """Pipelined wall time, ``T ~ max(load, compute)`` (Eq. 1)."""
        return max(self.load_s, self.compute_s)

    @property
    def sequential_s(self) -> float:
        """Wall time with no overlap: ``load + compute``."""
        return self.load_s + self.compute_s


def plan_transfers(library: KVLibrary, user_id: str,
                   media_ids: Sequence[str],
                   compute_estimator: Callable[[str], float]) -> TransferPlan:
    """One request's load/compute overlap from the library's current
    placement (``peek_tier``) and ``TIER_BW``; a miss costs
    ``compute_estimator(media_id)`` seconds.  Read-only."""
    hits, misses, load_s = [], [], 0.0
    for mid in media_ids:
        tier = library.peek_tier(user_id, mid)
        if tier is None:
            misses.append(mid)
            continue
        e = library._entries[library._key(user_id, mid)]
        hits.append((mid, tier, e.nbytes))
        load_s += e.nbytes / TIER_BW[tier]
    compute_s = sum(compute_estimator(m) for m in misses)
    return TransferPlan(hits, misses, load_s, compute_s)


@dataclasses.dataclass
class LoadRecord:
    """One in-flight library fetch: its future and wall-clock interval."""
    media_id: str
    future: Optional[cf.Future] = None
    t_start: float = 0.0                  # the worker began the fetch
    t_end: float = 0.0                    # the worker finished (hit or miss)
    replica: Optional[int] = None         # the replica whose prefetch issued it

    @property
    def busy_s(self) -> float:
        return max(0.0, self.t_end - self.t_start) if self.t_end else 0.0


class PrefetchHandle:
    """One request's in-flight fetches, gathered per media id at link time.

    :meth:`get` is the linker's ``entries`` source: it returns the entry
    **pinned** (one pin per media id), revalidated against the library, and
    records the time the caller spent blocked on a fetch still running.
    The engine calls :meth:`release` when the prefill is finalized or
    aborted.  ``replica`` is the cluster replica that consumes the entries:
    its lookups mark them warm there.
    """

    def __init__(self, loader: "ParallelLoader", user_id: str,
                 records: Dict[str, LoadRecord], *, replica=None):
        self._loader = loader
        self.user_id = user_id
        self.records = records
        self.replica = replica
        self.blocked_s = 0.0      # wall time a consumer waited in get()
        self.blocked_intervals: List[Tuple[float, float]] = []
        self._pinned: Dict[str, Entry] = {}

    def _revalidate(self, media_id: str,
                    entry: Optional[Entry]) -> Optional[Entry]:
        """A fetch may predate the gather by a whole queue wait: the entry
        may have been spooled, have expired, or been replaced by a ``put``.
        A resident, live entry that is still the library's entry for this
        identity passes; anything else goes through ``library.get``."""
        if entry is None:
            return None
        lib = self._loader.library
        resident = (entry.payload.k is not None
                    or entry.payload.qk is not None)
        if resident and lib._live(entry):
            if lib._entries.get(lib._key(self.user_id, media_id)) is entry:
                return entry
        return lib.get(self.user_id, media_id, replica=self.replica)

    def get(self, media_id: str, timeout: float = 60.0) -> Optional[Entry]:
        """The entry for ``media_id`` (None on a miss), pinned, blocking if
        its fetch is still running.  An id that was never prefetched falls
        back to one synchronous ``library.get``.  A fetch that another
        replica's prefetch issued marks the entry warm on this handle's
        replica.  Under a mesh the answer is rank 0's
        (:meth:`KVLibrary.agree`): the consumer's thread, never a worker,
        carries a fetch's outcome to the other ranks."""
        lib = self._loader.library
        entry = self._gather(media_id, timeout)
        agreed = lib.agree(self.user_id, media_id, entry,
                           replica=self.replica)
        if agreed is not entry:
            if entry is not None:
                self._pinned.pop(media_id, None)
                lib.unpin(entry)
            if agreed is not None:
                self._adopt(media_id, agreed)
        return agreed

    def _gather(self, media_id: str, timeout: float) -> Optional[Entry]:
        lib = self._loader.library
        rec = self.records.get(media_id)
        if rec is None:
            return self._adopt(media_id, lib.get(
                self.user_id, media_id, replica=self.replica, pin=True))
        # only a gather that actually waits counts as blocked
        was_pending = not rec.future.done()
        t0 = time.perf_counter()
        entry = rec.future.result(timeout=timeout)
        if was_pending:
            t1 = time.perf_counter()
            self.blocked_s += t1 - t0
            self.blocked_intervals.append((t0, t1))
        entry = self._revalidate(media_id, entry)
        if entry is None:
            return None
        if lib.try_pin(entry):
            if self.replica is not None and rec.replica != self.replica:
                lib.touch(self.user_id, media_id, self.replica)
            return self._adopt(media_id, entry)
        # spooled between the fetch and the gather: reload and pin at once
        return self._adopt(media_id, lib.get(
            self.user_id, media_id, replica=self.replica, pin=True))

    def _adopt(self, media_id: str,
               entry: Optional[Entry]) -> Optional[Entry]:
        """Hold exactly one pin per media id: a re-gather drops its surplus
        pin, a different entry object replaces the old pin."""
        if entry is None:
            return None
        lib = self._loader.library
        old = self._pinned.get(media_id)
        if old is entry:
            lib.unpin(entry)
        else:
            if old is not None:
                lib.unpin(old)
            self._pinned[media_id] = entry
        return entry

    def release(self) -> None:
        """Unpin every entry this handle handed out (idempotent)."""
        lib = self._loader.library
        while self._pinned:
            _, entry = self._pinned.popitem()
            lib.unpin(entry)

    def wait(self, timeout: float = 60.0) -> Dict[str, Optional[Entry]]:
        """Gather every prefetched entry, as :meth:`get` does."""
        return {mid: self.get(mid, timeout=timeout) for mid in self.records}

    @property
    def load_busy_s(self) -> float:
        """Worker-busy seconds over all of this request's fetches."""
        return sum(r.busy_s for r in self.records.values())

    def intervals(self) -> List[Tuple[float, float]]:
        """Completed fetch intervals [(t_start, t_end), ...]."""
        return [(r.t_start, r.t_end) for r in self.records.values()
                if r.t_end > 0.0]


class ParallelLoader:
    """Library fetches on a thread pool, overlapping the caller's compute.

    Fetches of one ``(user, media)`` already in flight are shared
    (``dedup_hits``); a ``put`` that replaces an entry drops its in-flight
    slot (``invalidations``), so the next prefetch reads the new block.  A
    fetch that raises is counted in ``load_failures`` and becomes a miss:
    the request recomputes that media.  ``replica`` is the default tag of
    the fetches it issues.
    """

    def __init__(self, library: KVLibrary, max_workers: int = 4, *,
                 replica=None):
        self.library = library
        self.replica = replica
        self.pool = cf.ThreadPoolExecutor(max_workers=max_workers,
                                          thread_name_prefix="kv-loader")
        self._inflight: Dict[Tuple[str, str], LoadRecord] = {}
        self._ilock = threading.Lock()
        self.dedup_hits = 0
        self.invalidations = 0
        self.load_failures = 0
        library.add_invalidation_listener(self._invalidate)

    def _invalidate(self, user_id: str, media_id: str) -> None:
        """A ``put`` replaced ``(user, media)``: forget the old fetch (it
        finishes, and the handle's identity check discards it)."""
        with self._ilock:
            if self._inflight.pop((user_id, media_id), None) is not None:
                self.invalidations += 1

    def prefetch_handle(self, user_id: str, media_ids: Sequence[str], *,
                        replica=None) -> PrefetchHandle:
        """Issue the fetches (slowest tier first, as ``replica`` sees the
        tiers) and return their handle."""
        replica = self.replica if replica is None else replica
        tiers = {mid: self.library.peek_tier(user_id, mid, replica=replica)
                 for mid in media_ids}
        ordered = sorted(dict.fromkeys(media_ids),
                         key=lambda m: _TIER_RANK[tiers[m]])
        records: Dict[str, LoadRecord] = {}
        fresh: List[Tuple[str, LoadRecord]] = []
        with self._ilock:
            for mid in ordered:
                rec = self._inflight.get((user_id, mid))
                if rec is not None:
                    self.dedup_hits += 1
                else:
                    # submitted under the lock: nobody sees a record
                    # without its future
                    rec = LoadRecord(mid, replica=replica)
                    rec.future = self.pool.submit(self._timed_get, user_id,
                                                  rec)
                    self._inflight[(user_id, mid)] = rec
                    fresh.append((mid, rec))
                records[mid] = rec
        # outside the lock: a finished future runs its callback right here
        for mid, rec in fresh:
            rec.future.add_done_callback(
                lambda _f, key=(user_id, mid), r=rec: self._retire(key, r))
        return PrefetchHandle(self, user_id, records, replica=replica)

    def _retire(self, key, rec: LoadRecord) -> None:
        with self._ilock:
            if self._inflight.get(key) is rec:
                del self._inflight[key]

    def _timed_get(self, user_id: str, rec: LoadRecord) -> Optional[Entry]:
        """Worker body.  A failed fetch is a counted miss, never a raise:
        the handle's result feeds the link step, where a miss means
        recompute.  A ``RuntimeError`` (torch's, from the copy to the card)
        is not a miss: it reaches the consumer through the future.  Fault
        site ``loader.fetch``: ``stall`` sleeps, then fetches; ``error`` is
        a counted miss."""
        rec.t_start = time.perf_counter()
        try:
            faults = self.library.faults
            rule = (faults.check("loader.fetch", rec.media_id)
                    if faults is not None else None)
            if rule is not None and rule.kind == "stall":
                faults.sleep(rule)
            elif rule is not None and rule.kind == "error":
                raise OSError(f"injected loader error for {rec.media_id}")
            return self.library.get(user_id, rec.media_id,
                                    replica=rec.replica)
        except RuntimeError:
            raise
        except Exception:
            with self._ilock:
                self.load_failures += 1
            return None
        finally:
            rec.t_end = time.perf_counter()

    def close(self) -> None:
        """Shut the worker pool down without waiting for running fetches."""
        self.pool.shutdown(wait=False)
