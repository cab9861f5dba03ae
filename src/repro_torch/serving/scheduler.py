"""Pipelined admission: media loads overlap recompute (port of the JAX
package's ``serving/scheduler.py``, its queue and pipeline).

Two streams run at once:

* the **load stream**: whenever a request enters the front
  ``PREFETCH_DEPTH`` of the waiting queue, its media fetches are issued on
  the :class:`~repro_torch.cache.transfer.ParallelLoader`, slowest tier
  first; the linker gathers each entry at link time through the request's
  :class:`~repro_torch.cache.transfer.PrefetchHandle`, so a request blocks
  only on fetches not finished when its link needs them;
* the **compute stream**: the engine's prefills and decode steps, each
  recorded as a wall-clock window (:meth:`PipelinedScheduler.compute_window`)
  so that the overlap is measured, not modelled:
  ``overlap_s = sum |load intersect compute|`` minus the spans in which the
  engine sat blocked on a load.

On the card, the engine's windows close after a host read of the step's
logits, which waits for the device work the window issued; a load's
interval ends when its bytes are on the card.  Both are device-complete
host intervals.

``pipelined=False`` is the sequential baseline: a request's fetches are
issued and waited for when it is popped, before its compute starts.

A :class:`ChunkedPrefillTask` splits one request's prefill (``mpic`` or
``full_recompute``) into chunks, one per engine step, each inside a
compute window, so that the running slots decode between them.
"""
from __future__ import annotations

import contextlib
import heapq
import itertools
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.transfer import (
    _TIER_RANK,
    ParallelLoader,
    PrefetchHandle,
)
from repro_torch.core import select as sel_mod
from repro_torch.core.linker import link_prompt
from repro_torch.core.policies import (
    POLICIES,
    PolicyResult,
    _first_logits,
    _full_prompt_arrays,
    _selective_step,
)
from repro_torch.launch.mesh import agree
from repro_torch.serving.request import Request, State

# queued requests whose media loads are kept in flight (the JAX engine's
# default ``prefetch_depth``)
PREFETCH_DEPTH = 2


class WaitingQueue:
    """Priority waiting queue: higher ``Request.priority`` first, FIFO ties.

    ``aging_s > 0`` ages priorities: a queued request's effective priority
    grows by one level per ``aging_s`` seconds waited, so that a burst of
    higher-priority traffic cannot starve older requests.  The order is
    then decided at pop and peek time (a scan); ``aging_s=0`` keeps the
    static heap.  Under ``mesh`` the aged order is rank 0's on every rank
    (:func:`~repro_torch.launch.mesh.agree`): it reads each rank's clock,
    and the ranks push the same requests in the same order, so a push
    number names one request on every rank.
    """

    def __init__(self, aging_s: float = 0.0, mesh=None):
        self.aging_s = float(aging_s)
        self.mesh = mesh
        self._heap: List[Tuple[int, int, float, Request]] = []
        self._seq = itertools.count()

    def push(self, req: Request) -> None:
        item = (-req.priority, next(self._seq), time.perf_counter(), req)
        if self.aging_s > 0:
            self._heap.append(item)     # a plain list: ordered at pop
        else:
            heapq.heappush(self._heap, item)

    def _aged_key(self, item, now: float):
        neg_pri, seq, t_enq, _ = item
        return (neg_pri - (now - t_enq) / self.aging_s, seq)

    def _aged(self, n: int) -> List[int]:
        """The heap indices of the next ``n`` requests by aged priority
        now (rank 0's clock under a mesh)."""
        now = time.perf_counter()
        order = sorted(range(len(self._heap)),
                       key=lambda j: self._aged_key(self._heap[j], now))[:n]
        if self.mesh is None:
            return order
        seqs = agree(self.mesh, [self._heap[j][1] for j in order])
        at = {item[1]: j for j, item in enumerate(self._heap)}
        return [at[seq] for seq in seqs]

    def pop(self) -> Request:
        if self.aging_s > 0:
            return self._heap.pop(self._aged(1)[0])[3]
        return heapq.heappop(self._heap)[3]

    def peek(self, n: int) -> List[Request]:
        """The next ``n`` requests in admission order, not popped."""
        if self.aging_s > 0:
            return [self._heap[j][3] for j in self._aged(n)]
        return [item[3] for item in heapq.nsmallest(n, self._heap)]

    def remove(self, req: Request) -> bool:
        """Drop one queued request by identity."""
        for i, item in enumerate(self._heap):
            if item[3] is req:
                self._heap.pop(i)
                if self.aging_s <= 0:
                    heapq.heapify(self._heap)
                return True
        return False

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self):
        return iter(item[3] for item in sorted(self._heap))


def _media_ids(req: Request) -> List[str]:
    return [seg.media_id for _, seg in req.prompt.media_segments()]


class PipelinedScheduler:
    """Admission pipeline over a :class:`WaitingQueue` and a loader.

    ``prefetch_filter(req)`` says whether a request's policy will gather
    library entries at all (the engine's ``_policy_consumes_entries``), so
    that requests that never link media occupy no loader worker.
    ``replica`` tags the prefetches issued on a loader that a cluster's
    replicas share (per-replica warmth, deduplicated fetches);
    ``aging_s`` and ``mesh`` go to the :class:`WaitingQueue`.
    """

    def __init__(self, loader: ParallelLoader, *, pipelined: bool = True,
                 max_intervals: int = 1024, prefetch_filter=None,
                 replica=None, aging_s: float = 0.0, mesh=None):
        self.loader = loader
        self.pipelined = pipelined
        self.prefetch_filter = prefetch_filter
        self.replica = replica
        self.queue = WaitingQueue(aging_s=aging_s, mesh=mesh)
        self._handles: Dict[str, PrefetchHandle] = {}
        # the engine's compute windows; old ones cannot meet new loads
        self._compute_intervals: deque = deque(maxlen=max_intervals)
        # recent handles: the engine computes nothing while blocked on any
        # of them, so their blocked spans leave every request's overlap
        self._recent_handles: deque = deque(maxlen=64)
        self.admitted = 0

    # -- the queue -------------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        req.state = State.WAITING
        self.queue.push(req)
        self._top_up()

    def pop(self) -> Tuple[Request, Optional[PrefetchHandle]]:
        """The next request to admit and its (maybe still loading) handle."""
        req = self.queue.pop()
        req.t_admitted = time.perf_counter()
        handle = self._handles.pop(req.req_id, None)
        if handle is None and self._should_prefetch(req):
            # pipelined: it passed through the window between top-ups.  The
            # sequential baseline: load everything now, before compute
            handle = self._issue(req)
            if not self.pipelined:
                handle.wait()
        self._top_up()
        self.admitted += 1
        return req, handle

    def _issue(self, req: Request) -> PrefetchHandle:
        handle = self.loader.prefetch_handle(req.prompt.user_id,
                                             _media_ids(req),
                                             replica=self.replica)
        self._recent_handles.append(handle)
        return handle

    def _should_prefetch(self, req: Request) -> bool:
        return bool(_media_ids(req)) and (self.prefetch_filter is None
                                          or self.prefetch_filter(req))

    def _slowest_tier_rank(self, req: Request) -> int:
        lib = self.loader.library
        return min(_TIER_RANK[lib.peek_tier(req.prompt.user_id, mid,
                                            replica=self.replica)]
                   for mid in _media_ids(req))

    def _top_up(self) -> None:
        """Keep the front ``PREFETCH_DEPTH`` requests' loads in flight,
        issuing the window's slowest tier first (admission order stays)."""
        if not self.pipelined:
            return
        window = [req for req in self.queue.peek(PREFETCH_DEPTH)
                  if req.req_id not in self._handles
                  and self._should_prefetch(req)]
        window.sort(key=self._slowest_tier_rank)
        for req in window:
            self._handles[req.req_id] = self._issue(req)

    def discard(self, req: Request) -> bool:
        """Take a waiting request out (deadline reaping, failover drain)
        and release its prefetch handle's pins; its fetches finish and
        retire on their own.  True if it was queued."""
        removed = self.queue.remove(req)
        handle = self._handles.pop(req.req_id, None)
        if handle is not None:
            handle.release()
        return removed

    # -- the compute stream ------------------------------------------------------
    @contextlib.contextmanager
    def compute_window(self):
        """Record one compute interval (a prefill or a decode step)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._compute_intervals.append((t0, time.perf_counter()))

    @staticmethod
    def _intersection_s(a_intervals: Iterable[Tuple[float, float]],
                        b_intervals: Iterable[Tuple[float, float]]) -> float:
        total = 0.0
        for a, b in a_intervals:
            for c, d in b_intervals:
                total += max(0.0, min(b, d) - max(a, c))
        return total

    def measure_overlap(self,
                        load_intervals: Iterable[Tuple[float, float]]) -> float:
        """Seconds during which a worker loaded these intervals while the
        engine was inside a compute window, minus the spans in which the
        engine was blocked on any request's load (no compute then)."""
        load_intervals = list(load_intervals)
        raw = self._intersection_s(load_intervals, self._compute_intervals)
        # the engine thread's blocked spans never overlap each other
        blocked = sum(self._intersection_s(load_intervals,
                                           h.blocked_intervals)
                      for h in self._recent_handles)
        return max(0.0, raw - blocked)

    def account(self, req: Request, handle: Optional[PrefetchHandle],
                policy_wall_s: float) -> None:
        """Fill the request's TTFT breakdown and overlap."""
        blocked_in_compute = 0.0
        if handle is not None:
            req.load_s = handle.load_busy_s
            req.load_blocked_s = handle.blocked_s
            req.overlap_s = self.measure_overlap(handle.intervals())
            # only blocking inside a compute window (a gather at link time)
            # dilutes the policy's wall time; the baseline's gather at pop
            # precedes it
            blocked_in_compute = self._intersection_s(
                handle.blocked_intervals, self._compute_intervals)
        req.compute_s = max(0.0, policy_wall_s - blocked_in_compute)

    def stats(self, finished: List[Request]) -> dict:
        """Aggregates for the engine's ``report()``."""
        if not finished:
            return {"admitted": self.admitted, "waiting": len(self.queue)}
        loaded = [r for r in finished if r.load_s > 0]

        def mean(attr):
            return float(np.mean([getattr(r, attr) for r in finished]))

        return {
            "admitted": self.admitted,
            "waiting": len(self.queue),
            "pipelined": self.pipelined,
            "prefetch_depth": PREFETCH_DEPTH,
            "chunked_prefills": sum(
                1 for r in finished if r.prefill_stats.get("chunks", 1) > 1),
            "mean_queue_wait_s": mean("queue_wait"),
            "mean_prefill_wall_s": mean("prefill_wall_s"),
            "mean_load_s": mean("load_s"),
            "mean_load_blocked_s": mean("load_blocked_s"),
            "mean_compute_s": mean("compute_s"),
            "mean_overlap_s": mean("overlap_s"),
            "mean_load_overlap_ratio": float(np.mean(
                [r.load_overlap_ratio for r in loaded])) if loaded else 0.0,
            "ttft_breakdown_s": {"queue": mean("queue_wait"),
                                 "load_blocked": mean("load_blocked_s"),
                                 "compute": mean("compute_s")},
        }


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

#: policies whose prefill is one pass over position-ordered tokens, which
#: causal masking lets split: chunk j sees only the KV of chunks < j and
#: the linked slots
CHUNKABLE_POLICIES = ("mpic", "full_recompute")


class ChunkedPrefillTask:
    """The prefill of one request, one chunk per engine step.

    The engine calls :meth:`advance` each step (inside a compute window of
    the scheduler) and decodes the other slots between chunks.  After the
    last chunk ``result`` holds a :class:`PolicyResult` of the monolithic
    policies' shape, with the dense cache that the engine splices into its
    pool or batch cache as it does theirs.  ``mpic`` links the prompt into
    a dense cache once (``link_prompt``) and runs its selected tokens
    through ``selective_prefill`` in chunks; ``full_recompute`` runs
    ``Model.prefill`` over each chunk's positions.
    """

    def __init__(self, model, params, req: Request, library, *,
                 kv_len: int, chunk_tokens: int, policy_name: str,
                 scheduler: PipelinedScheduler,
                 entries: Optional[PrefetchHandle] = None):
        self.req = req
        self.handle = entries
        self.result: Optional[PolicyResult] = None
        self.failed = False
        self.chunks_run = 0
        self._wall = 0.0
        self._scheduler = scheduler
        if policy_name == "mpic":
            self._gen = self._run_mpic(model, params, req, library, kv_len,
                                       chunk_tokens, entries)
        else:
            self._gen = self._run_full_recompute(model, params, req, kv_len,
                                                 chunk_tokens)

    @property
    def done(self) -> bool:
        return self.result is not None

    def advance(self) -> bool:
        """Run one chunk; True when the prefill is complete.  A chunk's
        exception propagates (the engine frees the slot) and marks the task
        failed, so that its dead generator is never advanced again."""
        if self.failed:
            raise RuntimeError(
                f"prefill task for {self.req.req_id} already failed")
        t0 = time.perf_counter()
        with self._scheduler.compute_window():
            try:
                next(self._gen)
            except StopIteration:
                pass
            except BaseException:
                self.failed = True
                raise
            finally:
                self._wall += time.perf_counter() - t0
        if self.result is not None:
            self.result.stats["wall_s"] = self._wall
        return self.done

    def _finish(self, logits, cache, stats: dict) -> None:
        # the host read waits for the chunk's device work
        self.result = PolicyResult(
            _first_logits(logits), cache,
            {**stats, "engine_steps": self.chunks_run,
             "chunks": self.chunks_run, "wall_s": 0.0})

    def _run_mpic(self, model, params, req, library, kv_len, chunk, entries):
        k = req.policy_kwargs.get("k", 32)
        prompt = req.prompt
        selection = sel_mod.mpic_selection(prompt, k)
        if int(selection.sum()) == 0:
            # nothing selected (an all-media prompt at k = 0): the
            # monolithic policy, before any link, so nothing links twice
            self.result = POLICIES["mpic"](model, params, prompt, library,
                                           k=k, kv_len=kv_len,
                                           entries=entries)
            return
        link = link_prompt(model, prompt, library, selection, kv_len=kv_len,
                           device=params.embed.device, entries=entries,
                           sharding=params.sharding)
        n = len(link.sel_idx)
        for a in range(0, n, chunk):
            # each chunk writes its K/V into link.cache for the next ones
            logits, cache = _selective_step(model, params, link,
                                            slice(a, a + chunk))
            self.chunks_run += 1
            if a + chunk < n:
                yield       # an engine step: the running slots decode
        self._finish(logits, cache, {
            "policy": f"mpic-{k}", "n_recomputed": link.n_recomputed,
            "n_reused": link.n_reused, "misses": link.misses})

    def _run_full_recompute(self, model, params, req, kv_len, chunk):
        prompt = req.prompt
        total = prompt.total_len
        dev = params.embed.device
        toks, mask, emb = _full_prompt_arrays(model, prompt, dev)
        cache = model.make_cache(1, kv_len, device=dev)
        for a in range(0, total, chunk):
            b = min(a + chunk, total)
            pos = torch.arange(a, b, dtype=torch.int32, device=dev)[None]
            logits, cache = model.prefill(
                params, toks[:, a:b], cache, media_embeds=emb[:, a:b],
                media_mask=mask[:, a:b], positions=pos, write_idx=pos)
            self.chunks_run += 1
            if b < total:
                yield
        self._finish(logits, cache, {
            "policy": "full_recompute", "n_recomputed": total,
            "n_reused": 0})
