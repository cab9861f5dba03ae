"""MPIC serving engine (port of the JAX package's ``serving/engine.py``).

The paper's request flow, with continuous batching over fixed slots:

  1. ``upload``   user file -> ``precompute_media_kv`` -> static library
                  (``dynamic=True``: the shared MRAG library + retriever)
  2. ``submit``   a query with media references joins the waiting queue
                  of the pipelined scheduler, which starts loading the
                  media KV of the next ``PREFETCH_DEPTH`` queued requests
                  on the loader's threads while the engine computes
  3. admission    up to ``max_prefills_per_step`` requests a step into free
                  slots; each request's policy (``mpic``, ``cacheblend``,
                  ``full_reuse``, ``prefix_caching`` or ``full_recompute``)
                  links the stored media KV, gathered per media id from its
                  prefetch handle, and runs the prefill, which gives the
                  first token
  4. MRAG         retrieved dynamic-library KV is relinked after the prompt
  5. decode       every step advances all running slots by one token

Two batch caches:

* **paged** (``EngineConfig.paged=True``, the default): a
  :class:`~repro_torch.cache.paged.PagedKVPool`, bf16 (the model's compute
  dtype) or int8 (``pool_dtype="int8"``).  Admission reserves the prompt's
  pages (every slot owns its whole ``max_seq_len`` region, so a free slot
  always has room).  ``mpic`` and ``cacheblend`` link and prefill straight
  into those pages (``link_paged``, ``PagedPrefiller``); the other policies
  build a dense per-request cache, which is spliced into the pages
  (``_splice_paged``, quantized on an int8 pool).  Decode is one paged step
  over the pool.
* **dense** (``paged=False``, or a model without paged decode: the SSM
  and the hybrid): one ``(L, slots, max_seq_len, Hkv, Dh)`` cache plus
  ``pos``, the SSM's per-slot recurrent state, or, for a hybrid, both;
  every policy builds a dense per-request cache, which is spliced into its
  slot's row, every key of it, and decode is ``Model.decode_step`` over
  the whole batch.  It has no int8 form.

An SSM's state, and a hybrid's SSM half, depend on the whole prefix, so
their K/V cannot be reused position-independently: ``mpic``,
``cacheblend`` and ``full_reuse`` requests are served as
``full_recompute`` and never chunked (the JAX engine's
``_resolve_policy`` and ``_chunkable``), and the prefill runs the SSD
chunk kernel.

Every cache is written in place.  On the card, attention runs in the
port's CUDA kernels: the paged prefill and decode kernels on the pool, the
dense selective attention everywhere else (uploads, the dense prefills,
the dense decode step).

The static library (``KVLibrary``) may keep media KV on disk
(``spool_dir``) and store it int8 (``quantize=True``, which the int8 pool
links straight from the int8 bytes).  ``pipelined=False`` loads a
request's media when it is admitted, before its compute: the sequential
baseline.  ``report()["scheduler"]`` gives each request's load, blocked,
compute and overlap seconds.

``prefill_chunk_tokens > 0`` splits an ``mpic`` or ``full_recompute``
prefill longer than that into chunks, one per engine step
(:class:`~repro_torch.serving.scheduler.ChunkedPrefillTask`), so that the
running slots decode between them; the result is spliced as a monolithic
dense result is.  ``greedy=False`` samples each token from the
temperature-scaled top-k softmax with a numpy generator seeded by
``Request.seed``, one per request, as the JAX engine does.

``faults`` (a :class:`~repro_torch.cache.faults.FaultPlan`) reaches the
default static library's tiers and loader, and the ``engine.step`` site
(target ``f"replica{replica_id}"``): ``crash`` raises
:class:`~repro_torch.cache.faults.ReplicaCrash` at the top of
:meth:`MPICEngine.step`, before any per-request work, so the engine's
state stays as the last whole step left it.

**Deadlines and replicas.**  A request's ``deadline_s`` is reaped at the
top of every step and at admission (terminal ``DEADLINE``, in
``expired``): a waiting request leaves the queue with its prefetch pins
released, a chunked prefill and a decoding slot free their pages.  A
cluster (``serving/cluster.py``) runs several engines as replicas over
one static library, one dynamic library, one retriever and one loader
(``replica_id=``, ``loader=``; fetches and warmth are tagged with the
replica); it routes by ``load_info`` and ``has_work``, and after a crash
:meth:`MPICEngine.drain_for_failover` hands back every request the
replica held, reset to ``WAITING`` with its pages and pins freed.  The
replicas share one model module and its weights (eager PyTorch compiles
nothing per replica, so there is nothing else to share).

Sessions (``engine.sessions``, :mod:`repro_torch.serving.sessions`):
``freeze`` snapshots a decoding request into the static library and frees
its slot, ``thaw`` resumes it (with an optional next-turn suffix) and
``fork`` thaws one snapshot into children that share its pages; a
request's ``freeze_after`` freezes it (and spools the snapshot) once that
many tokens are out, and ``freeze_idle_s > 0`` spools snapshots idle that
long.  A write into a page that a fork still shares copies the page first
(the MRAG link and the decode step).  Paged engines only.

**Tensor parallelism.**  ``mesh=`` (a
:class:`~repro_torch.launch.mesh.ServingMesh`, one process per rank of
the mesh) serves the model cut over the ranks, as the JAX
engine's ``mesh`` does: every rank builds this engine over the same
whole model and the whole weights or its shard of them
(``init_params(sharding=)``), uploads and submits the same work, and runs
the same loop; the plan (:class:`~repro_torch.serving.sharding.
ServingSharding`) sets the shapes, for every family (a MoE's experts,
the SSM's and hybrid's SSD heads, whisper's encoder-decoder too).  The
pool and the dense cache are allocated at the rank's kv heads (and SSD
heads), the kernels run on them unchanged, the passes meet in
``all_reduce`` and ``all_gather``, and every rank samples the same token
from the gathered logits.  Library entries stay whole: an
upload gathers its heads, a link reads the rank's, and a session's
snapshot gathers its pages' heads (and an int8 pool's scale rows) into a
whole block, which a thaw or a fork reads the rank's heads of.  Rank 0
decides every outcome that reads a clock, a disk or a peer, and
broadcasts it on the engine's thread: deadlines, the aged queue order,
the libraries' expiries, spools, disk reads and peer pulls
(:meth:`KVLibrary.sync` every step and upload, :meth:`KVLibrary.agree`
at each lookup a prefill or a thaw consumes; see ``cache/library.py``),
the idle sweep's choice and a new session's name and salt.  Rank 0 alone
writes the spool, which the ranks share (one host); the others read it.
The decisions that read the request stream (admission, cacheblend's
picks, from summed deviations) agree by construction.  A rank that cannot
follow rank 0 makes every rank raise together
(:class:`~repro_torch.cache.library.RankDivergence`).

**The data axis.**  On a ``data D x model M`` mesh (D·M processes, world
rank ``d·M + m``) every rank still runs the same loop over the same
submissions and holds model shard ``m``; it decodes the slots of data
shard ``d`` (``ServingSharding.slot_range``: the d-th of D equal parts
where D divides ``decode_slots``, else every slot).  Admission, the page
tables and every host decision stay whole on every rank; a prefill
(batch 1) runs on every data rank.  The paged pool is whole over
``data``: a decode step runs the rank's slots, then its new K/V rows
(an int8 pool's before they are quantized) are gathered over ``data`` in
one collective for all layers and every rank writes every slot's rows
(``decode_paged``'s ``slot_writes``), so every data rank's pool stays
equal to the others'.  The dense cache holds the rank's slots' rows; a
splice, an MRAG link and a release touch the row only on the rank that
holds it.  The step's logits rows are gathered over ``data``, so every
rank picks every slot's token, seeded generators included.  World rank
0 decides what rank 0 decides above.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache.faults import ReplicaCrash
from repro_torch.cache.library import KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.cache.transfer import ParallelLoader, PrefetchHandle
from repro_torch.core.linker import bucket, precompute_media_kv, scale_row_ids
from repro_torch.core.paged_prefill import PagedPrefiller
from repro_torch.core.policies import POLICIES, PolicyResult, PrefixStore
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import agree
from repro_torch.models.layers import INVALID_POS, rope_relink
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever
from repro_torch.serving.sessions import SessionHandle, SessionStore
from repro_torch.serving.sharding import ServingSharding
from repro_torch.serving.scheduler import (
    CHUNKABLE_POLICIES,
    ChunkedPrefillTask,
    PipelinedScheduler,
)


@dataclasses.dataclass
class EngineConfig:
    max_seq_len: int = 512          # kv region per slot
    decode_slots: int = 4           # continuous-batching capacity
    page_size: int = 16             # tokens per KV page
    pool_dtype: str = ""            # "" -> model compute dtype; "int8"
                                    # (paged engines only)
    paged: bool = True              # page pool; False -> dense batch cache
    max_prefills_per_step: int = 1  # admissions per engine step
    pipelined: bool = True          # False -> sequential admission baseline
    prefill_chunk_tokens: int = 0   # > 0: chunk long prefills across steps
    greedy: bool = True             # False -> temperature / top-k sampling
    temperature: float = 1.0        # sampling temperature (greedy=False)
    top_k: int = 0                  # sample from the top k logits (0: all)
    freeze_idle_s: float = 0.0      # > 0: spool frozen sessions idle this
                                    # long (seconds), checked every step
    queue_aging_s: float = 0.0      # > 0: priority aging of the waiting
                                    # queue (one level per this many seconds)


class MPICEngine:
    def __init__(self, model, params, engine_cfg: Optional[EngineConfig] = None,
                 *, static_library: Optional[KVLibrary] = None,
                 dynamic_library: Optional[KVLibrary] = None,
                 retriever: Optional[Retriever] = None, device=None,
                 faults=None, replica_id: Optional[int] = None,
                 loader: Optional[ParallelLoader] = None, mesh=None):
        """``device`` None means the card, and raises without one; pass
        ``"cpu"`` to serve with the kernels' plain versions.  ``params``
        must already live on that device.  A cluster passes its shared
        libraries, ``retriever`` and ``loader`` and a distinct
        ``replica_id`` to each replica; ``replica_id=None`` keeps the
        single-engine accounting.  ``mesh`` serves tensor-parallel (see
        the module's notes): ``model`` is the whole model, ``params`` the
        whole weights or this rank's shard, on the mesh's device, which
        ``device`` defaults to."""
        self.mesh = mesh
        self.cfg = engine_cfg or EngineConfig()
        if mesh is not None:
            plan = ServingSharding(mesh, model.cfg)
            device = mesh.device if device is None else device
            params = plan.shard(params)
            model = plan.local_model()
        self.device = resolve_device(device)
        self.replica_id = replica_id
        self.model = model
        self.params = params
        if self.cfg.pool_dtype not in ("", "int8"):
            raise ValueError(f"pool_dtype {self.cfg.pool_dtype!r}: "
                             "use '' (compute dtype) or 'int8'")
        self.faults = faults
        self.static_lib = static_library or KVLibrary(faults=faults,
                                                      mesh=mesh)
        self.dynamic_lib = dynamic_library or KVLibrary(shared=True,
                                                        mesh=mesh)
        if mesh is not None:
            for lib in (self.static_lib, self.dynamic_lib):
                lib.attach_mesh(mesh)
        self.retriever = retriever if retriever is not None else Retriever()
        self.loader = loader if loader is not None else ParallelLoader(
            self.static_lib, replica=replica_id)
        self.scheduler = PipelinedScheduler(
            self.loader, pipelined=self.cfg.pipelined,
            prefetch_filter=self._policy_consumes_entries,
            replica=replica_id, aging_s=self.cfg.queue_aging_s, mesh=mesh)
        self.running: List[Optional[Request]] = [None] * self.cfg.decode_slots
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.expired: List[Request] = []        # DEADLINE: reaped
        self.frozen: List[Request] = []         # FROZEN by freeze()
        self.decode_step_s: List[float] = []    # wall time of each decode step
        # slot -> its chunked prefill in progress
        self._prefill_tasks: Dict[int, ChunkedPrefillTask] = {}
        # request id -> its sampling generator (greedy=False)
        self._rngs: Dict[str, np.random.Generator] = {}
        # token prefix -> KV, read by ``prefix_caching``; empty until the
        # caller stores a prefix (the system prompt, say)
        self.prefix_store = PrefixStore()

        self._paged = self.cfg.paged and model.supports_paged_decode()
        if self.cfg.pool_dtype == "int8" and not self._paged:
            # the dense cache has no scale buffers and no dequantizing read
            raise ValueError(
                "pool_dtype='int8' requires the paged KV pool: set "
                "EngineConfig.paged=True and use an attention arch that "
                "supports paged decode (the dense cache carries no "
                "per-page scales)")
        self.pool = None
        self._prefiller = None
        self._batch_cache = None
        # the slots this rank decodes (every slot without a data axis)
        self._own = (self.sharding.slot_range(self.cfg.decode_slots)
                     if mesh is not None else (0, self.cfg.decode_slots))
        if self._paged:
            self._init_pool()
        else:
            # a data rank holds its own slots' rows
            self._batch_cache = model.make_cache(
                self._own[1], self.cfg.max_seq_len, device=self.device)
        self.sessions = SessionStore(self)
        if self._paged:
            # the pool's copy-on-write gauges in the library's stats, held
            # weakly: a library that outlives this engine must not keep its
            # pool (gigabytes on the card) alive
            pool_ref = weakref.ref(self.pool)

            def gauges():
                pool = pool_ref()
                return {} if pool is None else {
                    "cow_copies": pool.cow_copies,
                    "pages_shared": pool.pages_shared}

            self.static_lib.add_session_source(gauges)

    @property
    def sharding(self):
        """The tensor-parallel plan (the one the rank's parameters carry),
        or None."""
        return self.params.sharding

    def _sync_libraries(self) -> None:
        """World rank 0's changes to both libraries' placement on every
        rank, in one broadcast (:meth:`KVLibrary.sync`)."""
        if self.mesh is None:
            return
        libs = (self.static_lib, self.dynamic_lib)
        states = self.mesh.broadcast_object([lib.sync_state() for lib in libs])
        for lib, state in zip(libs, states):
            lib.apply_sync(state)

    def _init_pool(self) -> None:
        mcfg = self.model.cfg
        ps = self.cfg.page_size
        self._pages_per_slot = -(-self.cfg.max_seq_len // ps)
        # every slot's whole region, plus the scratch page
        self.pool = PagedKVPool(PagedConfig(
            num_pages=self.cfg.decode_slots * self._pages_per_slot + 1,
            page_size=ps, num_layers=mcfg.num_layers,
            num_kv_heads=mcfg.num_kv_heads, head_dim=mcfg.head_dim,
            dtype=self.cfg.pool_dtype or mcfg.compute_dtype),
            device=self.device)
        # scratch page: absorbs padding writes (idle slots, bucket pads,
        # splice tails) so real pages are never aliased
        self._scratch_page = int(self.pool.alloc("__scratch__", 1)[0])
        self._page_tables = np.full(
            (self.cfg.decode_slots, self._pages_per_slot),
            self._scratch_page, np.int32)
        self._prefiller = PagedPrefiller(self.model, self.pool,
                                         self._scratch_page)

    @property
    def queue(self):
        """The scheduler's waiting queue."""
        return self.scheduler.queue

    waiting = queue         # the JAX engine's name for it

    def close(self) -> None:
        """Stop the loader's worker threads."""
        self.loader.close()

    # ------------------------------------------------------------------
    # workflow 1: upload -> precompute KV -> store
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def upload(self, user_id: str, media_id: str, embeds: np.ndarray, *,
               ttl: float = float("inf"), dynamic: bool = False) -> None:
        k, v = precompute_media_kv(
            self.model, self.params,
            torch.as_tensor(np.asarray(embeds, np.float32),
                            device=self.device))
        lib = self.dynamic_lib if dynamic else self.static_lib
        lib.put(user_id, media_id, k, v, ttl=ttl)
        lib.sync()
        if dynamic:
            self.retriever.add(media_id, embeds)

    # ------------------------------------------------------------------
    # workflow 2: submit a query
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        total = request.prompt.total_len
        if total + 1 >= self.cfg.max_seq_len:
            raise ValueError(f"prompt of {total} tokens exceeds the slot's "
                             f"kv region ({self.cfg.max_seq_len})")
        self.scheduler.enqueue(request)
        return request

    # ------------------------------------------------------------------
    # engine step: advance chunked prefills, admit, decode running slots
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        if self.faults is not None:
            # "replicaNone" outside a cluster, as in the JAX engine, so that
            # one plan fires alike in both packages
            rule = self.faults.check("engine.step",
                                     f"replica{self.replica_id}")
            if rule is not None and rule.kind == "crash":
                raise ReplicaCrash(
                    f"injected crash on replica {self.replica_id} "
                    f"({rule.describe()})")
        self._reap_deadlines()
        self._sync_libraries()
        self._advance_prefills()
        self._admit()
        self._decode()
        if self.cfg.freeze_idle_s > 0:
            self.sessions.sweep_idle(self.cfg.freeze_idle_s)

    # -- session store delegates (serving/sessions.py) ---------------------
    @torch.inference_mode()
    def freeze(self, req_id: str, *, spool: bool = False) -> SessionHandle:
        """Snapshot a decoding request into the static library and free its
        slot: :meth:`SessionStore.freeze`."""
        return self.sessions.freeze(req_id, spool=spool)

    @torch.inference_mode()
    def thaw(self, handle: SessionHandle, suffix_tokens=None, *,
             max_new_tokens: Optional[int] = None) -> Request:
        """Resume a frozen session in a free slot, optionally after the
        next turn's suffix: :meth:`SessionStore.thaw`."""
        return self.sessions.thaw(handle, suffix_tokens,
                                  max_new_tokens=max_new_tokens)

    @torch.inference_mode()
    def fork(self, handle: SessionHandle, n: int, *,
             max_new_tokens: Optional[int] = None) -> List[Request]:
        """Thaw one snapshot into ``n`` children sharing its pages
        (copy-on-write): :meth:`SessionStore.fork`."""
        return self.sessions.fork(handle, n, max_new_tokens=max_new_tokens)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(self.running)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def _free_slot(self) -> int:
        for i, r in enumerate(self.running):
            if r is None:
                return i
        return -1

    def _admit(self) -> None:
        """Admit up to ``max_prefills_per_step`` requests into free slots
        (a free slot owns its whole page region, so it always has room).
        A request past its deadline is reaped instead, without a slot."""
        admitted = 0
        while self.queue and admitted < self.cfg.max_prefills_per_step:
            slot = self._free_slot()
            if slot < 0:
                return
            req, handle = self.scheduler.pop()
            if req.req_id in self._expired([req]):
                if handle is not None:
                    handle.release()
                self._expire(req)
                continue
            self._begin_prefill(req, slot, handle)
            admitted += 1

    def _resolve_policy(self, req: Request) -> str:
        """The policy a request runs: an SSM or a hybrid needs its whole
        prefix, so the policies that reuse media KV become
        ``full_recompute``."""
        if self._prefix_only and req.policy in (
                "mpic", "cacheblend", "full_reuse"):
            return "full_recompute"
        return req.policy

    @property
    def _prefix_only(self) -> bool:
        return self.model.cfg.arch_type in ("ssm", "hybrid")

    def _policy_consumes_entries(self, req: Request) -> bool:
        """Does the request's resolved policy link library entries?  Only
        those requests get their media prefetched."""
        return self._resolve_policy(req) in ("mpic", "cacheblend",
                                             "full_reuse")

    def _chunkable(self, req: Request, policy_name: str) -> bool:
        chunk = self.cfg.prefill_chunk_tokens
        return (chunk > 0 and policy_name in CHUNKABLE_POLICIES
                and not self._prefix_only
                and req.prompt.total_len > chunk)

    def _refusal(self, req: Request, policy_name: str) -> Optional[str]:
        """Why the engine cannot serve ``req`` under ``policy_name``, or
        None.  An encoder-decoder's linked cache would lack the cross K/V
        its layers read (the JAX engine raises ``KeyError: 'cross_k'``
        there); ``full_recompute`` and ``prefix_caching`` build their cache
        with ``make_cache`` and serve it, its cross K/V zeros (a text-only
        request carries no audio)."""
        if policy_name not in POLICIES:
            return (f"unknown policy {req.policy!r} "
                    f"(ported: {sorted(POLICIES)})")
        if self.model.cfg.is_encoder_decoder and policy_name in (
                "mpic", "cacheblend", "full_reuse"):
            return (f"{policy_name} links media KV into a decoder cache "
                    f"that has no cross-attention K/V, which every layer "
                    f"of the encoder-decoder {self.model.cfg.name} reads; "
                    "serve it with full_recompute or prefix_caching")
        return None

    def _begin_prefill(self, req: Request, slot: int,
                       handle: Optional[PrefetchHandle]) -> None:
        policy_name = self._resolve_policy(req)
        refusal = self._refusal(req, policy_name)
        if refusal is not None:
            # a request the engine cannot serve fails, the engine keeps
            # serving
            req.state = State.FAILED
            req.error = refusal
            self.failed.append(req)
            if handle is not None:
                handle.release()
            return
        policy = POLICIES[policy_name]
        req.slot = slot
        req.state = State.PREFILLING
        self.running[slot] = req
        if self._paged:
            # the prompt's pages now: a chunked prefill holds its slot for
            # several steps
            pages = self.pool.alloc(req.req_id, req.prompt.total_len + 1)
            self._set_page_row(slot, pages)
        try:
            if self._chunkable(req, policy_name):
                task = ChunkedPrefillTask(
                    self.model, self.params, req, self.static_lib,
                    kv_len=self.cfg.max_seq_len,
                    chunk_tokens=self.cfg.prefill_chunk_tokens,
                    policy_name=policy_name, scheduler=self.scheduler,
                    entries=handle)
                self._prefill_tasks[slot] = task
                if task.advance():          # the first chunk runs now
                    del self._prefill_tasks[slot]
                    self._finalize_prefill(req, task.result, handle)
                return
            # mpic / cacheblend link and prefill straight into the pages;
            # the other policies build a dense cache that is spliced in
            paged_ctx = None
            if self._paged and policy_name in ("mpic", "cacheblend"):
                paged_ctx = self._prefiller.bind(self._page_tables[slot])
            # one compute window; the linker gathers the request's entries
            # from its handle at link time.  It closes after the first
            # token's logits reach the host, i.e. after the device work
            with self.scheduler.compute_window():
                result = policy(self.model, self.params, req.prompt,
                                self.static_lib, kv_len=self.cfg.max_seq_len,
                                prefix_store=self.prefix_store,
                                entries=handle, paged=paged_ctx,
                                **req.policy_kwargs)
            self._finalize_prefill(req, result, handle)
        except BaseException as exc:
            self._abort_prefill(slot, handle, repr(exc))
            raise

    def _advance_prefills(self) -> None:
        """Run the next chunk of every chunked prefill in progress."""
        for slot, task in list(self._prefill_tasks.items()):
            try:
                if task.advance():
                    del self._prefill_tasks[slot]
                    self._finalize_prefill(task.req, task.result, task.handle)
            except BaseException as exc:
                self._abort_prefill(slot, task.handle, repr(exc))
                raise

    def _abort_prefill(self, slot: int, handle: Optional[PrefetchHandle],
                       error: str, *, state: State = State.FAILED,
                       sink: Optional[List[Request]] = None) -> None:
        """Take the request in ``slot`` off it and free what it held: its
        handle's pins, its chunked task, its pages and its sampling
        generator (a resubmit replays from ``Request.seed``).  By default
        it fails (in ``failed``), its error the caller's to see; deadline
        reaping and the failover drain pass another ``state`` and
        ``sink``."""
        if handle is not None:
            handle.release()
        self._prefill_tasks.pop(slot, None)
        req = self.running[slot]
        if req is not None:
            req.state = state
            req.error = error
            req.t_done = time.perf_counter()
            (self.failed if sink is None else sink).append(req)
            self._release(req)

    # -- deadlines and failover ----------------------------------------------
    def _expire(self, req: Request) -> None:
        """The terminal ``DEADLINE`` transition (resources already free)."""
        req.state = State.DEADLINE
        req.error = f"deadline exceeded ({req.deadline_s:.3f}s)"
        req.t_done = time.perf_counter()
        self.expired.append(req)

    def _expired(self, reqs: List[Request]) -> set:
        """The ids of ``reqs`` past their deadlines now; under a mesh, rank
        0's clock decides for every rank."""
        now = time.perf_counter()
        ids = {r.req_id for r in reqs if r.past_deadline(now)}
        if any(r.deadline_s is not None for r in reqs):
            ids = agree(self.mesh, ids)
        return ids

    def _reap_deadlines(self) -> None:
        """Expire every request past its deadline: waiting ones leave the
        queue with their prefetch pins released, a chunked prefill aborts
        through :meth:`_abort_prefill`, a decoding slot frees its pages and
        keeps its partial output on the request."""
        expired = self._expired(
            list(self.queue) + [r for r in self.running if r is not None])
        for req in [r for r in self.queue if r.req_id in expired]:
            self.scheduler.discard(req)
            self._expire(req)
        for slot, r in enumerate(self.running):
            if r is None or r.req_id not in expired:
                continue
            if r.state is State.PREFILLING:
                task = self._prefill_tasks.get(slot)
                self._abort_prefill(
                    slot, task.handle if task is not None else None,
                    f"deadline exceeded ({r.deadline_s:.3f}s)",
                    state=State.DEADLINE, sink=self.expired)
            else:
                self._release(r)
                self._expire(r)

    @staticmethod
    def _reset_for_resubmit(req: Request) -> None:
        """A drained request back to a fresh ``WAITING`` state for another
        replica; ``t_arrival`` stays, so a deadline's clock runs on."""
        req.state = State.WAITING
        req.error = None
        req.slot = req.replica = -1
        req.output_tokens = []
        req.cur_len = 0
        req.t_admitted = req.t_first_token = req.t_done = 0.0
        req.prefill_stats = {}
        req.linked_media = []
        req.load_s = req.load_blocked_s = 0.0
        req.compute_s = req.overlap_s = 0.0

    def drain_for_failover(self) -> List[Request]:
        """Strip every request that is not terminal off this replica after
        a crash: chunked prefills and decoding slots abort through
        :meth:`_abort_prefill` (pages freed, pins released), waiting ones
        leave through ``scheduler.discard``.  Returns them reset to
        ``WAITING``, chunked prefills and slots first, then the queue in
        admission order."""
        reclaim: List[Request] = []
        for slot in list(self._prefill_tasks):
            self._abort_prefill(slot, self._prefill_tasks[slot].handle,
                                "replica failover", sink=reclaim)
        for slot, r in enumerate(self.running):
            if r is not None:
                self._abort_prefill(slot, None, "replica failover",
                                    sink=reclaim)
        queued = list(self.queue)
        for req in queued:
            self.scheduler.discard(req)
        out = reclaim + queued
        for req in out:
            self._reset_for_resubmit(req)
        return out

    def _finalize_prefill(self, req: Request, result: PolicyResult,
                          handle: Optional[PrefetchHandle] = None) -> None:
        req.prefill_stats = result.stats
        req.linked_media = [seg.media_id
                            for _, seg in req.prompt.media_segments()]
        req.output_tokens.append(self._select_token(
            req, np.asarray(result.first_logits, np.float32)))
        req.t_first_token = time.perf_counter()
        req.cur_len = req.prompt.total_len
        req.state = State.RUNNING
        self.scheduler.account(req, handle, result.stats.get("wall_s", 0.0))
        if handle is not None:
            # the entries are linked: the library may demote them again
            handle.release()
        # a dense result cache goes into the slot's pages or its row of the
        # dense batch cache; a paged prefill left nothing to splice
        if result.cache is not None:
            if self._paged:
                self._splice_paged(req.slot, result.cache, req.cur_len + 1)
            else:
                self._dense_splice(req.slot, result.cache)
        # workflow 4: MRAG, link retrieved KV position-independently with no
        # recompute of the existing cache
        if req.retrieval_query is not None:
            self._mrag_link(req)

    def _set_page_row(self, slot: int, pages: np.ndarray) -> None:
        row = np.full((self._pages_per_slot,), self._scratch_page, np.int32)
        row[:len(pages)] = pages
        self._page_tables[slot] = row

    def _splice_paged(self, slot: int, rc: dict, n_tokens: int) -> None:
        """Write a dense per-request cache into the slot's pages, with one
        pool write of ``bucket(n_tokens, 1)`` rows (quantizing on an int8
        pool).  Rows past the slot's owned pages land on the scratch page;
        owned slots past ``n_tokens`` may keep a previous tenant's KV,
        which every read masks by length."""
        b = min(bucket(n_tokens, 1), rc["k"].shape[2])
        self.pool.write_tokens(self._page_tables[slot], 0,
                               rc["k"][:, 0, :b], rc["v"][:, 0, :b])

    def _row(self, slot: int) -> Optional[int]:
        """Slot ``slot``'s row of this rank's dense batch cache, or None
        when another data rank holds it."""
        lo, n = self._own
        return slot - lo if lo <= slot < lo + n else None

    def _dense_splice(self, slot: int, rc: dict) -> None:
        """Copy every key of a per-request cache (batch 1) into row
        ``slot`` of the dense batch cache: K/V and ``pos``, an SSM's
        state, or both for a hybrid, so no row keeps a previous tenant's
        state.  On a data axis only the rank that holds the slot writes
        (every rank ran the replicated prefill)."""
        row = self._row(slot)
        if row is None:
            return
        bc = self._batch_cache
        for key, buf in bc.items():
            if key == "pos":
                buf[row] = rc["pos"][0]
            else:
                buf[:, row] = rc[key][:, 0]

    def _dense_link(self, slot: int, k_seg, v_seg, off: int) -> None:
        """Link one MRAG segment (L, n, Hkv, Dh), stored at position 0, at
        positions ``off ..`` of row ``slot`` of the dense batch cache.  A
        hybrid's SSM state stays as the prompt left it (the JAX engine's
        link writes K/V and positions only)."""
        slot = self._row(slot)
        if slot is None:
            return
        bc = self._batch_cache
        n = k_seg.shape[1]
        theta = self.model.cfg.rope_theta
        if theta:
            k_seg = rope_relink(k_seg, torch.full(
                (n,), off, dtype=torch.int32, device=self.device), theta)
        bc["k"][:, slot, off:off + n] = k_seg
        bc["v"][:, slot, off:off + n] = v_seg
        bc["pos"][slot, off:off + n] = torch.arange(
            off, off + n, dtype=torch.int32, device=self.device)

    def _mrag_link(self, req: Request) -> None:
        hits = self.retriever.query(req.retrieval_query, req.retrieval_top_k)
        for media_id, _score in hits:
            # pinned while linked: a spool must not free the tensors
            entry = self.dynamic_lib.get_agreed(
                req.prompt.user_id, media_id, replica=self.replica_id)
            if entry is None:
                continue
            try:
                entry.wait_loaded()
                length = (entry.qk.q if entry.qk is not None
                          else entry.payload.k).shape[1]
                off = req.cur_len
                if off + length + 1 >= self.cfg.max_seq_len:
                    break
                view = (entry if self.sharding is None
                        else self.sharding.entry(entry))
                if not self._paged:
                    self._dense_link(req.slot, view.k, view.v, off)
                elif not self._paged_link(req, view, length, off):
                    break                   # pool full: stop linking
            finally:
                self.dynamic_lib.unpin(entry)
            req.cur_len += length
            req.linked_media.append(media_id)

    def _paged_link(self, req: Request, entry, length: int, off: int) -> bool:
        """Link one MRAG segment (an entry, or a rank's view of it) at
        positions ``off ..`` of the request's pages; False when the pool
        cannot extend it."""
        pages = self.pool.extend(req.req_id, length, off)
        if pages is not None:
            # copy-on-write: the link writes [off, off + length), which may
            # hold a page a forked sibling still shares
            pages = self.pool.make_exclusive(req.req_id, off, length)
        if pages is None:
            return False
        self._set_page_row(req.slot, pages)
        ps = self.cfg.page_size
        t = off + np.arange(length)
        dev, cfg = self.device, self.model.cfg
        args = (torch.as_tensor(self._page_tables[req.slot][t // ps],
                                device=dev),
                torch.as_tensor((t % ps).astype(np.int32), device=dev))
        delta = torch.full((length,), off, dtype=torch.int32, device=dev)
        kw = dict(theta=cfg.rope_theta, relink=bool(cfg.rope_theta))
        qk, qv = entry.qk, entry.qv
        if (self.pool.quantized and qk is not None
                and qk.block_tokens == qv.block_tokens):
            # the library's int8 bytes rescale onto the page grid
            self.pool.link_write_q8(
                *args, qk.q, qk.scale, qv.q, qv.scale,
                torch.as_tensor(scale_row_ids(length, qk), device=dev),
                delta, **kw)
            self.dynamic_lib.note_direct_link(1)
        else:
            self.pool.link_write(*args, entry.k, entry.v, delta, **kw)
        return True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _select_token(self, req: Request, logits_row: np.ndarray) -> int:
        """Greedy argmax, or a draw from the temperature-scaled softmax
        over the top ``top_k`` logits (ties at the k-th value kept), in
        float64 with the request's own generator seeded by
        ``Request.seed``: the JAX engine's draw, bit for bit."""
        if self.cfg.greedy:
            return int(np.argmax(logits_row))
        rng = self._rngs.setdefault(req.req_id,
                                    np.random.default_rng(req.seed))
        z = logits_row.astype(np.float64)
        if 0 < self.cfg.top_k < z.size:
            kth = np.partition(z, -self.cfg.top_k)[-self.cfg.top_k]
            z = np.where(z < kth, -np.inf, z)
        z = z / max(self.cfg.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(z.size, p=p))

    def _decode(self) -> None:
        live = [r for r in self.running
                if r is not None and r.state is State.RUNNING]
        if not live:
            return
        # the window closes after the logits reach the host
        with self.scheduler.compute_window():
            if self._paged:
                live, logits = self._decode_paged_step(live)
            else:
                logits = self._decode_dense_step(live)
        for r in live:
            r.output_tokens.append(self._select_token(r, logits[r.slot]))
            r.cur_len += 1
            if (r.freeze_after is not None and self._paged
                    and len(r.output_tokens) >= r.freeze_after):
                # a set freeze point: snapshot before this token is fed
                # (the thaw emits it again) and spool at once
                self.sessions.freeze(r.req_id, spool=True)
                continue
            if len(r.output_tokens) >= r.max_new_tokens or \
                    r.cur_len + 1 >= self.cfg.max_seq_len:
                self._finish(r)

    def _decode_dense_step(self, live: List[Request]) -> np.ndarray:
        """One decode step over the dense batch cache for every slot (a
        data rank: its own slots, their logits then gathered over
        ``data``).  Idle slots decode token 0 at position ``max_seq_len -
        1`` into that slot, so they see one key; their logits are
        dropped."""
        t0 = time.perf_counter()
        B = self.cfg.decode_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.full((B, 1), self.cfg.max_seq_len - 1, np.int32)
        for r in live:
            tokens[r.slot, 0] = r.output_tokens[-1]
            positions[r.slot, 0] = r.cur_len
        lo, n = self._own
        pos = torch.as_tensor(positions[lo:lo + n], device=self.device)
        logits, self._batch_cache = self.model.decode_step(
            self.params, torch.as_tensor(tokens[lo:lo + n],
                                         device=self.device), pos,
            self._batch_cache, pos)
        if self.sharding is not None:
            logits = self.sharding.gather_slots(logits.float(), B)
        logits = logits.float().cpu().numpy()
        self.decode_step_s.append(time.perf_counter() - t0)
        return logits

    def _decode_paged_step(self, live: List[Request]):
        """One decode step over the page pool for all live slots.

        The page table is cut to the live maximum page count, bucketed to
        the next power of two, so each step's attention work scales with
        the longest live cache, not with ``max_seq_len``.  Idle slots carry
        ``lengths == 0`` and write to the scratch page.
        """
        t0 = time.perf_counter()
        B, ps = self.cfg.decode_slots, self.cfg.page_size
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        wp = np.full((B,), self._scratch_page, np.int32)
        wo = np.zeros((B,), np.int32)
        for r in list(live):
            if self.pool.capacity(r.req_id) < r.cur_len + 1:
                pages = self.pool.extend(r.req_id, 1, r.cur_len)
                if pages is None:
                    # pool exhausted mid-decode: finish truncated rather
                    # than stall the whole batch
                    r.prefill_stats["truncated"] = True
                    self._finish(r)
                    live.remove(r)
                    continue
                self._set_page_row(r.slot, pages)
            row = self._page_tables[r.slot]
            if self.pool.page_ref(int(row[r.cur_len // ps])) > 1:
                # copy-on-write: this step writes into a page a forked
                # sibling still shares; copy it first
                pages = self.pool.make_exclusive(r.req_id, r.cur_len)
                if pages is None:
                    r.prefill_stats["truncated"] = True
                    self._finish(r)
                    live.remove(r)
                    continue
                self._set_page_row(r.slot, pages)
                row = self._page_tables[r.slot]
            tokens[r.slot, 0] = r.output_tokens[-1]
            positions[r.slot, 0] = r.cur_len
            lengths[r.slot] = r.cur_len + 1
            wp[r.slot] = row[r.cur_len // ps]
            wo[r.slot] = r.cur_len % ps
        if not live:
            return live, None
        mp_need = max(self.pool.pages_for(r.cur_len + 1) for r in live)
        mp = min(bucket(mp_need, 1), self._pages_per_slot)
        dev, pool = self.device, self.pool
        # a data rank runs its own slots; every slot's write goes to every
        # rank's copy of the pool (decode_paged's slot_writes)
        lo, n = self._own
        own = slice(lo, lo + n)
        slot_writes = None
        if n != B:
            slot_writes = (torch.as_tensor(wp, device=dev),
                           torch.as_tensor(wo, device=dev))
        logits = self.model.decode_step_paged(
            self.params, torch.as_tensor(tokens[own], device=dev),
            torch.as_tensor(positions[own], device=dev), pool.k, pool.v,
            torch.as_tensor(np.ascontiguousarray(
                self._page_tables[own, :mp]), device=dev),
            torch.as_tensor(lengths[own], device=dev),
            torch.as_tensor(wp[own], device=dev),
            torch.as_tensor(wo[own], device=dev),
            pool.k_scale, pool.v_scale, slot_writes=slot_writes)
        logits = logits.float().cpu().numpy()
        self.decode_step_s.append(time.perf_counter() - t0)
        return live, logits

    def _release(self, r: Request) -> None:
        self.running[r.slot] = None
        self._rngs.pop(r.req_id, None)
        if self._paged:
            self.pool.free(r.req_id)
            self._page_tables[r.slot] = self._scratch_page
        elif (r.slot >= 0 and "pos" in self._batch_cache
              and self._row(r.slot) is not None):
            # the row's K/V stay; marking every slot invalid empties it (an
            # SSM's or a hybrid's state stays too: the next splice, which
            # copies every key, overwrites it)
            self._batch_cache["pos"][self._row(r.slot)] = INVALID_POS
        r.slot = -1

    def _finish(self, r: Request) -> None:
        r.state = State.DONE
        r.t_done = time.perf_counter()
        self.finished.append(r)
        self._release(r)

    # ------------------------------------------------------------------
    # cluster hooks: the router and the backpressure read these
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        """Anything waiting, prefilling or decoding on this replica?"""
        return bool(self.queue or any(r is not None for r in self.running))

    def load_info(self) -> dict:
        """The load a router scores: free slots and pages, queue depth."""
        free_pages = self.pool.free_pages if self._paged else 0
        total_pages = self.pool.cfg.num_pages if self._paged else 0
        return {
            "replica": self.replica_id,
            "free_slots": sum(1 for r in self.running if r is None),
            "queue_depth": len(self.queue),
            "prefills_inflight": len(self._prefill_tasks),
            "free_pages": free_pages,
            "total_pages": total_pages,
        }

    # ------------------------------------------------------------------
    def report(self) -> dict:
        done = self.finished
        if not done:
            return {}
        ttfts = [r.ttft for r in done]
        steps = self.decode_step_s
        return {
            "replica": self.replica_id,
            "requests": len(done),
            "failed": len(self.failed),
            "expired": len(self.expired),
            "mean_ttft_s": float(np.mean(ttfts)),
            "p90_ttft_s": float(np.percentile(ttfts, 90)),
            "mean_prefill_s": float(np.mean(
                [r.t_first_token - r.t_admitted for r in done])),
            "decode_steps": len(steps),
            "mean_decode_step_s": float(np.mean(steps)) if steps else 0.0,
            "total_tokens": sum(len(r.output_tokens) for r in done),
            "paged": self._paged,
            "scheduler": self.scheduler.stats(done),
            # a cluster's replicas share one library: its report has it
            **({} if self.replica_id is not None
               else {"library": self.static_lib.stats()}),
        }
