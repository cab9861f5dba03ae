"""Session store: freeze, thaw and fork of live decode state (port of the
JAX package's ``serving/sessions.py``).

MPIC's position-independent relink makes a session's own KV, not just its
media's, cheap to keep: a decode slot's pages were written at the
request's live positions, so a snapshot adopts back as it is, with no
relink and no recompute, and the next turn's suffix runs through the
paged selective prefill.

``freeze(req_id) -> SessionHandle``
    Snapshot a RUNNING request's pages into the :class:`KVLibrary` as one
    block under a per-session ``cache_salt`` (mixed into the block's
    content key and scope digest, so it cannot be addressed without the
    handle), then free the slot.  The block rides every tier of the
    library: memory, the spool (``spool=True`` at once, or the idle
    sweep), a rehydrated spool after a restart, and the peers.  While it
    stays in memory it stays on the card; its bytes leave the card only
    when the library spools or serves it.

``thaw(handle, suffix_tokens=None) -> Request``
    Take a free slot, allocate pages, adopt the snapshot (an int8 one as
    raw page bytes and scale rows, so the pool is bit for bit the frozen
    one), restore the sampling generator, and resume decoding, or first
    prefill the new turn's suffix (:func:`~repro_torch.core.linker.
    session_suffix_link`).  A greedy resume gives the tokens of a session
    that was never frozen.

``fork(handle, n) -> [Request, ...]``
    Thaw one snapshot into ``n`` children that share its pages through the
    pool's refcounts: no page is copied at the fork, and a child's first
    write into a shared page copies that page alone
    (:meth:`~repro_torch.cache.paged.PagedKVPool.make_exclusive`).

``KVLibrary.note_session`` counts the events for ``stats()["sessions"]``,
beside the pool's ``cow_copies`` and ``pages_shared``.

Under a tensor-parallel mesh each rank's pool holds its kv heads: a freeze
gathers every rank's heads of the pages (and of an int8 pool's scale
rows) into one whole snapshot, the same block on every rank under rank
0's session name and salt, which spools in the unsharded format; a thaw
or a fork adopts the rank's heads of it.  The idle sweep spools what rank
0's clock finds idle.  Copy-on-write stays per rank.  A handle is
JSON-safe and means the same in both packages: the engines sample with
``np.random.default_rng(seed)``, so ``rng_state`` carries over.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cache.quant import QuantizedKV
from repro_torch.core.linker import session_suffix_link
from repro_torch.core.segments import Prompt, text_segment
from repro_torch.launch.mesh import agree
from repro_torch.serving.request import Request, State

SESSION_MEDIA_PREFIX = "__session__::"


def _new_salt() -> str:
    return os.urandom(8).hex()


@dataclasses.dataclass
class SessionHandle:
    """Everything needed to resume a frozen session, JSON-safe.  The KV is
    not here: it lives in the library under ``(user_id, media_id)`` and
    ``cache_salt``, and a host without the block pulls it from a peer at
    the first thaw."""
    session_id: str
    user_id: str
    media_id: str
    cache_salt: str
    n_ctx: int                      # tokens in the snapshot's KV
    output_tokens: List[int]        # the whole output at freeze time
    next_token: int                 # output_tokens[-1], not yet in the KV
    seed: int
    rng_state: Optional[dict]       # numpy generator state (None: greedy)
    pool_dtype: str
    page_size: int
    max_new_tokens: int             # the frozen request's budget
    frozen_at: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SessionHandle":
        d = dict(d)
        d["output_tokens"] = [int(t) for t in d.get("output_tokens", [])]
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})

    @property
    def remaining_tokens(self) -> int:
        """A thaw's default budget: the frozen request's tokens left, plus
        one, since the thawed request emits ``next_token`` again as its
        first output (sampled, never fed), so that ``frozen[:-1] + thawed
        == uninterrupted`` at equal budgets."""
        return max(1, self.max_new_tokens - len(self.output_tokens) + 1)


class SessionStore:
    """Freeze, thaw and fork against one engine's pool and static library
    (``engine.sessions``; the engine has ``freeze``/``thaw``/``fork``
    delegates).  The snapshots live in the library; this object keeps the
    handles and the salts."""

    def __init__(self, engine):
        self.engine = engine
        self.handles: Dict[str, SessionHandle] = {}
        self._salts: Dict[str, str] = {}
        self._spooled: set = set()      # sessions spooled to disk

    @property
    def _lib(self):
        return self.engine.static_lib

    def _require_paged(self) -> None:
        if not self.engine._paged:
            raise RuntimeError(
                "session freeze/thaw requires the paged KV pool "
                "(EngineConfig.paged=True on an attention arch)")

    def get(self, session_id: str) -> Optional[SessionHandle]:
        return self.handles.get(session_id)

    # -- freeze ------------------------------------------------------------
    def freeze(self, req_id: str, *, spool: bool = False) -> SessionHandle:
        """Snapshot a RUNNING request into the library and free its slot:
        the request becomes ``State.FROZEN`` with its output kept, and its
        pages, generator and slot are released.  ``spool=True`` also writes
        the snapshot to disk at once (``KVLibrary.spool_now``)."""
        self._require_paged()
        eng = self.engine
        req = next((r for r in eng.running
                    if r is not None and r.req_id == req_id), None)
        if req is None:
            raise KeyError(f"freeze: no running request {req_id!r}")
        if req.state is not State.RUNNING:
            raise ValueError(
                f"freeze: request {req_id!r} is {req.state.value}, "
                "only decoding (RUNNING) requests can freeze")

        # both random: under a mesh, rank 0's
        sid = req.session_id or f"sess-{os.urandom(6).hex()}"
        sid, salt = agree(eng.mesh, (sid, self._salts.get(sid,
                                                          _new_salt())))
        salt = self._salts.setdefault(sid, salt)
        media_id = SESSION_MEDIA_PREFIX + sid
        user_id = req.prompt.user_id
        n_ctx = req.cur_len
        pool = eng.pool

        snap = pool.export_session(eng._page_tables[req.slot], n_ctx)
        if eng.sharding is not None:
            # every rank's kv heads: the block is whole, as an upload's
            snap = {name: eng.sharding.gather_heads(t, 2)
                    for name, t in snap.items()}
        rng = eng._rngs.get(req.req_id)
        rng_state = rng.bit_generator.state if rng is not None else None

        if pool.quantized:
            # the wire format's scales are (L, blocks, H, Dh): each page's
            # row is repeated over Dh (exact) with one block a page, and a
            # thaw takes scale[..., 0] back
            def wire(q, rows):
                scale = rows[..., None].expand(
                    *rows.shape, pool.cfg.head_dim).contiguous()
                return QuantizedKV(q=q, scale=scale,
                                   block_tokens=pool.cfg.page_size)
            self._lib.put(user_id, media_id, salt=salt,
                          qk=wire(snap["qk"], snap["k_scale"]),
                          qv=wire(snap["qv"], snap["v_scale"]))
        else:
            self._lib.put(user_id, media_id, snap["k"], snap["v"],
                          salt=salt, raw=True)

        handle = SessionHandle(
            session_id=sid, user_id=user_id, media_id=media_id,
            cache_salt=salt, n_ctx=n_ctx,
            output_tokens=list(req.output_tokens),
            next_token=int(req.output_tokens[-1]),
            seed=req.seed, rng_state=rng_state,
            pool_dtype=pool.cfg.dtype, page_size=pool.cfg.page_size,
            max_new_tokens=req.max_new_tokens, frozen_at=time.time())

        eng._release(req)
        req.state = State.FROZEN
        req.session_id = sid
        eng.frozen.append(req)
        self.handles[sid] = handle
        self._spooled.discard(sid)
        self._lib.note_session(freezes=1)
        if spool and self._lib.spool_now(user_id, media_id):
            self._spooled.add(sid)
        return handle

    # -- thaw --------------------------------------------------------------
    def _fetch_snapshot(self, handle: SessionHandle) -> dict:
        """The snapshot from the library, any tier (a local miss asks the
        peers at the salted address), as the pool's snapshot dict; under a
        mesh rank 0's lookup, cut to the rank's kv heads."""
        e = self._lib.get_agreed(handle.user_id, handle.media_id,
                                 salt=handle.cache_salt)
        if e is None:
            raise LookupError(
                f"thaw: session snapshot {handle.session_id!r} not found "
                "in any tier (expired, deleted, or wrong salt)")
        try:
            e.wait_loaded()
            if e.payload.qk is not None:
                qk, qv = e.payload.qk, e.payload.qv
                snap = {"qk": qk.q, "qv": qv.q,
                        "k_scale": qk.scale[..., 0],
                        "v_scale": qv.scale[..., 0]}
            else:
                snap = {"k": e.payload.k, "v": e.payload.v}
            sharding = self.engine.sharding
            if sharding is not None:
                snap = {name: sharding.local_heads(t, 2)
                        for name, t in snap.items()}
            return snap
        finally:
            self._lib.unpin(e)

    def _check_pool(self, handle: SessionHandle):
        pool = self.engine.pool
        if (handle.pool_dtype != pool.cfg.dtype
                or handle.page_size != pool.cfg.page_size):
            raise ValueError(
                f"thaw: snapshot was frozen on a {handle.pool_dtype!r}/"
                f"page={handle.page_size} pool; this engine runs "
                f"{pool.cfg.dtype!r}/page={pool.cfg.page_size}: resume "
                "requires an identically configured pool")
        return pool

    def _admit_slot(self, req: Request, n_tokens: int) -> int:
        """Put ``req`` in a free slot with pages for ``n_tokens``."""
        eng = self.engine
        slot = eng._free_slot()
        if slot < 0:
            raise RuntimeError("thaw: no free decode slot")
        pages = eng.pool.alloc(req.req_id, n_tokens)
        if pages is None:
            raise RuntimeError("thaw: paged pool cannot hold the session")
        req.slot = slot
        eng.running[slot] = req
        eng._set_page_row(slot, pages)
        return slot

    def _restore_rng(self, req: Request, handle: SessionHandle) -> None:
        if handle.rng_state is not None:
            rng = np.random.default_rng(handle.seed)
            rng.bit_generator.state = handle.rng_state
            self.engine._rngs[req.req_id] = rng

    def thaw(self, handle: SessionHandle,
             suffix_tokens: Optional[List[int]] = None, *,
             max_new_tokens: Optional[int] = None) -> Request:
        """Resume a frozen session in this engine.

        With no suffix the request decodes on where it froze: its output
        restarts at ``[next_token]``, which the first decode step feeds at
        position ``n_ctx``.  With ``suffix_tokens`` (the next user turn),
        ``next_token`` and the suffix are prefilled at positions ``n_ctx
        ..`` and the answer starts after them: one prefill of the suffix
        alone, never of the whole history."""
        self._require_paged()
        eng = self.engine
        pool = self._check_pool(handle)
        snap = self._fetch_snapshot(handle)
        self._salts.setdefault(handle.session_id, handle.cache_salt)
        # a host that thaws a session it did not freeze keeps its handle
        self.handles.setdefault(handle.session_id, handle)

        suffix = list(suffix_tokens or [])
        eff = [handle.next_token] + suffix
        total = handle.n_ctx + len(eff) if suffix else handle.n_ctx
        if not total + 1 < eng.cfg.max_seq_len:
            raise ValueError("thawed session exceeds the slot's kv region")

        budget = (max_new_tokens if max_new_tokens is not None
                  else handle.remaining_tokens)
        prompt = Prompt([text_segment(eff)] if suffix else [],
                        user_id=handle.user_id)
        req = Request(prompt=prompt, max_new_tokens=budget,
                      seed=handle.seed, session_id=handle.session_id)
        # unique across processes: a host that thaws restarts no counter
        req.req_id = f"{handle.session_id}:thaw:{os.urandom(4).hex()}"
        self._admit_slot(req, total + 1)
        pool.adopt_session(eng._page_tables[req.slot], snap)
        self._restore_rng(req, handle)

        req.t_admitted = time.perf_counter()
        if suffix:
            link = session_suffix_link(eff, handle.n_ctx,
                                       eng.model.cfg.d_model)
            logits = eng._prefiller.prefill(eng.params, link,
                                            eng._page_tables[req.slot])
            req.output_tokens = [eng._select_token(req, logits)]
            req.cur_len = total
            req.prefill_stats = {"thawed": True, "n_reused": link.n_reused,
                                 "n_recomputed": link.n_recomputed}
        else:
            req.output_tokens = [handle.next_token]
            req.cur_len = handle.n_ctx
            req.prefill_stats = {"thawed": True, "n_reused": handle.n_ctx,
                                 "n_recomputed": 0}
        req.state = State.RUNNING
        req.t_first_token = time.perf_counter()
        self._lib.note_session(thaws=1)
        return req

    # -- fork --------------------------------------------------------------
    def fork(self, handle: SessionHandle, n: int, *,
             max_new_tokens: Optional[int] = None) -> List[Request]:
        """Thaw one snapshot into ``n`` children that share its pages.  The
        snapshot is adopted once, under a temporary owner; each child
        becomes a co-owner and the temporary hold is dropped, so the fork
        allocates no page beyond the one footprint.  Child ``i`` samples
        with seed ``handle.seed + i``."""
        self._require_paged()
        if n < 1:
            raise ValueError("fork: need n >= 1 children")
        eng = self.engine
        pool = self._check_pool(handle)
        free_slots = sum(1 for r in eng.running if r is None)
        if free_slots < n:
            raise RuntimeError(
                f"fork: {n} children need {n} free slots, have {free_slots}")
        snap = self._fetch_snapshot(handle)

        tmp = f"__fork__::{handle.session_id}::{os.urandom(3).hex()}"
        pages = pool.alloc(tmp, handle.n_ctx + 1)
        if pages is None:
            raise RuntimeError("fork: paged pool cannot hold the session")
        pool.adopt_session(pages, snap)

        budget = (max_new_tokens if max_new_tokens is not None
                  else handle.remaining_tokens)
        children: List[Request] = []
        for i in range(n):
            sid = f"{handle.session_id}.{i}"
            req = Request(prompt=Prompt([], user_id=handle.user_id),
                          max_new_tokens=budget, seed=handle.seed + i,
                          session_id=sid)
            req.req_id = f"{sid}:fork:{os.urandom(4).hex()}"
            children.append(req)
        pool.fork(tmp, [r.req_id for r in children])
        pool.free(tmp)          # the children keep the pages (ref = n)

        now = time.perf_counter()
        for req in children:
            slot = eng._free_slot()
            req.slot = slot
            eng.running[slot] = req
            eng._set_page_row(slot, np.asarray(pool._owned[req.req_id],
                                               np.int32))
            req.output_tokens = [handle.next_token]
            req.cur_len = handle.n_ctx
            req.state = State.RUNNING
            req.t_admitted = req.t_first_token = now
            req.prefill_stats = {"forked_from": handle.session_id,
                                 "n_reused": handle.n_ctx}
        self._lib.note_session(forks=n)
        return children

    # -- idle eviction -----------------------------------------------------
    def sweep_idle(self, max_idle_s: float) -> int:
        """Spool the snapshots frozen longer than ``max_idle_s`` ago
        (``EngineConfig.freeze_idle_s``, run every engine step); a thaw of
        one reads its spool file (or a peer) back.  Returns how many were
        spooled by this call.  Under a mesh rank 0's clock picks them (a
        broadcast whenever a handle is not spooled yet, which every rank
        knows alike)."""
        now = time.time()
        demoted = 0
        waiting = [sid for sid in self.handles if sid not in self._spooled]
        if not waiting:
            return 0
        idle = agree(self.engine.mesh, [
            sid for sid in waiting
            if now - self.handles[sid].frozen_at > max_idle_s])
        for sid in idle:
            h = self.handles[sid]
            if self._lib.spool_now(h.user_id, h.media_id):
                self._spooled.add(sid)
                demoted += 1
        return demoted

    def stats(self) -> dict:
        """The handle census (the event counts live in the library)."""
        return {"frozen_handles": len(self.handles),
                "spooled_handles": len(self._spooled)}
