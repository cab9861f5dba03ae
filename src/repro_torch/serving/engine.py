"""MPIC serving engine, paged path (port of the JAX package's
``serving/engine.py``).

The paper's request flow, with continuous batching over fixed slots:

  1. ``upload``   user file -> ``precompute_media_kv`` -> static library
                  (``dynamic=True``: the shared MRAG library + retriever)
  2. ``submit``   a query with media references joins the waiting queue
  3. admission    one request per step into a free slot: its pages are
                  reserved (the pool gives every slot its whole
                  ``max_seq_len`` region, so a free slot always has room),
                  the policy (``mpic``) links the stored media KV
                  into them (``link_paged``) and runs the selective prefill
                  (``PagedPrefiller``), which gives the first token
  4. MRAG         retrieved dynamic-library KV is relinked after the prompt
  5. decode       every step advances all running slots by one token with
                  one paged decode step over the pool

The KV pool is a :class:`~repro_torch.cache.paged.PagedKVPool`, bf16 (the
model's compute dtype) or int8 (``EngineConfig.pool_dtype="int8"``), written
in place.  On the card, attention runs in the port's CUDA kernels.

Not ported yet: the pipelined scheduler and its loader, chunked prefill,
the dense fallback cache, sessions, deadlines and faults, sampling other
than greedy, and mesh sharding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.cache.library import KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.core.linker import bucket, precompute_media_kv
from repro_torch.core.paged_prefill import PagedPrefiller
from repro_torch.core.policies import POLICIES, PolicyResult
from repro_torch.device import resolve_device
from repro_torch.serving.request import Request, State
from repro_torch.serving.retriever import Retriever
from repro_torch.serving.scheduler import WaitingQueue


@dataclasses.dataclass
class EngineConfig:
    max_seq_len: int = 512          # kv region per slot
    decode_slots: int = 4           # continuous-batching capacity
    page_size: int = 16             # tokens per KV page
    pool_dtype: str = ""            # "" -> model compute dtype; "int8"


class MPICEngine:
    def __init__(self, model, params, engine_cfg: Optional[EngineConfig] = None,
                 *, static_library: Optional[KVLibrary] = None,
                 dynamic_library: Optional[KVLibrary] = None,
                 retriever: Optional[Retriever] = None, device=None):
        """``device`` None means the card, and raises without one; pass
        ``"cpu"`` to serve with the kernels' plain versions.  ``params``
        must already live on that device."""
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.cfg = engine_cfg or EngineConfig()
        if self.cfg.pool_dtype not in ("", "int8"):
            raise ValueError(f"pool_dtype {self.cfg.pool_dtype!r}: "
                             "use '' (compute dtype) or 'int8'")
        self.static_lib = static_library or KVLibrary()
        self.dynamic_lib = dynamic_library or KVLibrary(shared=True)
        self.retriever = retriever if retriever is not None else Retriever()
        self.queue = WaitingQueue()
        self.running: List[Optional[Request]] = [None] * self.cfg.decode_slots
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.decode_step_s: List[float] = []    # wall time of each decode step

        mcfg = model.cfg
        ps = self.cfg.page_size
        self._pages_per_slot = -(-self.cfg.max_seq_len // ps)
        # every slot's whole region, plus the scratch page
        self.pool = PagedKVPool(PagedConfig(
            num_pages=self.cfg.decode_slots * self._pages_per_slot + 1,
            page_size=ps, num_layers=mcfg.num_layers,
            num_kv_heads=mcfg.num_kv_heads, head_dim=mcfg.head_dim,
            dtype=self.cfg.pool_dtype or mcfg.compute_dtype),
            device=self.device)
        # scratch page: absorbs padding writes (idle slots, bucket pads) so
        # real pages are never aliased
        self._scratch_page = int(self.pool.alloc("__scratch__", 1)[0])
        self._page_tables = np.full(
            (self.cfg.decode_slots, self._pages_per_slot),
            self._scratch_page, np.int32)
        self._prefiller = PagedPrefiller(model, self.pool, self._scratch_page)

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
        self.queue.push(request)
        return request

    # ------------------------------------------------------------------
    # engine step: admit, then decode every running slot
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        self._admit()
        self._decode()

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
        """Admit at most one request per step (sequential admission)."""
        slot = self._free_slot()
        if self.queue and slot >= 0:
            self._begin_prefill(self.queue.pop(), slot)

    def _begin_prefill(self, req: Request, slot: int) -> None:
        req.t_admitted = time.perf_counter()
        policy = POLICIES.get(req.policy)
        if policy is None:
            # a bad policy name fails THAT request, the engine keeps serving
            req.state = State.FAILED
            req.error = (f"unknown policy {req.policy!r} "
                         f"(ported: {sorted(POLICIES)})")
            self.failed.append(req)
            return
        req.slot = slot
        req.state = State.PREFILLING
        self.running[slot] = req
        pages = self.pool.alloc(req.req_id, req.prompt.total_len + 1)
        self._set_page_row(slot, pages)
        try:
            result = policy(self.model, self.params, req.prompt,
                            self.static_lib,
                            paged=self._prefiller.bind(self._page_tables[slot]),
                            **req.policy_kwargs)
            self._finalize_prefill(req, result)
        except BaseException as exc:
            # free the slot and its pages, then let the caller see the error
            req.state = State.FAILED
            req.error = repr(exc)
            self.failed.append(req)
            self._release(req)
            raise

    def _finalize_prefill(self, req: Request, result: PolicyResult) -> None:
        req.prefill_stats = result.stats
        req.linked_media = [seg.media_id
                            for _, seg in req.prompt.media_segments()]
        req.output_tokens.append(int(np.argmax(result.first_logits)))
        req.t_first_token = time.perf_counter()
        req.cur_len = req.prompt.total_len
        req.state = State.RUNNING
        # workflow 4: MRAG, link retrieved KV position-independently with no
        # recompute of the existing cache
        if req.retrieval_query is not None:
            self._mrag_link(req)

    def _set_page_row(self, slot: int, pages: np.ndarray) -> None:
        row = np.full((self._pages_per_slot,), self._scratch_page, np.int32)
        row[:len(pages)] = pages
        self._page_tables[slot] = row

    def _mrag_link(self, req: Request) -> None:
        hits = self.retriever.query(req.retrieval_query, req.retrieval_top_k)
        cfg = self.model.cfg
        ps = self.cfg.page_size
        for media_id, _score in hits:
            entry = self.dynamic_lib.get(req.prompt.user_id, media_id)
            if entry is None:
                continue
            length = entry.k.shape[1]
            off = req.cur_len
            if off + length + 1 >= self.cfg.max_seq_len:
                break
            pages = self.pool.extend(req.req_id, length, off)
            if pages is None:           # pool full: stop linking
                break
            self._set_page_row(req.slot, pages)
            t = off + np.arange(length)
            dev = self.device
            self.pool.link_write(
                torch.as_tensor(self._page_tables[req.slot][t // ps],
                                device=dev),
                torch.as_tensor((t % ps).astype(np.int32), device=dev),
                entry.k, entry.v,
                torch.full((length,), off, dtype=torch.int32, device=dev),
                theta=cfg.rope_theta, relink=bool(cfg.rope_theta))
            req.cur_len += length
            req.linked_media.append(media_id)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _decode(self) -> None:
        live = [r for r in self.running
                if r is not None and r.state is State.RUNNING]
        if not live:
            return
        live, logits = self._decode_paged_step(live)
        for r in live:
            r.output_tokens.append(int(np.argmax(logits[r.slot])))
            r.cur_len += 1
            if len(r.output_tokens) >= r.max_new_tokens or \
                    r.cur_len + 1 >= self.cfg.max_seq_len:
                self._finish(r)

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
        logits = self.model.decode_step_paged(
            self.params, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev), pool.k, pool.v,
            torch.as_tensor(np.ascontiguousarray(self._page_tables[:, :mp]),
                            device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(wp, device=dev), torch.as_tensor(wo, device=dev),
            pool.k_scale, pool.v_scale)
        logits = logits.float().cpu().numpy()
        self.decode_step_s.append(time.perf_counter() - t0)
        return live, logits

    def _release(self, r: Request) -> None:
        self.running[r.slot] = None
        self.pool.free(r.req_id)
        self._page_tables[r.slot] = self._scratch_page
        r.slot = -1

    def _finish(self, r: Request) -> None:
        r.state = State.DONE
        r.t_done = time.perf_counter()
        self.finished.append(r)
        self._release(r)

    # ------------------------------------------------------------------
    def report(self) -> dict:
        done = self.finished
        if not done:
            return {}
        ttfts = [r.ttft for r in done]
        steps = self.decode_step_s
        return {
            "requests": len(done),
            "failed": len(self.failed),
            "mean_ttft_s": float(np.mean(ttfts)),
            "p90_ttft_s": float(np.percentile(ttfts, 90)),
            "mean_prefill_s": float(np.mean(
                [r.t_first_token - r.t_admitted for r in done])),
            "decode_steps": len(steps),
            "mean_decode_step_s": float(np.mean(steps)) if steps else 0.0,
            "total_tokens": sum(len(r.output_tokens) for r in done),
            "library": self.static_lib.stats(),
        }
