"""Paged KV pool (port of the JAX package's ``cache/paged.py``).

A fixed pool of pages per layer, ``(L, num_pages, page_size, Hkv, Dh)``.
Requests own page lists through a page table; pages carry refcounts, so a
page returns to the free stack only when its last owner frees it.

The JAX pool updates its buffers through donated jits and reassigns them;
this pool writes into its tensors in place (``link_write``, ``write_tokens``,
and the per-layer writes of the decode and prefill steps), so serving never
copies the pool.

Int8 residency (``dtype="int8"``): pages hold int8 with one running fp32
scale per ``(layer, page, kv_head)`` in ``k_scale``/``v_scale`` (see
:mod:`repro_torch.cache.pagequant`); the attention kernels dequantize from
those scales in registers.

Sessions (``serving/sessions.py``): :meth:`PagedKVPool.fork` makes children
co-owners of a parent's pages (refcounts, no copy), and
:meth:`PagedKVPool.make_exclusive` duplicates a still-shared page before a
write lands in it (copy-on-write; ``cow_copies`` and ``pages_shared`` count
both).  :meth:`PagedKVPool.export_session` snapshots a request's live KV
and :meth:`PagedKVPool.adopt_session` writes a snapshot back into pages,
on an int8 pool as raw page bytes plus scale rows, so the restore is bit
for bit.  Every page copy is one gather of all its sources followed by the
writes, so a batch of copies does not depend on its order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache.pagequant import quant_scatter
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.layers import rope_relink


@dataclasses.dataclass
class PagedConfig:
    num_pages: int
    page_size: int
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page costs: K and V payload, plus the page's
        scale rows on an int8 pool."""
        itemsize = {"int8": 1, "bfloat16": 2, "float16": 2}.get(self.dtype, 4)
        n = 2 * self.num_layers * self.page_size * self.num_kv_heads \
            * self.head_dim * itemsize
        if self.quantized:
            n += 2 * self.num_layers * self.num_kv_heads * 4
        return n


class PagedKVPool:
    def __init__(self, cfg: PagedConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantized = cfg.quantized
        dt = torch.int8 if self.quantized else torch_dtype(cfg.dtype)
        shape = (cfg.num_layers, cfg.num_pages, cfg.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # 0 means "not written since (re)allocation"
        self.k_scale = self.v_scale = None
        if self.quantized:
            sshape = (cfg.num_layers, cfg.num_pages, cfg.num_kv_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
        self._free: List[int] = list(range(cfg.num_pages - 1, -1, -1))
        self._owned: Dict[str, List[int]] = {}
        # a page's refcount is the number of owner lists it is on
        self._refs: Dict[int, int] = {}
        # cumulative: pages duplicated by copy-on-write, and page references
        # handed to fork children
        self.cow_copies = 0
        self.pages_shared = 0

    # -- allocation --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def owned_pages(self, req_id: str) -> int:
        return len(self._owned.get(req_id, []))

    def capacity(self, req_id: str) -> int:
        """Tokens the request's current page list can hold."""
        return self.owned_pages(req_id) * self.cfg.page_size

    def page_ref(self, page: int) -> int:
        """Current refcount of one page (0 == free / unknown)."""
        return self._refs.get(page, 0)

    def alloc(self, req_id: str, n_tokens: int) -> Optional[np.ndarray]:
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._refs[p] = 1
        self._owned.setdefault(req_id, []).extend(pages)
        return np.asarray(self._owned[req_id], np.int32)

    def extend(self, req_id: str, n_more_tokens: int, cur_tokens: int
               ) -> Optional[np.ndarray]:
        have = self.owned_pages(req_id)
        need = self.pages_for(cur_tokens + n_more_tokens) - have
        if need > len(self._free):
            return None
        for _ in range(max(need, 0)):
            p = self._free.pop()
            self._refs[p] = 1
            self._owned.setdefault(req_id, []).append(p)
        return np.asarray(self._owned[req_id], np.int32)

    def free(self, req_id: str) -> None:
        """Drop a request's hold on its pages.  Idempotent.  A page shared
        with another owner only loses one reference.  On an int8 pool the
        released pages' scale rows are zeroed, so the next tenant's running
        amax starts fresh."""
        pages = self._owned.pop(req_id, [])
        released = []
        for p in pages:
            r = self._refs.get(p, 1) - 1
            if r <= 0:
                self._refs.pop(p, None)
                released.append(p)
            else:
                self._refs[p] = r
        self._free.extend(released)
        if released and self.quantized:
            idx = torch.as_tensor(released, dtype=torch.long,
                                  device=self.device)
            self.k_scale[:, idx] = 0.0
            self.v_scale[:, idx] = 0.0

    # -- session fork / copy-on-write --------------------------------------
    def fork(self, parent_req: str, child_reqs: List[str]) -> None:
        """Make every child a co-owner of the parent's page list: no page
        moves and no byte is copied, each page's refcount goes up by one a
        child.  A child's first write into a still-shared page goes through
        :meth:`make_exclusive`.  Children must not own pages yet."""
        pages = self._owned.get(parent_req)
        if pages is None:
            raise KeyError(f"fork: unknown parent request {parent_req!r}")
        for child in child_reqs:
            if child in self._owned:
                raise ValueError(f"fork: child {child!r} already owns pages")
            self._owned[child] = list(pages)
            for p in pages:
                self._refs[p] = self._refs.get(p, 0) + 1
        self.pages_shared += len(pages) * len(child_reqs)

    def make_exclusive(self, req_id: str, first_token: int,
                       n_tokens: int = 1) -> Optional[np.ndarray]:
        """Make the pages covering ``[first_token, first_token + n_tokens)``
        this request's alone before a write lands in them: each shared page
        (refcount > 1) is copied, page bytes and, on an int8 pool, its scale
        rows, to a free page that replaces it in this request's list; the
        other owners keep the original.  Returns the request's page array,
        or None when the pool has too few free pages (the caller treats it
        as a failed ``extend``)."""
        pages = self._owned.get(req_id)
        if pages is None:
            return None
        ps = self.cfg.page_size
        lo = first_token // ps
        hi = min((first_token + max(n_tokens, 1) - 1) // ps, len(pages) - 1)
        shared = [i for i in range(lo, hi + 1)
                  if self._refs.get(pages[i], 1) > 1]
        if not shared:
            return np.asarray(pages, np.int32)
        if len(shared) > len(self._free):
            return None
        src, dst = [], []
        for i in shared:
            old, new = pages[i], self._free.pop()
            src.append(old)
            dst.append(new)
            self._refs[old] -= 1
            self._refs[new] = 1
            pages[i] = new
        self._copy_pages(src, dst)
        self.cow_copies += len(src)
        return np.asarray(pages, np.int32)

    def _copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Whole-page copies ``src[i] -> dst[i]`` in every layer.  Indexing
        by a list gathers into new tensors, so every source is read before
        any destination is written."""
        s = torch.as_tensor(src, dtype=torch.long, device=self.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=self.device)
        bufs = [self.k, self.v]
        if self.quantized:
            bufs += [self.k_scale, self.v_scale]
        for buf, rows in [(b, b[:, s]) for b in bufs]:
            buf[:, d] = rows

    # -- session freeze / thaw ---------------------------------------------
    def export_session(self, page_table: np.ndarray,
                       n_tokens: int) -> Dict[str, torch.Tensor]:
        """A snapshot of a request's live KV, on the pool's device.

        A 16-bit (or fp32) pool gives ``{"k", "v"}`` (L, n_tokens, Hkv, Dh)
        in the pool's dtype, cut at ``n_tokens``: bytes past the live
        length may be a previous tenant's and never leave the pool.  An int8
        pool gives the raw page bytes ``{"qk", "qv"}`` (L, npages * ps, Hkv,
        Dh) with the tail past ``n_tokens`` zeroed, and the pages' scale
        rows ``{"k_scale", "v_scale"}`` (L, npages, Hkv): adopting them
        back restores the pool bit for bit, with no dequantize/requantize
        round trip."""
        ps = self.cfg.page_size
        npages = self.pages_for(n_tokens)
        rows = np.asarray(page_table)[:npages]
        pages = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        if not self.quantized:
            slots = np.arange(n_tokens)
            tok_pages = torch.as_tensor(rows[slots // ps], dtype=torch.long,
                                        device=self.device)
            offs = torch.as_tensor(slots % ps, dtype=torch.long,
                                   device=self.device)
            return {"k": self.k[:, tok_pages, offs],
                    "v": self.v[:, tok_pages, offs]}
        snap = {}
        for name, buf in (("qk", self.k), ("qv", self.v)):
            q = buf[:, pages].flatten(1, 2)
            q[:, n_tokens:] = 0
            snap[name] = q
        snap["k_scale"] = self.k_scale[:, pages]
        snap["v_scale"] = self.v_scale[:, pages]
        return snap

    def adopt_session(self, page_table: np.ndarray,
                      snap: Dict[str, torch.Tensor]) -> None:
        """Write an :meth:`export_session` snapshot into the first pages of
        ``page_table``, whole pages: a 16-bit snapshot's last page gets
        zeros past its tokens; an int8 snapshot restores its raw bytes and
        scale rows as they were frozen.  The JAX pool pads the page count
        to a power of two onto its scratch page, to bound its retraces; an
        in-place write needs no padding."""
        ps = self.cfg.page_size
        dev = self.device
        if self.quantized:
            npages = snap["qk"].shape[1] // ps
            pages = torch.as_tensor(np.asarray(page_table)[:npages],
                                    dtype=torch.long, device=dev)
            for buf, name in ((self.k, "qk"), (self.v, "qv")):
                q = snap[name].to(dev)
                buf[:, pages] = q.reshape(q.shape[0], npages, ps,
                                          *q.shape[2:])
            self.k_scale[:, pages] = snap["k_scale"].to(dev, torch.float32)
            self.v_scale[:, pages] = snap["v_scale"].to(dev, torch.float32)
            return
        n_tokens = snap["k"].shape[1]
        npages = self.pages_for(n_tokens)
        pages = torch.as_tensor(np.asarray(page_table)[:npages],
                                dtype=torch.long, device=dev)
        for buf, name in ((self.k, "k"), (self.v, "v")):
            t = snap[name].to(dev, buf.dtype)
            whole = t.new_zeros((t.shape[0], npages * ps, *t.shape[2:]))
            whole[:, :n_tokens] = t
            buf[:, pages] = whole.reshape(t.shape[0], npages, ps,
                                          *t.shape[2:])

    # -- data movement -----------------------------------------------------
    def link_write(self, pages, offs, k_seg, v_seg, delta, *, theta: float,
                   relink: bool) -> None:
        """RoPE-relink one placed run of stored K (``delta`` positions per
        token) and write it with its V into the pool at ``pages``/``offs``
        (quantizing on an int8 pool).  ``k_seg``/``v_seg`` (L, S, H, Dh)."""
        if relink:
            k_seg = rope_relink(k_seg, delta, theta)
        if self.quantized:
            quant_scatter(self.k, self.v, self.k_scale, self.v_scale, pages,
                          offs, k_seg, v_seg)
        else:
            pages, offs = pages.long(), offs.long()
            self.k[:, pages, offs] = k_seg.to(self.k.dtype)
            self.v[:, pages, offs] = v_seg.to(self.v.dtype)

    def link_write_q8(self, pages, offs, qk_seg, qk_scale, qv_seg, qv_scale,
                      seg_ids, delta, *, theta: float, relink: bool) -> None:
        """The spool-to-pool link: place int8 segments from the library
        (``qk_seg``/``qv_seg`` (L, S, H, Dh) int8 with their spool scales
        ``qk_scale``/``qv_scale`` (L, rows, H, Dh) fp32; ``seg_ids`` (S,)
        maps each token to its scale row) onto the page grid, in place:
        dequantized in fp32, K RoPE-relinked by ``delta``, then quantized
        at the pages' running scales.  An int8 pool only."""
        if not self.quantized:
            raise ValueError("link_write_q8 requires an int8 pool")
        rows = seg_ids.long()
        k_seg = qk_seg.float() * qk_scale[:, rows]
        v_seg = qv_seg.float() * qv_scale[:, rows]
        if relink:
            k_seg = rope_relink(k_seg, delta, theta)
        quant_scatter(self.k, self.v, self.k_scale, self.v_scale, pages, offs,
                      k_seg, v_seg)

    def write_tokens(self, page_table: np.ndarray, slot0: int,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Write (L, S, H, Dh) tokens into the pool starting at ``slot0``."""
        s = k_new.shape[1]
        ps = self.cfg.page_size
        slots = slot0 + np.arange(s)
        pages = torch.as_tensor(np.asarray(page_table)[slots // ps],
                                dtype=torch.long, device=self.device)
        offs = torch.as_tensor(slots % ps, dtype=torch.long,
                               device=self.device)
        if self.quantized:
            quant_scatter(self.k, self.v, self.k_scale, self.v_scale, pages,
                          offs, k_new, v_new)
        else:
            self.k[:, pages, offs] = k_new.to(self.k.dtype)
            self.v[:, pages, offs] = v_new.to(self.v.dtype)
