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
