"""Bucketed paged selective prefill, the MPIC hot path (port of the JAX
package's ``core/paged_prefill.py``).

:class:`PagedPrefiller` runs one request's prefill against the pool: the
selected tokens pad to a power-of-two shape bucket (``bucket(n,
PREFILL_BUCKET_MIN)``; pad rows write their K/V to the scratch page and their
logits are never read), the page table is cut to the bucketed live page
count, and the model's selective prefill writes every layer's new K/V into
the pool in place.  The JAX version runs the step as one donated jit and
the buckets bound its retraces; here they are the shape keys a later
CUDA-graph cache will use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.linker import (
    PagedLinkResult,
    bucket,
    link_paged,
    reselect_paged,
)
from repro_torch.core.segments import Prompt

PREFILL_BUCKET_MIN = 16         # smallest selection shape bucket


class PagedPrefiller:
    """Runs the paged selective prefill for one engine's pool."""

    def __init__(self, model, pool, scratch_page: int):
        self.model = model
        self.pool = pool
        self.scratch_page = int(scratch_page)

    def prefill(self, params, link: PagedLinkResult,
                page_row: np.ndarray) -> np.ndarray:
        """Selective prefill of one linked request.  Returns the logits row
        of the last real selected token (the first output token's logits)
        as float32 numpy."""
        pool = self.pool
        ps = pool.cfg.page_size
        page_row = np.asarray(page_row)
        n = len(link.sel_idx)
        sb = bucket(n, PREFILL_BUCKET_MIN)

        positions = np.zeros((sb,), np.int32)
        positions[:n] = link.sel_idx
        tokens = np.zeros((sb,), np.int32)
        tokens[:n] = link.sel_tokens
        emb = np.zeros((sb, self.model.cfg.d_model), np.float32)
        emb[:n] = link.sel_media_embeds
        mask = np.zeros((sb,), bool)
        mask[:n] = link.sel_media_mask
        wp = np.full((sb,), self.scratch_page, np.int32)
        wo = np.full((sb,), ps - 1, np.int32)
        wp[:n] = page_row[link.sel_idx // ps]
        wo[:n] = link.sel_idx % ps
        mp = min(bucket(pool.pages_for(link.total)), len(page_row))

        dev = pool.device

        def t(a):
            return torch.as_tensor(a[None], device=dev)

        logits = self.model.selective_prefill_paged(
            params, t(tokens), t(positions), pool.k, pool.v,
            t(np.ascontiguousarray(page_row[:mp])),
            torch.tensor([link.total], dtype=torch.int32, device=dev),
            t(wp), t(wo), pool.k_scale, pool.v_scale,
            media_embeds=t(emb), media_mask=t(mask))
        return logits[0, max(n - 1, 0)].float().cpu().numpy()

    def bind(self, page_row: np.ndarray) -> "BoundPagedPrefill":
        return BoundPagedPrefill(self, np.asarray(page_row))


@dataclasses.dataclass
class BoundPagedPrefill:
    """Per-request view handed to the policies: the prefiller plus the
    slot's (scratch-padded) page-table row."""
    prefiller: PagedPrefiller
    page_row: np.ndarray

    @property
    def pool(self):
        return self.prefiller.pool

    def link(self, model, prompt: Prompt, library, selection: np.ndarray,
             *, entries=None, sharding=None) -> PagedLinkResult:
        return link_paged(model, prompt, library, selection,
                          self.prefiller.pool, self.page_row,
                          scratch_page=self.prefiller.scratch_page,
                          entries=entries, sharding=sharding)

    def reselect(self, model, prompt: Prompt, link: PagedLinkResult,
                 selection: np.ndarray) -> PagedLinkResult:
        return reselect_paged(model, prompt, link, selection)

    def gather_k0(self, n_tokens: int) -> torch.Tensor:
        """Layer-0 cached K of the first ``n_tokens`` slots, (n, Hkv, Dh),
        a fresh tensor (cacheblend's deviation probe reads the pool where
        the dense path reads its blended cache).  An int8 pool gives the
        fp32 view dequantized by each slot's page scale."""
        pool = self.pool
        ps = pool.cfg.page_size
        slots = np.arange(n_tokens)
        pages = torch.as_tensor(self.page_row[slots // ps], dtype=torch.long,
                                device=pool.device)
        offs = torch.as_tensor(slots % ps, dtype=torch.long,
                               device=pool.device)
        k0 = pool.k[0][pages, offs]
        if pool.quantized:
            k0 = k0.float() * pool.k_scale[0][pages][..., None]
        return k0

    def prefill(self, params, link: PagedLinkResult) -> np.ndarray:
        return self.prefiller.prefill(params, link, self.page_row)
